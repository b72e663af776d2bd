// Tensor-core pieces shared by the port's bf16/f16 attention kernels (the
// training forward in flash_attn_fwd.cu, the dQ pass in
// flash_attn_bwd_dq.cu): inline-PTX wrappers for ldmatrix,
// mma.sync.m16n8k16 (bf16 or f16 operands, f32 accumulators) and
// cp.async; the 64-row tile loader into padded shared memory; the two
// warp-level products over a tile of keys (or a step of 16 or 32 keys of
// it); the accumulator-to-operand repack; the key rules (ragged end,
// causal, boolean mask) and the causal skip; and the epilogue that writes
// a warp's 16 rows with 16-byte stores.
//
// Shapes: a block of 4 warps owns 64 query rows, 16 per warp; keys come in
// tiles of 64. A tile of rows is staged in its own dtype with a row pitch
// of D + 8 elements, so the 8 row addresses of one ldmatrix fall 16 bytes
// apart along the banks and never conflict.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"):
// lane = 4 g + t. An f32 accumulator tile (16 x 8) holds rows g and g + 8,
// columns 2t and 2t + 1. An A operand (16 x 16) holds rows g, g + 8 and
// columns 2t, 2t + 1, 2t + 8, 2t + 9, so the accumulators of two adjacent
// 8-column tiles repack into one A operand in registers (to_a_frags).
//
// ops/cuda_build.py hashes every csrc/*.cuh into each library's name.

#pragma once

#include "flash_attn_common.cuh"

namespace vivqa {
namespace mma {

constexpr int kTileRows = 64;  // query rows per block, keys per tile
constexpr int kWarps = 4;      // 16 query rows each
constexpr int kThreads = kWarps * 32;

template <int D> __host__ __device__ constexpr int pitch() { return D + 8; }
template <int D> __host__ __device__ constexpr int tile_elems() {
  return kTileRows * pitch<D>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b on the tensor cores, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to T and packed, lo in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [row0, row0 + 64) of an (n_rows, D) matrix with row stride ld
// into dst (pitch D + 8) in its own dtype; rows at or past n_rows are 0.
// vec: 16-byte cp.async copies, which the caller commits and waits for;
// else element loads (rows that do not start on 16 bytes).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld, int row0,
                                          int n_rows, int vec) {
  static_assert(sizeof(T) == 2, "tensor-core tiles are 16-bit");
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kPerThread = kTileRows * kChunks / kThreads;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    T* d = dst + r * pitch<D>() + c;
    if (row0 + r < n_rows) {
      const T* s = src + (row0 + r) * ld + c;
      if (vec) {
        cp_async16(d, s);
      } else {
        uint4 buf;
        T* e = reinterpret_cast<T*>(&buf);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = s[j];
        *reinterpret_cast<uint4*>(d) = buf;
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc[j] += A . B^T for a warp's 16 rows of sA against the first 8 NT
// rows of sB, over D: S = Q K^T, dP = dO V^T. acc[j] covers columns
// 8j .. 8j + 7. The forward and the dQ pass compute S through this one
// function, so they get the same f32 scores bit for bit.
template <typename T, int D, int NT>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4], const T* sA, const T* sB,
                                         int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma16816<T>(acc[2 * np], a, b[0], b[1]);
      mma16816<T>(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += A . B for A = a warp's 16 x 16 KC operand (KC chunks of 16
// keys, from to_a_frags) and B = the first 16 KC rows of sB by D columns:
// O += P V, dQ += dS K. acc[n] covers columns 8n .. 8n + 7.
template <typename T, int D, int KC>
__device__ __forceinline__ void gemm_ab(float (&acc)[D / 8][4], const uint32_t (&a)[KC][4],
                                        const T* sB, int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + dp * 16 +
                               (lane >> 4) * 8);
      mma16816<T>(acc[2 * dp], a[kk], b[0], b[1]);
      mma16816<T>(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// The 16 x 8 NT f32 accumulators (NT tiles of 8 columns) rounded to T as
// the A operand of the next product, in registers.
template <typename T, int NT>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[NT / 2][4], const float (&s)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// max / sum over the 4 lanes of a quad, which together hold a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

enum KeyState { kKept = 0, kRemoved = 1, kPastEnd = 2 };

// Which keys a query row takes: keys past Lk do not exist (probability 0,
// not counted); the causal rule (diagonal at the end of the keys) and the
// boolean mask remove keys, which then score -1e30 and still count.
struct KeyRule {
  const uint8_t* mask;  // this batch row's mask, or nullptr
  long long sq, sk;     // its (q, k) element strides
  int Lq, Lk, q_offset, causal;

  __device__ __forceinline__ KeyState operator()(int qi, int kj) const {
    if (kj >= Lk) return kPastEnd;
    bool keep = !causal || q_offset + qi >= kj;
    if (mask != nullptr && qi < Lq) keep = keep && __ldg(mask + qi * sq + kj * sk) != 0;
    return keep ? kKept : kRemoved;
  }
};

// The end of the keys an item of 64 rows from q0 takes. Causal without a
// mask: keys past the item's last diagonal carry weight exactly 0 and are
// skipped -- unless its first row has no key (Lq > Lk), which must average
// over all Lk keys; such an item may also hold rows with keys, and the
// rule gives each row its own.
__device__ __forceinline__ int causal_key_end(const KeyRule& rule, int q0) {
  if (!rule.causal || rule.mask != nullptr || rule.q_offset + q0 < 0) return rule.Lk;
  return min(rule.Lk, rule.q_offset + min(q0 + kTileRows, rule.Lq));
}

// Write a warp's 16 x D accumulators, row g scaled by f0 and row g + 8 by
// f1, as T into the warp's own 16 rows of a staged tile (sW, pitch D + 8),
// then copy the rows below n_rows to dst rows row0 .. row0 + 15 (row
// stride ld): 16-byte stores when vec, else element stores.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* sW, const float (&acc)[D / 8][4], float f0,
                                           float f1, T* dst, long long ld, int row0,
                                           int n_rows, int lane, int vec) {
  constexpr int P = pitch<D>();
  constexpr int kChunks = D / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's reads of sW are done
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(sW + g * P + n * 8 + 2 * t) =
        pack2<T>(acc[n][0] * f0, acc[n][1] * f0);
    *reinterpret_cast<uint32_t*>(sW + (g + 8) * P + n * 8 + 2 * t) =
        pack2<T>(acc[n][2] * f1, acc[n][3] * f1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    if (row0 + r < n_rows) {
      const T* s = sW + r * P + c;
      T* d = dst + (row0 + r) * ld + c;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = s[j];
      }
    }
  }
}

// 1 when rows of a (b, h, l)-strided 16-bit operand at ptr all start on 16
// bytes, so they take 16-byte loads and stores
inline int rows_aligned16(const void* ptr, long long sb, long long sh, long long sl) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 &&
         sl % 8 == 0;
}

// Dynamic shared memory of a block: nbuf K/V tile pairs (two when the keys
// span more than one tile, so the next tile loads while this one is used)
// behind `fixed` staged row tiles.
template <typename T, int D>
inline int smem_bytes(int fixed, int Lk) {
  const int nbuf = Lk > kTileRows ? 2 : 1;
  return (fixed + 2 * nbuf) * tile_elems<D>() * static_cast<int>(sizeof(T));
}

}  // namespace mma
}  // namespace vivqa
