// Pieces shared by the port's bf16/f16 attention kernels (the forward in
// flash_attn_fwd.cu, the one-pass backward in flash_attn_bwd.cu): the
// inline-PTX wrapper of mma.sync.m16n8k16 (bf16 or f16 operands, f32
// accumulators; the backward's products) and of cp.async; the packing of
// two f32 values into a 16-bit pair; the accumulator-to-operand repack;
// the max and sum across a quad; and the key rules (ragged end, causal,
// boolean mask).
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// which a warp's 16 rows of wgmma's m64nNk16 accumulator and A operand
// share: lane = 4 g + t. An f32 accumulator tile (16 x 8) holds rows g and
// g + 8, columns 2t and 2t + 1. An A operand (16 x 16) holds rows g, g + 8
// and columns 2t, 2t + 1, 2t + 8, 2t + 9, so the accumulators of two
// adjacent 8-column tiles repack into one A operand in registers
// (to_a_frags).
//
// ops/cuda_build.py hashes every csrc/*.cuh into each library's name.

#pragma once

#include "flash_attn_common.cuh"

namespace vivqa {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

  // the key's state when the mask keeps it (mask_keeps) or not
  __device__ __forceinline__ KeyState state(int qi, int kj, bool mask_keeps) const {
    if (kj >= Lk) return kPastEnd;
    return mask_keeps && (!causal || q_offset + qi >= kj) ? kKept : kRemoved;
  }
  // reading the mask byte from device memory, only for a key that exists:
  // a key past Lk would read past the mask row (past the tensor at its
  // last row, which faulted where the allocation ended there)
  __device__ __forceinline__ KeyState operator()(int qi, int kj) const {
    return state(qi, kj,
                 mask == nullptr || qi >= Lq || kj >= Lk || __ldg(mask + qi * sq + kj * sk) != 0);
  }
};

// 1 when a (b, q, k)-strided byte mask at ptr takes 16-byte copies
inline int mask_rows_aligned16(const void* ptr, long long sb, long long sq, long long sk) {
  return ptr != nullptr && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 16 == 0 &&
         sq % 16 == 0 && sk == 1;
}

}  // namespace mma
}  // namespace vivqa
