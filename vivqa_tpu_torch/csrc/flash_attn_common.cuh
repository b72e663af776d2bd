// Pieces shared by the port's attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd_dq.cu, flash_attn_bwd_dkv.cu): dtype conversions, the
// tile loader, the attention-dropout keep hash, and the parameters of the
// two backward kernels. ops/cuda_build.py hashes this header into every
// kernel library's name, so editing it rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vivqa {

constexpr float kMasked = -1e30f;  // NEG_INF of the JAX kernels
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// A ROWS x D tile of a (L, D) matrix with row stride ld, staged through
// registers: fetch() issues every global load of the tile at once (16-byte
// vectors when vec, else one element at a time), store() converts to f32
// into shared memory with row pitch PITCH. Rows at or past n_rows are 0.
template <typename T, int D, int ROWS, int THREADS>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int kVecPerRow = D / kVec;
  static constexpr int kVecs = ROWS * kVecPerRow;
  static constexpr int kPerThread = (kVecs + THREADS - 1) / THREADS;
  uint4 buf[kPerThread];

  __device__ __forceinline__ void fetch(const T* src, long long ld, int row0, int n_rows,
                                        int vec) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / kVecPerRow, c = (idx % kVecPerRow) * kVec;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < kVecs && row0 + r < n_rows) {
        const T* at = src + (row0 + r) * ld + c;
        if (vec) {
          buf[i] = __ldg(reinterpret_cast<const uint4*>(at));
        } else {
          T* e = reinterpret_cast<T*>(&buf[i]);
#pragma unroll
          for (int j = 0; j < kVec; ++j) e[j] = at[j];
        }
      }
    }
  }

  template <int PITCH>
  __device__ __forceinline__ void store(float* dst, float scale) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < kVecs) {
        const int r = idx / kVecPerRow, c = (idx % kVecPerRow) * kVec;
        const T* e = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) dst[r * PITCH + c + j] = to_f32(e[j]) * scale;
      }
    }
  }
};

// Attention-probability dropout, shared by every batch row and head as
// flax's broadcast_dropout: key (q, k) is kept iff
//   mix32(mix32(key ^ q) ^ k) >= threshold,
// a counter-based hash that the forward and both backward kernels
// regenerate, so nothing of size Lq x Lk is stored. The plain version in
// ops/flash_attention.py computes the same bits with torch integer ops.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {  // "lowbias32"
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  int on;              // 0: no dropout
  uint32_t threshold;  // floor(rate * 2^32)
  uint32_t key;        // per call, from ops/flash_attention.py:dropout_key
  float inv_keep;      // 1 / (1 - rate), in f32
  __device__ __forceinline__ uint32_t row(int qi) const {
    return mix32(key ^ static_cast<uint32_t>(qi));
  }
  // the multiplier z of key kj in the row whose hash is row_hash
  __device__ __forceinline__ float scale(uint32_t row_hash, int kj) const {
    return mix32(row_hash ^ static_cast<uint32_t>(kj)) >= threshold ? inv_keep : 0.f;
  }
};

// Parameters of both backward kernels. Element strides (b, h, l) for the
// (B, H, L, D) operands (unit stride over D), (b, q, k) for the mask.
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* m;  // (B*H, Lq) softmax stats of the forward
  const float* l;
  float* delta;    // (B*H, Lq) rowsum(dO * O): written by dq, read by dkv
  void* dq;
  void* dk;
  void* dv;
  const uint8_t* mask;  // nullptr = no mask
  int B, H, Lq, Lk;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  long long m_sb, m_sq, m_sk;
  int causal;
  int vec;  // 1: q, k, v, dO rows all start 16-byte aligned
  float scale;
  Dropout drop;
};

inline BwdParams make_bwd_params(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const float* m, const float* l,
                                 float* delta, void* dq, void* dk, void* dv, const void* mask,
                                 int B, int H, int Lq, int Lk, const long long* s, int causal,
                                 int vec, float scale, int dropout, unsigned threshold,
                                 unsigned key, float inv_keep) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.m = m;
  p.l = l;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.mask = static_cast<const uint8_t*>(mask);
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  long long* dst[27] = {&p.q_sb,  &p.q_sh,  &p.q_sl,  &p.k_sb,  &p.k_sh,  &p.k_sl,  &p.v_sb,
                        &p.v_sh,  &p.v_sl,  &p.o_sb,  &p.o_sh,  &p.o_sl,  &p.do_sb, &p.do_sh,
                        &p.do_sl, &p.dq_sb, &p.dq_sh, &p.dq_sl, &p.dk_sb, &p.dk_sh, &p.dk_sl,
                        &p.dv_sb, &p.dv_sh, &p.dv_sl, &p.m_sb,  &p.m_sq,  &p.m_sk};
  for (int i = 0; i < 27; ++i) *dst[i] = s[i];
  p.causal = causal;
  p.vec = vec;
  p.scale = scale;
  p.drop.on = dropout;
  p.drop.threshold = threshold;
  p.drop.key = key;
  p.drop.inv_keep = inv_keep;
  return p;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace vivqa
