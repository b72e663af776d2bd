// Attention backward, dK/dV pass, for Hopper (sm_90a), plain C interface:
// the f32 backward's second kernel (bf16 and f16 take the one-pass kernel
// of flash_attn_bwd.cu).
//
// Replaces, in f32, the Pallas TPU kernel vivqa_tpu/ops/flash_attention.py:
// _flash_bwd_dkv_kernel (launched by _flash_backward through
// pl.pallas_call). For each key tile it loops over the query tiles,
// re-derives the probabilities from the forward's separate stats,
//   p = exp(s - m) / l,   s = (q . k) / sqrt(D)  (-1e30 where masked),
//   dV += (p z)^T dO,
//   dP = (dO . v) * z,    dS = p * (dP - delta),  dS = 0 where masked,
//   dK += dS^T Q / sqrt(D),
// where z = keep / (1 - rate) is the attention-dropout multiplier (1 when
// dropout is off) and delta = rowsum(dO * O) comes from the dQ pass
// (flash_attn_bwd_dq.cu), which runs first.
//
// Like the forward it takes ragged Lq and Lk, head dim 32, 64 or 128,
// operands by (b, h, l) strides, and the boolean mask by (b, q, k) strides
// with stride-0 broadcast, plus causal. A fully masked row has m = -1e30
// and l = Lk, so p = 1/Lk for every key: it still feeds dV, while its dS
// is 0. Causal query tiles are skipped only where every row has a key and
// none reaches this key tile (then p = 0 exactly); the Pallas kernel's
// skip also drops rows with no key at all, which owe dV their 1/Lk share
// (ROADMAP.md, Queue C).
//
// f32 only: tensor-core products of f32 inputs round to TF32, outside the
// f32 tolerance, so this is a SIMT kernel, and f32 is not on the model's
// path. Design: one block of 4 warps per (batch*head, 32-key tile); each
// warp owns 8 keys and keeps their dK and dV in registers (lane = D/32
// columns). The K/V tile is staged once in shared memory; Q and dO tiles
// of 32 rows stream through it, the next one requested before the current
// one is used (Q and dO rows padded by one word, so the lanes' row reads
// hit distinct banks). In the score step lane i computes s and dP of query
// row i against the warp's 8 keys; p z and dS then stay in registers and
// are broadcast by shuffles into the dV and dK updates. No atomics: every
// dK/dV element has one owner, so the result is deterministic.

#include "flash_attn_common.cuh"

namespace {

using namespace vivqa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerWarp = 8;
constexpr int kBlockK = kWarps * kKeysPerWarp;  // 32 keys per block
constexpr int kBlockQ = 32;                     // one query row per lane

template <int D>
constexpr int smem_floats() {
  return 2 * kBlockK * D + 2 * kBlockQ * (D + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attn_bwd_dkv_kernel(BwdParams p) {
  constexpr int kCols = D / 32;
  extern __shared__ float smem[];
  float* sK = smem;                    // [kBlockK][D]
  float* sV = sK + kBlockK * D;        // [kBlockK][D]
  float* sQ = sV + kBlockK * D;        // [kBlockQ][D + 1]
  float* sdO = sQ + kBlockQ * (D + 1); // [kBlockQ][D + 1]

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * kBlockK;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Lq;
  const int q_offset = p.Lk - p.Lq;

  // Causal, unmasked: a query tile contributes nothing to this key tile
  // when its first row has a key and its last row's diagonal ends before
  // the tile's first key. Only a prefix [0, q_begin) of such tiles is
  // skipped, so a leading tile with keyless rows (Lq > Lk) stops the skip.
  int q_begin = 0;
  if (p.causal && mask == nullptr) {
    while (q_begin < p.Lq && q_offset + q_begin >= 0
           && q_offset + min(q_begin + kBlockQ, p.Lq) - 1 < k0)
      q_begin += kBlockQ;
  }

  Tile<T, D, kBlockK, kThreads> tk, tv;
  Tile<T, D, kBlockQ, kThreads> tq, tdo;
  tk.fetch(k, p.k_sl, k0, p.Lk, p.vec);
  tv.fetch(v, p.v_sl, k0, p.Lk, p.vec);
  tq.fetch(q, p.q_sl, q_begin, p.Lq, p.vec);
  tdo.fetch(dout, p.do_sl, q_begin, p.Lq, p.vec);
  tk.template store<D>(sK, 1.f);
  tv.template store<D>(sV, 1.f);

  float dk_acc[kKeysPerWarp][kCols], dv_acc[kKeysPerWarp][kCols];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  for (int q0 = q_begin; q0 < p.Lq; q0 += kBlockQ) {
    __syncthreads();  // the previous Q/dO tile is consumed (and sK/sV written)
    tq.template store<D + 1>(sQ, 1.f);
    tdo.template store<D + 1>(sdO, 1.f);
    __syncthreads();
    if (q0 + kBlockQ < p.Lq) {
      tq.fetch(q, p.q_sl, q0 + kBlockQ, p.Lq, p.vec);
      tdo.fetch(dout, p.do_sl, q0 + kBlockQ, p.Lq, p.vec);
    }

    // lane i: scores and dP of query row q0 + i against the warp's keys
    const int qi = q0 + lane;
    const bool row_in = qi < p.Lq;
    float m = 0.f, l = 1.f, delta = 0.f;
    if (row_in) {
      m = p.m[stat0 + qi];
      l = p.l[stat0 + qi];
      delta = p.delta[stat0 + qi];
    }
    float s[kKeysPerWarp], dp[kKeysPerWarp];
#pragma unroll
    for (int j = 0; j < kKeysPerWarp; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[lane * (D + 1) + d];
      const float dod = sdO[lane * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        const int key = warp * kKeysPerWarp + j;
        s[j] = fmaf(qd, sK[key * D + d], s[j]);
        dp[j] = fmaf(dod, sV[key * D + d], dp[j]);
      }
    }
    const uint32_t row_hash = p.drop.row(qi);
#pragma unroll
    for (int j = 0; j < kKeysPerWarp; ++j) {
      const int kj = k0 + warp * kKeysPerWarp + j;
      float pz = 0.f, ds = 0.f;
      if (row_in && kj < p.Lk) {
        bool keep = !p.causal || q_offset + qi >= kj;
        if (mask != nullptr) keep = keep && mask[qi * p.m_sq + kj * p.m_sk] != 0;
        const float pr = expf((keep ? s[j] * p.scale : kMasked) - m) / l;
        const float z = p.drop.on ? p.drop.scale(row_hash, kj) : 1.f;
        pz = pr * z;
        if (keep) ds = pr * (dp[j] * z - delta);  // 0 where masked
      }
      s[j] = pz;   // lane i holds p z of (row i, key j)
      dp[j] = ds;  // and dS
    }

    // dV[key] += sum_i (p z)[i, key] dO[i];  dK[key] += sum_i dS[i, key] Q[i]
    const int nq = min(kBlockQ, p.Lq - q0);
    for (int i = 0; i < nq; ++i) {
      float qrow[kCols], dorow[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        qrow[c] = sQ[i * (D + 1) + lane + 32 * c];
        dorow[c] = sdO[i * (D + 1) + lane + 32 * c];
      }
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        const float pzi = __shfl_sync(kFull, s[j], i);
        const float dsi = __shfl_sync(kFull, dp[j], i);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[j][c] = fmaf(pzi, dorow[c], dv_acc[j][c]);
          dk_acc[j][c] = fmaf(dsi, qrow[c], dk_acc[j][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int kj = k0 + warp * kKeysPerWarp + j;
    if (kj >= p.Lk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[kj * p.dk_sl + lane + 32 * c] = from_f32<T>(dk_acc[j][c] * p.scale);
      dv[kj * p.dv_sl + lane + 32 * c] = from_f32<T>(dv_acc[j][c]);
    }
  }
}

template <typename T, int D>
int launch_d(const BwdParams& p, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  const int err = allow_smem(flash_attn_bwd_dkv_kernel<T, D>, bytes);
  if (err != 0) return err;
  const dim3 grid((p.Lk + kBlockK - 1) / kBlockK, p.B * p.H);
  flash_attn_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace vivqa::dkv {

// The launcher of one (dtype, head dim) pair; the part of the build that
// holds the pair's kernels defines it.
template <typename T, int D>
int launch_pair(const BwdParams& p, cudaStream_t stream);

#if VIVQA_BUILDS_KERNELS
template <typename T, int D>
int launch_pair(const BwdParams& p, cudaStream_t stream) {
  return launch_d<T, D>(p, stream);
}

// The f32 pair of head dim D: part 1 builds D = 32, part 2 D = 64, part 3
// D = 128.
#define VIVQA_PAIRS_OF(D) template int launch_pair<float, D>(const BwdParams&, cudaStream_t);
#if VIVQA_BUILDS_PART(1)
VIVQA_PAIRS_OF(32)
#endif
#if VIVQA_BUILDS_PART(2)
VIVQA_PAIRS_OF(64)
#endif
#if VIVQA_BUILDS_PART(3)
VIVQA_PAIRS_OF(128)
#endif
#if defined(VIVQA_PART) && VIVQA_PART > 3
#error "flash_attn_bwd_dkv.cu has kernel parts 1-3 (ops/cuda_build.py: PARTS)"
#endif
#endif  // VIVQA_BUILDS_KERNELS

}  // namespace vivqa::dkv

#if VIVQA_BUILDS_ENTRY
namespace {

template <typename T>
int launch(const BwdParams& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return vivqa::dkv::launch_pair<T, 32>(p, stream);
    case 64:
      return vivqa::dkv::launch_pair<T, 64>(p, stream);
    case 128:
      return vivqa::dkv::launch_pair<T, 128>(p, stream);
    default:
      return -1;
  }
}

}  // namespace

// The argument list of vivqa_flash_attn_bwd_dq (flash_attn_bwd_dq.cu):
// here o and dq are unused, delta is read, dk and dv are written (dtype).
extern "C" int vivqa_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const float* m,
                                        const float* l, float* delta, void* dq, void* dk,
                                        void* dv, const void* mask, int dtype, int head_dim,
                                        int B, int H, int Lq, int Lk, const long long* strides,
                                        int causal, int vec, float scale, int dropout,
                                        unsigned threshold, unsigned key, float inv_keep,
                                        void* stream) {
  const BwdParams p = make_bwd_params(q, k, v, o, dout, m, l, delta, dq, dk, dv, mask, B, H,
                                      Lq, Lk, strides, causal, vec, scale, dropout, threshold,
                                      key, inv_keep);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(p, head_dim, s);
    default:
      return -1;
  }
}
#endif  // VIVQA_BUILDS_ENTRY
