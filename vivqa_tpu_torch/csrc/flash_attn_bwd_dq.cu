// Attention backward, dQ pass, for Hopper (sm_90a), plain C interface:
// the f32 backward's first kernel (bf16 and f16 take the one-pass kernel
// of flash_attn_bwd.cu).
//
// Replaces, in f32, the Pallas TPU kernel vivqa_tpu/ops/flash_attention.py:
// _flash_bwd_dq_kernel (launched by _flash_backward through
// pl.pallas_call). For each query tile it loops over the key tiles,
// re-derives the probabilities from the forward's separate stats,
//   p = exp(s - m) / l,   s = (q . k) / sqrt(D)  (-1e30 where masked),
//   dP = (dO . v) * z,    dS = p * (dP - delta),  dS = 0 where masked,
//   dQ += dS K / sqrt(D),
// where z = keep / (1 - rate) is the attention-dropout multiplier (1 when
// dropout is off). It also folds in the pre-pass the Pallas backward left
// to XLA: delta = rowsum(dO * O) for its rows, written out for the dK/dV
// pass (flash_attn_bwd_dkv.cu), which therefore runs after this one.
//
// Like the forward it takes ragged Lq and Lk, head dim 32, 64 or 128,
// operands by (b, h, l) strides, and the boolean mask by (b, q, k) strides
// with stride-0 broadcast, plus causal. A fully masked row (every key
// scored -1e30) has m = -1e30 and l = Lk, so p = 1/Lk per key, and dS is 0
// at every masked entry: exactly jax.vjp through jnp.where(mask, logits,
// -1e30). Keys past Lk contribute nothing. The only skip is the forward's:
// a causal, unmasked query tile whose first row has a key stops at its
// last row's diagonal (the keys beyond have p = 0 exactly); the Pallas dq
// kernel's skip also drops K blocks that rows with no key at all still
// owe (ROADMAP.md, Queue C).
//
// f32 only: tensor-core products of f32 inputs round to TF32, outside the
// f32 tolerance, so this is a SIMT kernel, and f32 is not on the model's
// path. Design: one block of 4 warps per (batch*head, 32-query tile);
// each warp owns 8 query rows and keeps their dQ in registers (lane =
// D/32 columns). Q and dO tiles are staged once in shared memory; K/V
// tiles of 32 keys stream through it, the next one requested before the
// current one is used (K and V rows padded by one word). Lane j computes
// s and dP for key j and the warp's 8 rows; dS then stays in registers
// and is broadcast by shuffles into the dQ update. No atomics: every dQ
// element has one owner, so the result is deterministic.

#include "flash_attn_common.cuh"

namespace {

using namespace vivqa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 32 query rows per block
constexpr int kBlockK = 32;                     // one key per lane

template <int D>
constexpr int smem_floats() {
  return 2 * kBlockQ * D + 2 * kBlockK * (D + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attn_bwd_dq_kernel(BwdParams p) {
  constexpr int kCols = D / 32;
  extern __shared__ float smem[];
  float* sQ = smem;                   // [kBlockQ][D]
  float* sdO = sQ + kBlockQ * D;      // [kBlockQ][D]
  float* sK = sdO + kBlockQ * D;      // [kBlockK][D + 1]
  float* sV = sK + kBlockK * (D + 1); // [kBlockK][D + 1]

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Lq;

  const int q_offset = p.Lk - p.Lq;
  int k_end = p.Lk;  // the forward's causal skip (see the note above)
  if (p.causal && mask == nullptr && q_offset + q0 >= 0) {
    const int last_row = min(q0 + kBlockQ, p.Lq) - 1;
    k_end = min(p.Lk, q_offset + last_row + 1);
  }

  Tile<T, D, kBlockQ, kThreads> tq, tdo;
  Tile<T, D, kBlockK, kThreads> tk, tv;
  tq.fetch(q, p.q_sl, q0, p.Lq, p.vec);
  tdo.fetch(dout, p.do_sl, q0, p.Lq, p.vec);
  tk.fetch(k, p.k_sl, 0, p.Lk, p.vec);
  tv.fetch(v, p.v_sl, 0, p.Lk, p.vec);
  tq.template store<D>(sQ, 1.f);
  tdo.template store<D>(sdO, 1.f);
  __syncthreads();

  // Per-row stats of the warp's rows; delta = rowsum(dO * O) from the
  // staged dO and O read straight from memory, reduced over the warp.
  float m[kRowsPerWarp], l[kRowsPerWarp], delta[kRowsPerWarp];
  uint32_t row_hash[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const int qi = q0 + row;
    float part = 0.f;
    m[r] = 0.f;
    l[r] = 1.f;
    if (qi < p.Lq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        part = fmaf(sdO[row * D + lane + 32 * c], to_f32(o[qi * p.o_sl + lane + 32 * c]), part);
      m[r] = p.m[stat0 + qi];
      l[r] = p.l[stat0 + qi];
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(kFull, part, off);
    delta[r] = part;
    if (qi < p.Lq && lane == 0) p.delta[stat0 + qi] = part;
    row_hash[r] = p.drop.row(qi);
  }

  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous K/V tile is consumed
    tk.template store<D + 1>(sK, 1.f);
    tv.template store<D + 1>(sV, 1.f);
    __syncthreads();
    if (k0 + kBlockK < k_end) {
      tk.fetch(k, p.k_sl, k0 + kBlockK, p.Lk, p.vec);
      tv.fetch(v, p.v_sl, k0 + kBlockK, p.Lk, p.vec);
    }

    // lane j: scores and dP of key k0 + j against the warp's rows
    const int kj = k0 + lane;
    const bool in_range = kj < p.Lk;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = sK[lane * (D + 1) + d];
      const float vd = sV[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp * kRowsPerWarp + r;
        s[r] = fmaf(sQ[row * D + d], kd, s[r]);
        dp[r] = fmaf(sdO[row * D + d], vd, dp[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + warp * kRowsPerWarp + r;
      float ds = 0.f;
      if (in_range && qi < p.Lq) {
        bool keep = !p.causal || q_offset + qi >= kj;
        if (mask != nullptr) keep = keep && mask[qi * p.m_sq + kj * p.m_sk] != 0;
        if (keep) {  // dS is 0 where masked, whatever p is
          const float pr = expf(s[r] * p.scale - m[r]) / l[r];
          const float z = p.drop.on ? p.drop.scale(row_hash[r], kj) : 1.f;
          ds = pr * (dp[r] * z - delta[r]);
        }
      }
      s[r] = ds;  // lane j now holds dS for key j
    }

    // dQ[row] += sum_j dS[row, j] K[j]
    const int nk = min(kBlockK, p.Lk - k0);
    for (int j = 0; j < nk; ++j) {
      float kj_row[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kj_row[c] = sK[j * (D + 1) + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsj, kj_row[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= p.Lq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[qi * p.dq_sl + lane + 32 * c] = from_f32<T>(acc[r][c] * p.scale);
  }
}

template <typename T, int D>
int launch_d(const BwdParams& p, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  const int err = allow_smem(flash_attn_bwd_dq_kernel<T, D>, bytes);
  if (err != 0) return err;
  const dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_attn_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace vivqa::dq {

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
#error "flash_attn_bwd_dq.cu has kernel parts 1-3 (ops/cuda_build.py: PARTS)"
#endif
#endif  // VIVQA_BUILDS_KERNELS

}  // namespace vivqa::dq

#if VIVQA_BUILDS_ENTRY
namespace {

template <typename T>
int launch(const BwdParams& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return vivqa::dq::launch_pair<T, 32>(p, stream);
    case 64:
      return vivqa::dq::launch_pair<T, 64>(p, stream);
    case 128:
      return vivqa::dq::launch_pair<T, 128>(p, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32 (bfloat16 and float16 take vivqa_flash_attn_bwd in
// flash_attn_bwd.cu). Pointers q, k, v, o, dO (dtype), m, l (f32, (B*H, Lq) contiguous), delta (f32 out, same shape),
// dq (dtype out), mask (bool, or null); dk and dv are unused here.
// strides: 27 element strides, in order q, k, v, o, dO, dq, dk, dv (each
// b, h, l) and the mask (b, q, k). vec = 1 promises 16-byte aligned rows
// of q, k, v and dO. Dropout as in flash_attn_fwd.cu. Returns
// cudaGetLastError() after the launch, or -1 for a head dim or dtype this
// file was not built for.
extern "C" int vivqa_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
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
