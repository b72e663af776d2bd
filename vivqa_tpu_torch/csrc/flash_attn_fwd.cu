// Blocked (flash) attention forward for Hopper (sm_90a), plain C interface.
// Two entry points, one kernel template:
//
// vivqa_flash_attn_fwd replaces the Pallas TPU kernel
// vivqa_tpu/ops/flash_attention.py: _flash_kernel (launched by
// _flash_forward through pl.pallas_call); it serves inference.
// vivqa_flash_attn_fwd_lse replaces _flash_kernel_lse (launched by
// _flash_forward_lse): the same forward, which also writes the per-row f32
// softmax stats m (running max) and l (running sum), kept SEPARATE and not
// folded into an lse (a fully masked row has m = -1e30, which would absorb
// log l), and applies attention-probability dropout (flax's
// broadcast_dropout: one keep mask per call, shared by every batch row and
// head). It is the training forward; the backward kernels read m and l.
//
// Both compute softmax(Q K^T / sqrt(D) [causal]) V with the 1/sqrt(D)
// scale applied to the query in f32, the causal diagonal anchored at the
// END of the key axis (q_offset = Lk - Lq), an online softmax with f32
// running max m, running sum l and accumulator, and the output in the
// input's dtype. Beyond the Pallas kernels they take:
//   - any Lq and Lk (the ragged last tiles are masked here);
//   - an optional boolean mask given by element strides (b, q, k), so a
//     (B, 1, Lq, Lk) mask, or one broadcast over q or k with stride 0,
//     is read without a copy; it is shared by all heads;
//   - q/k/v/o by element strides (b, h, l) with a unit stride over D, so
//     the (B, L, H, D) projections are read and written in place.
//
// Masked and out-of-range keys are kept apart. A key the mask or the
// causal rule removes is scored -1e30, as in flax and the Pallas kernel:
// a row whose keys are all masked then comes out as the uniform average
// over all Lk keys, never NaN. A key beyond Lk in the last tile gets
// probability exactly 0 and is not counted at all. Dropout multiplies the
// normalised probability by keep / (1 - rate) before P.V; l sums the
// probabilities before dropout, so o = sum_k (p_k z_k) v_k exactly.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the model's
// shapes (head dim 64, L <= 64) one call reads q, k, v and writes o (and
// m, l), and does 4*B*H*Lq*Lk*D flops: at L <= 64 that is ~1 flop per byte
// moved, far below the ~295 the card needs before the tensor cores bind,
// so the bound is the bytes (0.7-10 us from batch 8 to batch 128).
// chip_smoke.py measures the kernel against it.
//
// Design: simple and right first. One block of 4 warps per (batch*head,
// 16-query tile); each warp owns 4 query rows. K/V tiles of 32 keys are
// staged in shared memory as f32 (K rows padded by one word so the lanes
// of a warp hit distinct banks); each tile is loaded with all its 16-byte
// loads in flight at once, and the next K/V tile is requested before the
// current one is used. In the score step lane j scores key j for
// the warp's 4 rows; the warp's max and sum come from shuffles; in the PV
// step each lane owns D/32 output columns and the probabilities are
// broadcast by shuffles. The dropout keep bit costs one 32-bit hash per
// score. All arithmetic is f32 FMA on the CUDA cores: no tensor cores
// (mma/wgmma) and no TMA, which are later work.

#include "flash_attn_common.cuh"

namespace {

using namespace vivqa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 32;                     // one key per lane

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* m_out;  // (B*H, Lq), training forward only
  float* l_out;
  const uint8_t* mask;  // nullptr = no mask
  int B, H, Lq, Lk;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long m_sb, m_sq, m_sk;
  int causal;
  int vec;  // 1: every q/k/v row start is 16-byte aligned (vector loads)
  float scale;
  Dropout drop;  // training forward only
};

// kTrain: write m and l, apply dropout (vivqa_flash_attn_fwd_lse).
template <typename T, int D, bool kTrain>
__global__ void __launch_bounds__(kThreads) flash_attn_fwd_kernel(Params p) {
  constexpr int kColsPerLane = D / 32;
  __shared__ float sQ[kBlockQ][D];
  __shared__ float sK[kBlockK][D + 1];
  __shared__ float sV[kBlockK][D];

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
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* mask = p.mask ? p.mask + b * p.m_sb : nullptr;

  const int q_offset = p.Lk - p.Lq;
  // Causal without a mask: keys past the block's last diagonal carry
  // weight exactly 0 and are skipped -- unless the block's first row has
  // no key at all (Lq > Lk), which must average over all Lk keys.
  int k_end = p.Lk;
  if (p.causal && mask == nullptr && q_offset + q0 >= 0) {
    const int last_row = min(q0 + kBlockQ, p.Lq) - 1;
    k_end = min(p.Lk, q_offset + last_row + 1);
  }

  // Tiles go through registers: the Q tile and the first K/V tile are
  // requested together, and each next K/V tile is requested before the
  // current one's arithmetic, so load latency overlaps work.
  Tile<T, D, kBlockQ, kThreads> tq;
  Tile<T, D, kBlockK, kThreads> tk, tv;
  tq.fetch(q, p.q_sl, q0, p.Lq, p.vec);
  tk.fetch(k, p.k_sl, 0, p.Lk, p.vec);
  tv.fetch(v, p.v_sl, 0, p.Lk, p.vec);
  tq.template store<D>(&sQ[0][0], p.scale);

  float acc[kRowsPerWarp][kColsPerLane];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  uint32_t row_hash[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
    row_hash[r] = kTrain ? p.drop.row(q0 + warp * kRowsPerWarp + r) : 0u;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    tk.template store<D + 1>(&sK[0][0], 1.f);
    tv.template store<D>(&sV[0][0], 1.f);
    __syncthreads();
    if (k0 + kBlockK < k_end) {
      tk.fetch(k, p.k_sl, k0 + kBlockK, p.Lk, p.vec);
      tv.fetch(v, p.v_sl, k0 + kBlockK, p.Lk, p.vec);
    }

    const int kj = k0 + lane;
    const bool in_range = kj < p.Lk;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sK[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(sQ[warp * kRowsPerWarp + r][d], kd, s[r]);
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + warp * kRowsPerWarp + r;
      float sc = s[r];
      if (!in_range) {
        sc = -INFINITY;
      } else {
        bool keep = !p.causal || q_offset + qi >= kj;
        if (mask != nullptr && qi < p.Lq) keep = keep && mask[qi * p.m_sq + kj * p.m_sk] != 0;
        if (!keep) sc = kMasked;
      }
      float tile_max = sc;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, off));
      const float m_new = fmaxf(m[r], tile_max);
      float pr = in_range ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      float tile_sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) tile_sum += __shfl_xor_sync(kFull, tile_sum, off);
      l[r] = alpha * l[r] + tile_sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[r][c] *= alpha;
      if (kTrain && p.drop.on && in_range) pr *= p.drop.scale(row_hash[r], kj);
      s[r] = pr;  // lane j now holds p (times its dropout multiplier) for key j
    }

    const int nk = min(kBlockK, p.Lk - k0);
    for (int j = 0; j < nk; ++j) {
      float vj[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) vj[c] = sV[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= p.Lq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lr;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) o[qi * p.o_sl + lane + 32 * c] = from_f32<T>(acc[r][c] * inv);
    if (kTrain && lane == 0) {
      p.m_out[static_cast<long long>(bh) * p.Lq + qi] = m[r];
      p.l_out[static_cast<long long>(bh) * p.Lq + qi] = lr;
    }
  }
}

template <typename T, bool kTrain>
int launch(const Params& p, int head_dim, cudaStream_t stream) {
  const dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  const dim3 block(kThreads);
  switch (head_dim) {
    case 64:
      flash_attn_fwd_kernel<T, 64, kTrain><<<grid, block, 0, stream>>>(p);
      break;
    case 128:
      flash_attn_fwd_kernel<T, 128, kTrain><<<grid, block, 0, stream>>>(p);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v, void* o, const void* mask,
                   int B, int H, int Lq, int Lk, const long long* strides, int causal, int vec,
                   float scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.m_out = nullptr;
  p.l_out = nullptr;
  p.mask = static_cast<const uint8_t*>(mask);
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_sl = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_sl = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_sl = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_sl = strides[11];
  p.m_sb = strides[12];
  p.m_sq = strides[13];
  p.m_sk = strides[14];
  p.causal = causal;
  p.vec = vec;
  p.scale = scale;
  p.drop.on = 0;
  p.drop.threshold = 0u;
  p.drop.key = 0u;
  p.drop.inv_keep = 1.f;
  return p;
}

template <bool kTrain>
int dispatch(const Params& p, int dtype, int head_dim, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch<float, kTrain>(p, head_dim, s);
    case 1:
      return launch<__nv_bfloat16, kTrain>(p, head_dim, s);
    case 2:
      return launch<__half, kTrain>(p, head_dim, s);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// strides: 15 element strides, in order q (b, h, l), k (b, h, l),
// v (b, h, l), o (b, h, l), mask (b, q, k); the mask's are ignored when
// mask is null. vec = 1 promises that q, k and v and all their b/h/l
// strides are 16-byte aligned, so tiles load as 16-byte vectors. Returns
// cudaGetLastError() after the launch, or -1 for a head dim or dtype this
// file was not built for.
extern "C" int vivqa_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* mask, int dtype, int head_dim, int B, int H,
                                    int Lq, int Lk, const long long* strides, int causal,
                                    int vec, float scale, void* stream) {
  const Params p = make_params(q, k, v, o, mask, B, H, Lq, Lk, strides, causal, vec, scale);
  return dispatch<false>(p, dtype, head_dim, static_cast<cudaStream_t>(stream));
}

// The training forward: as vivqa_flash_attn_fwd, and also writes m and l,
// each (B*H, Lq) f32 contiguous, and applies dropout when dropout = 1:
// key (q, k) is kept iff mix32(mix32(key ^ q) ^ k) >= threshold, and a
// kept probability is multiplied by inv_keep.
extern "C" int vivqa_flash_attn_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                        float* m, float* l, const void* mask, int dtype,
                                        int head_dim, int B, int H, int Lq, int Lk,
                                        const long long* strides, int causal, int vec,
                                        float scale, int dropout, unsigned threshold,
                                        unsigned key, float inv_keep, void* stream) {
  Params p = make_params(q, k, v, o, mask, B, H, Lq, Lk, strides, causal, vec, scale);
  p.m_out = m;
  p.l_out = l;
  p.drop.on = dropout;
  p.drop.threshold = threshold;
  p.drop.key = key;
  p.drop.inv_keep = inv_keep;
  return dispatch<true>(p, dtype, head_dim, static_cast<cudaStream_t>(stream));
}
