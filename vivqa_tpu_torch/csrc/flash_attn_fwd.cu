// Blocked (flash) attention forward for Hopper (sm_90a), plain C interface.
// Two entry points and two kernel templates (see below):
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
// scale applied in f32 (to the query in the SIMT template, to the scores
// in the tensor-core one), the causal diagonal anchored at the
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
// probability by keep / (1 - rate) before P.V; l sums the probabilities
// before dropout, so o = sum_k (p_k z_k) v_k.
//
// Two templates. The SIMT template (flash_attn_fwd_kernel) serves both
// entries in f32. In bf16 and f16 both entries take the tensor-core
// template (fwd_mma_body): the training entry through
// flash_attn_fwd_lse_mma_kernel (64 query rows a block), the serving
// entry through flash_attn_fwd_mma_kernel (16, 32 or 64 query rows a
// block, chosen by the caller). f32 inputs would round to TF32 on the
// tensor cores, outside the f32 tolerances, and f32 is not on the model's
// path. The choice of template is by dtype only; a failed build or launch
// raises.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 132 SMs, 227
// KB of shared memory a block, 64K registers an SM): at the model's shapes
// (head dim 64, L <= 64) one call reads q, k, v and writes o (and m, l),
// and does 4*B*H*Lq*Lk*D flops, 1-2 flops per byte moved, far below the
// ~295 at which the tensor cores bind, so the bytes bind: 0.437 ms for the
// 36 training calls of bench.py's step at batch 128, 0.027 ms for the 36
// serving calls of a forward at batch 8 (chip_smoke.py). A serving call at
// batch 8 moves ~2.5 MB, under a microsecond of memory time: there the
// latency of one block's load-compute-store chain and the number of blocks
// in flight set the time, not the bytes.
//
// SIMT design (f32): one block of 4 warps per (batch*head, 16-query
// tile); each warp owns 4 query rows. K/V tiles of 32 keys are staged in
// shared memory as f32 (K rows padded by one word); each tile is loaded
// with all its 16-byte loads in flight at once, and the next K/V tile is
// requested before the current one is used. Lane j scores key j for the
// warp's 4 rows; the warp's max and sum come from shuffles; in the PV step
// each lane owns D/32 output columns and the probabilities are broadcast
// by shuffles. All arithmetic is f32 FMA on the CUDA cores.
//
// Tensor-core design (bf16/f16), from the SIMT template's measured faults
// (4.28 ms per training step at batch 128 against SDPA's 1.91 ms; 0.378 ms
// per serving forward at batch 8 against SDPA's 0.352; chip_smoke.py): one
// shared-memory load per FMA in the score loop, one shuffle per 2 FMAs in
// P.V, tiles staged as f32 (twice the bytes and stores), and 16-row
// blocks that re-read a head's K and V four times.
//   - One block of ROWS / 16 warps per (batch*head, ROWS query rows); each
//     warp owns 16 rows. The training forward takes ROWS = 64: at L <= 64
//     a block holds a whole head, so K and V leave device memory once per
//     (b, h): 1,536 blocks for the 12-head calls at batch 128. At batch 8
//     that gives only 96 or 64 blocks for 132 SMs, so the serving forward
//     takes ROWS = 16, 32 or 64 (ops/flash_attention.py picks the one
//     chip_smoke.py measured fastest); each block then stages its head's
//     whole K and V, which the other blocks of the head find in L2. Longer
//     keys loop over 64-key tiles with the online softmax, the next K/V
//     tile copied while this one is used.
//   - q, k, v are copied into shared memory by 16-byte cp.async in their
//     own dtype, rows padded to D + 8 elements so ldmatrix is conflict
//     free (element loads into the same layout for views whose rows do not
//     start on 16 bytes).
//   - S = Q K^T by mma.sync m16n8k16 into f32, then scaled in f32 (exact
//     at D = 64: 1/8). Masks, causal and ragged rules apply on the
//     fragment's (row, key) coordinates. Row max and sum take 2 shuffles
//     across the quad that holds a row.
//   - p = exp(s - m) (times the dropout multiplier, training only) is
//     rounded to the input dtype as the A operand of P.V in registers (no
//     shared-memory round trip); the plain version rounds the normalised
//     probabilities instead (ROADMAP.md, Queue C). l sums the f32 p.
//     O += P V by mma with V through ldmatrix.trans.
//   - o is written through the warp's own Q rows with 16-byte stores; the
//     training forward also writes m and l in f32.
// The products are no longer the cost: at 2.4x its bound on the H100 the
// training forward is held by the chain of elementwise steps per score
// (rules, exp, dropout hash, row max and sum), more than by the copies
// (PERF.md, Findings).

#include "flash_attn_mma.cuh"

namespace vivqa::fwd {

// Named, not in the anonymous namespace: the parts of the build pass it
// to each other.
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

// The launchers of one (dtype, head dim) pair, serving and training; the
// part of the build that holds the pair's kernels defines them.
template <typename T, int D>
int serve_pair(const Params& p, int tile_rows, cudaStream_t stream);
template <typename T, int D>
int train_pair(const Params& p, cudaStream_t stream);

}  // namespace vivqa::fwd

namespace {

using namespace vivqa;
using fwd::Params;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 32;                     // one key per lane

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

// The forward on the tensor cores (bf16 / f16): ROWS query rows a block,
// one warp per 16. kTrain: write m and l and apply dropout (the training
// forward); else neither (the serving forward). kMask: the call has a
// mask, whose (ROWS x 64)-byte tile for each key tile is staged in shared
// memory with the K/V tile (16-byte copies when mask_vec); without one
// the mask code is not compiled in. o_vec: o's rows start on 16 bytes.
// smem: ROWS staged Q rows, K and V of buffer 0 (and of buffer 1 when
// Lk > 64), then the mask tile of each buffer.
template <typename T, int D, int ROWS, bool kTrain, bool kMask>
__device__ __forceinline__ void fwd_mma_body(const Params& p, int o_vec, int mask_vec,
                                             unsigned char* smem) {
  using namespace mma;
  constexpr int THREADS = ROWS * 2;
  constexpr int P = pitch<D>();
  constexpr int TE = tile_elems<D>();  // one 64-key K or V tile
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + ROWS * P;
  const int nbuf = p.Lk > kTileRows ? 2 : 1;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sKV + 2 * nbuf * TE);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const KeyRule rule{kMask ? p.mask + b * p.m_sb : nullptr, p.m_sq, p.m_sk, p.Lq, p.Lk,
                     p.Lk - p.Lq, p.causal};
  const int k_end = causal_key_end(rule, q0, ROWS);
  const int n_tiles = (k_end + kTileRows - 1) / kTileRows;

  load_tile<T, D, ROWS, THREADS>(sQ, q, p.q_sl, q0, p.Lq, p.vec);
  load_tile<T, D, kTileRows, THREADS>(sKV, k, p.k_sl, 0, p.Lk, p.vec);
  load_tile<T, D, kTileRows, THREADS>(sKV + TE, v, p.v_sl, 0, p.Lk, p.vec);
  if (kMask)
    load_mask_tile<ROWS, THREADS>(sMask, rule.mask, rule.sq, rule.sk, q0, p.Lq, 0, p.Lk,
                                  mask_vec);
  cp_async_commit();

  const T* sQw = sQ + warp * 16 * P;  // the warp's 16 rows
  const int qi[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t row_hash[2] = {0u, 0u};
  if (kTrain) {
    row_hash[0] = p.drop.row(qi[0]);
    row_hash[1] = p.drop.row(qi[1]);
  }
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < n_tiles) {
      T* nxt = sKV + 2 * ((kt + 1) & 1) * TE;
      load_tile<T, D, kTileRows, THREADS>(nxt, k, p.k_sl, (kt + 1) * kTileRows, p.Lk, p.vec);
      load_tile<T, D, kTileRows, THREADS>(nxt + TE, v, p.v_sl, (kt + 1) * kTileRows, p.Lk,
                                          p.vec);
      if (kMask)
        load_mask_tile<ROWS, THREADS>(sMask + ((kt + 1) & 1) * ROWS * kMaskPitch, rule.mask,
                                      rule.sq, rule.sk, q0, p.Lq, (kt + 1) * kTileRows, p.Lk,
                                      mask_vec);
      cp_async_commit();
    }
    const T* sK = sKV + 2 * (kt & 1) * TE;
    const T* sV = sK + TE;
    const uint8_t* sM = sMask + (kt & 1) * ROWS * kMaskPitch + warp * 16 * kMaskPitch;
    const int k0 = kt * kTileRows;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    gemm_abt<T, D, 8>(s, sQw, sK, lane);

    // element (j, e): row qi[e / 2], key k0 + 8j + 2t + e % 2
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1);  // the key within the tile
        const KeyState st = rule.state(
            qi[e / 2], k0 + kc, !kMask || sM[(g + 8 * (e / 2)) * kMaskPitch + kc] != 0);
        float sc = s[j][e] * p.scale;
        if (st == kPastEnd) sc = -INFINITY;
        if (st == kRemoved) sc = kMasked;
        s[j][e] = sc;
        tile_max[e / 2] = fmaxf(tile_max[e / 2], sc);
      }
    float alpha[2], tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tile_max[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = expf(s[j][e] - m[e / 2]);  // exactly 0 past Lk (-inf)
        tile_sum[e / 2] += pr;
        if (kTrain && p.drop.on)
          pr *= p.drop.scale(row_hash[e / 2], k0 + 8 * j + 2 * t + (e & 1));
        s[j][e] = pr;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(tile_sum[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    uint32_t a[4][4];
    to_a_frags<T, 8>(a, s);  // p (z) rounded to T: the operand of P.V
    gemm_ab<T, D, 4>(acc, a, sV, lane);
  }

  const float lr[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  store_rows<T, D>(sQ + warp * 16 * P, acc, 1.f / lr[0], 1.f / lr[1], o, p.o_sl,
                   q0 + warp * 16, p.Lq, lane, o_vec);
  if (kTrain && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] < p.Lq) {
        p.m_out[static_cast<long long>(bh) * p.Lq + qi[r]] = m[r];
        p.l_out[static_cast<long long>(bh) * p.Lq + qi[r]] = lr[r];
      }
    }
  }
}

// The training forward on the tensor cores. At D = 64 ptxas fits it in 128
// registers, 4 blocks an SM; D = 128 takes 2 blocks, without spills.
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(mma::kThreads, D == 64 ? 4 : 2)
    flash_attn_fwd_lse_mma_kernel(Params p, int o_vec, int mask_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fwd_mma_body<T, D, mma::kTileRows, true, kMask>(p, o_vec, mask_vec, smem_raw);
}

// The serving forward on the tensor cores, ROWS = 16, 32 or 64 query rows
// a block, held to 168 registers a thread at D = 64 (3 blocks of 64 rows
// an SM; at 128 it spilled, and ran no faster on the H100), 255 at
// D = 128. Serving grids at batch 8 fill one wave either way.
template <typename T, int D, int ROWS, bool kMask>
__global__ void __launch_bounds__(2 * ROWS, (D == 64 ? 3 : 2) * mma::kTileRows / ROWS)
    flash_attn_fwd_mma_kernel(Params p, int o_vec, int mask_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fwd_mma_body<T, D, ROWS, false, kMask>(p, o_vec, mask_vec, smem_raw);
}

template <typename T, int D, bool kTrain>
int launch_simt(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  const dim3 block(kThreads);
  flash_attn_fwd_kernel<T, D, kTrain><<<grid, block, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch a tensor-core forward kernel of ROWS query rows a block: its
// shared memory (the staged rows, the K/V tiles, and the mask tiles when
// there is a mask), grid and alignment flags.
template <typename T, int D, int ROWS, typename Kernel>
int launch_fwd_mma(Kernel kernel, const Params& p, cudaStream_t stream) {
  const int nbuf = p.Lk > mma::kTileRows ? 2 : 1;
  const int bytes = mma::smem_bytes<T, D>(ROWS, p.Lk) +
                    (p.mask != nullptr ? nbuf * ROWS * mma::kMaskPitch : 0);
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  const dim3 grid((p.Lq + ROWS - 1) / ROWS, p.B * p.H);
  const int o_vec = mma::rows_aligned16(p.o, p.o_sb, p.o_sh, p.o_sl);
  const int mask_vec = mma::mask_rows_aligned16(p.mask, p.m_sb, p.m_sq, p.m_sk);
  kernel<<<grid, 2 * ROWS, bytes, stream>>>(p, o_vec, mask_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_mma_d(const Params& p, cudaStream_t stream) {
  constexpr int R = mma::kTileRows;
  return p.mask != nullptr
             ? launch_fwd_mma<T, D, R>(flash_attn_fwd_lse_mma_kernel<T, D, true>, p, stream)
             : launch_fwd_mma<T, D, R>(flash_attn_fwd_lse_mma_kernel<T, D, false>, p, stream);
}

template <typename T, int D, int ROWS>
int launch_serve_rows(const Params& p, cudaStream_t stream) {
  return p.mask != nullptr
             ? launch_fwd_mma<T, D, ROWS>(flash_attn_fwd_mma_kernel<T, D, ROWS, true>, p, stream)
             : launch_fwd_mma<T, D, ROWS>(flash_attn_fwd_mma_kernel<T, D, ROWS, false>, p,
                                          stream);
}

template <typename T, int D>
int launch_serve_d(const Params& p, int tile_rows, cudaStream_t stream) {
  switch (tile_rows) {
    case 16:
      return launch_serve_rows<T, D, 16>(p, stream);
    case 32:
      return launch_serve_rows<T, D, 32>(p, stream);
    case 64:
      return launch_serve_rows<T, D, 64>(p, stream);
    default:
      return -1;
  }
}

}  // namespace

namespace vivqa::fwd {

#if VIVQA_BUILDS_KERNELS
// f32 takes the SIMT template (no TF32 rounding), bf16 and f16 the
// tensor-core one.
template <typename T, int D>
int serve_pair(const Params& p, int tile_rows, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    return launch_simt<T, D, false>(p, stream);
  } else {
    return launch_serve_d<T, D>(p, tile_rows, stream);
  }
}

template <typename T, int D>
int train_pair(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    return launch_simt<T, D, true>(p, stream);
  } else {
    return launch_mma_d<T, D>(p, stream);
  }
}

#define VIVQA_PAIR(T, D)                                                   \
  template int serve_pair<T, D>(const Params&, int, cudaStream_t);         \
  template int train_pair<T, D>(const Params&, cudaStream_t);
// part 1: bf16 and f16 at D = 32; 2 and 3: bf16, f16 at 64; 4 and 5:
// bf16, f16 at 128; 6: f32 at every D
#if VIVQA_BUILDS_PART(1)
VIVQA_PAIR(__nv_bfloat16, 32)
VIVQA_PAIR(__half, 32)
#endif
#if VIVQA_BUILDS_PART(2)
VIVQA_PAIR(__nv_bfloat16, 64)
#endif
#if VIVQA_BUILDS_PART(3)
VIVQA_PAIR(__half, 64)
#endif
#if VIVQA_BUILDS_PART(4)
VIVQA_PAIR(__nv_bfloat16, 128)
#endif
#if VIVQA_BUILDS_PART(5)
VIVQA_PAIR(__half, 128)
#endif
#if VIVQA_BUILDS_PART(6)
VIVQA_PAIR(float, 32)
VIVQA_PAIR(float, 64)
VIVQA_PAIR(float, 128)
#endif
#if defined(VIVQA_PART) && VIVQA_PART > 6
#error "flash_attn_fwd.cu has kernel parts 1-6 (ops/cuda_build.py: PARTS)"
#endif
#endif  // VIVQA_BUILDS_KERNELS

}  // namespace vivqa::fwd

#if VIVQA_BUILDS_ENTRY
namespace {

template <typename T>
int serve(const Params& p, int head_dim, int tile_rows, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return fwd::serve_pair<T, 32>(p, tile_rows, stream);
    case 64:
      return fwd::serve_pair<T, 64>(p, tile_rows, stream);
    case 128:
      return fwd::serve_pair<T, 128>(p, tile_rows, stream);
    default:
      return -1;
  }
}

template <typename T>
int train(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return fwd::train_pair<T, 32>(p, stream);
    case 64:
      return fwd::train_pair<T, 64>(p, stream);
    case 128:
      return fwd::train_pair<T, 128>(p, stream);
    default:
      return -1;
  }
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


}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// strides: 15 element strides, in order q (b, h, l), k (b, h, l),
// v (b, h, l), o (b, h, l), mask (b, q, k); the mask's are ignored when
// mask is null. vec = 1 promises that q, k and v and all their b/h/l
// strides are 16-byte aligned, so tiles load as 16-byte vectors.
// tile_rows: query rows a block of the tensor-core template (bf16, f16)
// takes, 16, 32 or 64; f32 takes the SIMT template and ignores it.
// Returns cudaGetLastError() after the launch, or -1 for a head dim,
// dtype or tile_rows this file was not built for.
extern "C" int vivqa_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* mask, int dtype, int head_dim, int B, int H,
                                    int Lq, int Lk, const long long* strides, int causal,
                                    int vec, float scale, int tile_rows, void* stream) {
  const Params p = make_params(q, k, v, o, mask, B, H, Lq, Lk, strides, causal, vec, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return serve<float>(p, head_dim, tile_rows, s);  // SIMT: no TF32 rounding
    case 1:
      return serve<__nv_bfloat16>(p, head_dim, tile_rows, s);
    case 2:
      return serve<__half>(p, head_dim, tile_rows, s);
    default:
      return -1;
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return train<float>(p, head_dim, s);  // SIMT: no TF32 rounding
    case 1:
      return train<__nv_bfloat16>(p, head_dim, s);
    case 2:
      return train<__half>(p, head_dim, s);
    default:
      return -1;
  }
}
#endif  // VIVQA_BUILDS_ENTRY
