// Attention backward, dK/dV pass, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel vivqa_tpu/ops/flash_attention.py:
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
// Like the forward it takes ragged Lq and Lk, head dim 32, 64 or 128, f32 /
// bf16 / f16, operands by (b, h, l) strides, and the boolean mask by
// (b, q, k) strides with stride-0 broadcast, plus causal. A fully masked
// row has m = -1e30 and l = Lk, so p = 1/Lk for every key: it still feeds
// dV, while its dS is 0. Causal query tiles are skipped only where every
// row has a key and none reaches this key tile (then p = 0 exactly); the
// Pallas kernel's skip also drops rows with no key at all, which owe dV
// their 1/Lk share (ROADMAP.md, Queue C).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 132 SMs, 227
// KB of shared memory a block, 64K registers an SM): at the model's shapes
// (head dim 64, L <= 64) one call reads q, k, v, dO, m, l, delta and
// writes dK and dV, and does 8*B*H*Lq*Lk*D flops: ~2 flops per byte, so
// the bytes bind: 0.656 ms for the 36 calls of bench.py's step at batch
// 128 (chip_smoke.py).
//
// Two templates, chosen by dtype alone (a failed build or launch raises):
// f32 takes the SIMT template (flash_attn_bwd_dkv_kernel), since
// tensor-core products of f32 inputs round to TF32, outside the f32
// tolerance; bf16 and f16, the model's path, take the tensor-core template
// (flash_attn_bwd_dkv_mma_kernel).
//
// SIMT design (f32): one block of 4 warps per (batch*head, 32-key tile);
// each warp owns 8 keys and keeps their dK and dV in registers (lane =
// D/32 columns). The K/V tile is staged once as f32 in shared memory; Q
// and dO tiles of 32 rows stream through it, the next one requested before
// the current one is used (Q and dO rows padded by one word, so the lanes'
// row reads hit distinct banks). In the score step lane i computes s and
// dP of query row i against the warp's 8 keys; p z and dS then stay in
// registers and are broadcast by shuffles into the dV and dK updates.
//
// Tensor-core design (bf16/f16), from the SIMT template's measured faults
// (6.205 ms per step at batch 128 against SDPA's whole backward, 3.439 ms;
// 150 registers; chip_smoke.py): K/V and Q/dO staged as f32 (twice the
// bytes and stores), two shared-memory loads per FMA pair in the score
// loop, two shuffles per 2 D/32 FMAs in the dV/dK update, and 32-key
// blocks that read a head's Q and dO twice at L = 64.
//   - One block of 4 warps per (batch*head, 64 keys); each warp owns 16
//     keys and keeps their dK and dV as f32 accumulators (D/4 floats each
//     a thread). At L <= 64 a block holds a whole head, so Q and dO leave
//     device memory once per (b, h): 1,536 blocks for the 12-head calls at
//     batch 128.
//   - K and V are staged once by 16-byte cp.async in their own dtype (rows
//     padded to D + 8, ldmatrix conflict free; element loads for rows that
//     do not start on 16 bytes). Q and dO stream through in 64-row tiles,
//     two buffers when Lq > 64, the next tile requested while this one is
//     used. Each tile's per-query m, 1/l, delta and dropout row hash are
//     staged in shared memory as one 16-byte record, so a query costs one
//     load and its hash is computed once, not once per key; so is the
//     tile's 64 x 64 block of the mask, by 16-byte copies where its rows
//     allow, and a call without a mask runs an instantiation with no mask
//     code at all.
//   - Transposed products, keys as rows and queries as columns: S^T = K Q^T
//     and dP^T = V dO^T by mma.sync m16n8k16 into f32 (the warp's 16 K or
//     V rows as A, the Q or dO tile as B), each 64-query tile in four
//     steps of 16 queries, which keeps S^T, dP^T and both accumulators in
//     the 128 registers of 4 blocks an SM at D = 64 (steps of 32 spill
//     there; tools/attention_variants.py times the alternatives).
//   - p = exp(s - m) * (1 / l), dS = p (dP z - delta), 0 where masked, with
//     the rules applied at the fragment's (key = row, query = column)
//     coordinates. p z and dS are rounded to the input dtype as the A
//     operands of dV += (p z)^T dO and dK += dS^T Q in registers (the
//     plain version keeps both in f32: ROADMAP.md, Queue C), with dO and Q
//     through ldmatrix.trans.
//   - S^T through K Q^T is not S = Q K^T of the forward bit for bit: the
//     tensor core may add the same 16 products in another order, so s, and
//     exp(s - m) against the forward's m, can differ in the last f32 ulp
//     (p may exceed 1 / l by ~1e-7 relative). That is 2^-16 of the bf16
//     rounding p z and dS take next, so it cannot show in dK or dV.
//   - dK (times 1/sqrt(D)) and dV are written through the warp's own 16
//     rows of the staged K and V with 16-byte stores; no other warp reads
//     those rows.
// No atomics in either template: every dK/dV element has one owner, so
// the result is deterministic.

#include "flash_attn_mma.cuh"

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

// The per-query values a tile of the dK/dV pass reads, staged once a tile
struct __align__(16) QueryStat {
  float m;
  float inv_l;
  float delta;
  uint32_t hash;  // Dropout::row(qi)
};

// The stats of query qi; a query past Lq reads as m = 0, 1/l = 0, so its
// p is exactly 0 (its Q and dO rows are 0, so s = 0)
__device__ __forceinline__ QueryStat query_stat(const BwdParams& p, long long stat0, int qi) {
  if (qi >= p.Lq) return QueryStat{0.f, 0.f, 0.f, 0u};
  return QueryStat{p.m[stat0 + qi], 1.f / p.l[stat0 + qi], p.delta[stat0 + qi], p.drop.row(qi)};
}

// The dK/dV pass on the tensor cores (bf16 / f16), 4 blocks an SM at
// D = 64 in 128 registers, 2 at D = 128. kMask: the call has a
// mask, whose (64 x 64)-byte tile for each query tile is staged in shared
// memory with the Q/dO tile (16-byte copies when mask_vec); without one
// the mask code is not compiled in. io_vec bit 0: dk's rows start on 16
// bytes; bit 1: dv's do. smem: K, V, then Q and dO of buffer 0 (and of
// buffer 1 when Lq > 64), then a QueryStat per query of each buffer, then
// the mask tile of each buffer.
template <typename T, int D, bool kMask>
__global__ void __launch_bounds__(mma::kThreads, D == 64 ? 4 : 2)
    flash_attn_bwd_dkv_mma_kernel(BwdParams p, int io_vec, int mask_vec) {
  using namespace mma;
  constexpr int QS = 16;  // queries a step
  constexpr int P = pitch<D>();
  constexpr int TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + TE;
  const int nbuf = p.Lq > kTileRows ? 2 : 1;
  QueryStat* sStat = reinterpret_cast<QueryStat*>(sK + (2 + 2 * nbuf) * TE);
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sStat + nbuf * kTileRows);

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * kTileRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  // the rules without the mask, which is read from its staged tile
  const KeyRule rule{nullptr, 0, 0, p.Lq, p.Lk, p.Lk - p.Lq, p.causal};
  const uint8_t* mask = kMask ? p.mask + b * p.m_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Lq;

  // Causal, unmasked: a query tile contributes nothing to this key tile
  // when its first row has a key and its last row's diagonal ends before
  // the tile's first key. Only a prefix [0, q_begin) of such tiles is
  // skipped, so a leading tile with keyless rows (Lq > Lk) stops the skip.
  int q_begin = 0;
  if (p.causal && !kMask) {
    while (q_begin < p.Lq && rule.q_offset + q_begin >= 0 &&
           rule.q_offset + min(q_begin + kTileRows, p.Lq) - 1 < k0)
      q_begin += kTileRows;
  }
  const int n_tiles = (p.Lq - q_begin + kTileRows - 1) / kTileRows;

  load_tile<T, D>(sK, k, p.k_sl, k0, p.Lk, p.vec);
  load_tile<T, D>(sV, v, p.v_sl, k0, p.Lk, p.vec);
  load_tile<T, D>(sV + TE, q, p.q_sl, q_begin, p.Lq, p.vec);
  load_tile<T, D>(sV + 2 * TE, dout, p.do_sl, q_begin, p.Lq, p.vec);
  if (kMask)
    load_mask_tile<kTileRows, mma::kThreads, true>(sMask, mask, p.m_sq, p.m_sk, q_begin, p.Lq,
                                                   k0, p.Lk, mask_vec);
  cp_async_commit();
  if (threadIdx.x < kTileRows) sStat[threadIdx.x] = query_stat(p, stat0, q_begin + threadIdx.x);

  const T* sKw = sK + warp * 16 * P;  // the warp's 16 keys
  const T* sVw = sV + warp * 16 * P;
  const int kj[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kTileRows;
    cp_async_wait_all();
    __syncthreads();  // tile it and its stats are in; every warp is done with tile it - 1
    const bool more = it + 1 < n_tiles;
    if (more) {  // the next tile's copies run while this one is used
      T* nxt = sV + (1 + 2 * ((it + 1) & 1)) * TE;
      load_tile<T, D>(nxt, q, p.q_sl, q0 + kTileRows, p.Lq, p.vec);
      load_tile<T, D>(nxt + TE, dout, p.do_sl, q0 + kTileRows, p.Lq, p.vec);
      if (kMask)
        load_mask_tile<kTileRows, mma::kThreads, true>(
            sMask + ((it + 1) & 1) * kTileRows * kMaskPitch, mask, p.m_sq, p.m_sk,
            q0 + kTileRows, p.Lq, k0, p.Lk, mask_vec);
      cp_async_commit();
    }
    const T* sQ = sV + (1 + 2 * (it & 1)) * TE;
    const T* sdO = sQ + TE;
    const QueryStat* stat = sStat + (it & 1) * kTileRows;
    const uint8_t* sM = sMask + (it & 1) * kTileRows * kMaskPitch + warp * 16;  // the warp's keys

    // the tile in steps of QS queries
#pragma unroll
    for (int s0 = 0; s0 < kTileRows; s0 += QS) {
      if (q0 + s0 >= p.Lq) break;
      float s[QS / 8][4], dp[QS / 8][4];
#pragma unroll
      for (int j = 0; j < QS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      gemm_abt<T, D, QS / 8>(s, sKw, sQ + s0 * P, lane);
      gemm_abt<T, D, QS / 8>(dp, sVw, sdO + s0 * P, lane);

      // element (j, e): key kj[e / 2], query q0 + s0 + 8j + 2t + e % 2
#pragma unroll
      for (int j = 0; j < QS / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = s0 + 8 * j + 2 * t + c;
          const QueryStat st = stat[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const KeyState ks =
                rule.state(q0 + col, kj[r], !kMask || sM[col * kMaskPitch + g + 8 * r] != 0);
            float pz = 0.f, ds = 0.f;
            if (ks != kPastEnd) {
              // a fully masked row (m = -1e30) gives p = 1/Lk at every key
              const float pr =
                  expf((ks == kKept ? s[j][e] * p.scale : kMasked) - st.m) * st.inv_l;
              const float z = p.drop.on ? p.drop.scale(st.hash, kj[r]) : 1.f;
              pz = pr * z;
              if (ks == kKept) ds = pr * (dp[j][e] * z - st.delta);  // 0 where masked
            }
            s[j][e] = pz;
            dp[j][e] = ds;
          }
        }

      uint32_t a[QS / 16][4];
      to_a_frags<T, QS / 8>(a, s);  // (p z)^T rounded to T: the operand of dV
      gemm_ab<T, D, QS / 16>(dv_acc, a, sdO + s0 * P, lane);
      to_a_frags<T, QS / 8>(a, dp);  // dS^T rounded to T: the operand of dK
      gemm_ab<T, D, QS / 16>(dk_acc, a, sQ + s0 * P, lane);
    }
    // every warp is past this iteration's barrier, so none still reads the
    // stats of tile it - 1, whose buffer the next tile's stats take
    if (more && threadIdx.x < kTileRows)
      sStat[((it + 1) & 1) * kTileRows + threadIdx.x] =
          query_stat(p, stat0, q0 + kTileRows + threadIdx.x);
  }

  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  store_rows<T, D>(sK + warp * 16 * P, dk_acc, p.scale, p.scale, dk, p.dk_sl, k0 + warp * 16,
                   p.Lk, lane, io_vec & 1);
  store_rows<T, D>(sV + warp * 16 * P, dv_acc, 1.f, 1.f, dv, p.dv_sl, k0 + warp * 16, p.Lk,
                   lane, io_vec >> 1);
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

template <typename T, int D, bool kMask>
int launch_mma_dm(const BwdParams& p, cudaStream_t stream) {
  const int nbuf = p.Lq > mma::kTileRows ? 2 : 1;
  const int bytes = (2 + 2 * nbuf) * mma::tile_elems<D>() * static_cast<int>(sizeof(T)) +
                    nbuf * mma::kTileRows * static_cast<int>(sizeof(QueryStat)) +
                    (kMask ? nbuf * mma::kTileRows * mma::kMaskPitch : 0);
  const int err = allow_smem(flash_attn_bwd_dkv_mma_kernel<T, D, kMask>, bytes);
  if (err != 0) return err;
  const dim3 grid((p.Lk + mma::kTileRows - 1) / mma::kTileRows, p.B * p.H);
  const int io_vec = mma::rows_aligned16(p.dk, p.dk_sb, p.dk_sh, p.dk_sl) |
                     mma::rows_aligned16(p.dv, p.dv_sb, p.dv_sh, p.dv_sl) << 1;
  const int mask_vec = mma::mask_rows_aligned16(p.mask, p.m_sb, p.m_sq, p.m_sk);
  flash_attn_bwd_dkv_mma_kernel<T, D, kMask>
      <<<grid, mma::kThreads, bytes, stream>>>(p, io_vec, mask_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_mma_d(const BwdParams& p, cudaStream_t stream) {
  return p.mask != nullptr ? launch_mma_dm<T, D, true>(p, stream)
                           : launch_mma_dm<T, D, false>(p, stream);
}

// SIMT for f32, tensor cores for the 16-bit types
template <typename T, int D>
int launch_any(const BwdParams& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_mma_d<T, D>(p, stream);
  } else {
    return launch_d<T, D>(p, stream);
  }
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
  return launch_any<T, D>(p, stream);
}

// The pairs of head dim D, in f32, bf16 and f16: part 1 builds D = 32,
// part 2 D = 64, part 3 D = 128.
#define VIVQA_PAIRS_OF(D)                                                      \
  template int launch_pair<float, D>(const BwdParams&, cudaStream_t);          \
  template int launch_pair<__nv_bfloat16, D>(const BwdParams&, cudaStream_t);  \
  template int launch_pair<__half, D>(const BwdParams&, cudaStream_t);
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
    case 1:
      return launch<__nv_bfloat16>(p, head_dim, s);
    case 2:
      return launch<__half>(p, head_dim, s);
    default:
      return -1;
  }
}
#endif  // VIVQA_BUILDS_ENTRY
