// Attention backward, dQ pass, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel vivqa_tpu/ops/flash_attention.py:
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
// Like the forward it takes ragged Lq and Lk, head dim 32, 64 or 128, f32 /
// bf16 / f16, operands by (b, h, l) strides, and the boolean mask by
// (b, q, k) strides with stride-0 broadcast, plus causal. A fully masked
// row (every key scored -1e30) has m = -1e30 and l = Lk, so p = 1/Lk per
// key, and dS is 0 at every masked entry: exactly jax.vjp through
// jnp.where(mask, logits, -1e30). Keys past Lk contribute nothing. The
// only skip is the forward's: a causal, unmasked query tile whose first
// row has a key stops at its last row's diagonal (the keys beyond have
// p = 0 exactly); the Pallas dq kernel's skip also drops K blocks that
// rows with no key at all still owe (ROADMAP.md, Queue C).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 132 SMs, 227
// KB of shared memory a block, 64K registers an SM): at the model's shapes
// (head dim 64, L <= 64) one call reads q, k, v, o, dO, m, l and writes dQ
// and delta, and does 8*B*H*Lq*Lk*D flops (s, dP, dQ, and delta): ~2
// flops per byte, so the bytes bind: 0.651 ms for the 36 calls of
// bench.py's step at batch 128 (chip_smoke.py).
//
// Two templates, chosen by dtype alone (a failed build or launch raises):
// f32 takes the SIMT template (flash_attn_bwd_dq_kernel), since tensor-core
// products of f32 inputs round to TF32, outside the f32 tolerance; bf16
// and f16, the model's path, take the tensor-core template
// (flash_attn_bwd_dq_mma_kernel).
//
// SIMT design (f32): one block of 4 warps per (batch*head, 32-query tile);
// each warp owns 8 query rows and keeps their dQ in registers (lane = D/32
// columns). Q and dO tiles are staged once as f32 in shared memory; K/V
// tiles of 32 keys stream through it, the next one requested before the
// current one is used (K and V rows padded by one word). Lane j computes s
// and dP for key j and the warp's 8 rows; dS then stays in registers and is
// broadcast by shuffles into the dQ update.
//
// Tensor-core design (bf16/f16), from the SIMT template's measured faults
// (7.33 ms per step at batch 128 against SDPA's whole backward, 3.48 ms;
// 242 registers a thread, so 8 warps an SM; chip_smoke.py): per key two
// shared loads per lane and 16 broadcast loads for 16 FMAs in the score
// and dP loop, one shuffle per FMA pair in dS.K, tiles staged as f32, and
// 32-row blocks that read a head's K and V twice.
//   - One block of 4 warps per (batch*head, 64 query rows); each warp owns
//     16 rows. At L <= 64 K and V leave device memory once per (b, h).
//     Longer keys loop over 64-key tiles, the next K/V tile copied while
//     this one is used.
//   - q, dO, k, v are copied into shared memory by 16-byte cp.async in
//     their own dtype (rows padded to D + 8 elements, ldmatrix conflict
//     free; element loads for rows that do not start on 16 bytes).
//   - Each 64-key tile is taken in two steps of 32 keys, which keeps s, dP
//     and the dQ accumulators in 128 registers (4 blocks an SM).
//   - S = Q K^T and dP = dO V^T by mma.sync m16n8k16 into f32, S through
//     the same function as the forward, so the forward's m bounds it bit
//     for bit. p = exp(s - m) * (1 / l) from the forward's stats.
//   - delta = rowsum(dO o) from the staged dO and o read once, by a pair
//     of lanes per row; the quads that hold a row take it by shuffles.
//   - dS = p (dP z - delta), 0 where masked, rounded to the input dtype as
//     the A operand of dS.K in registers (the plain version keeps dS in
//     f32: ROADMAP.md, Queue C), then dQ += dS K by mma with K through
//     ldmatrix.trans: 16 x D f32 accumulators per warp, D/4 a thread.
//   - dq is written through the warp's own Q rows with 16-byte stores.
// No atomics: every dQ element has one owner, so the result is
// deterministic.

#include "flash_attn_mma.cuh"

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

// The dQ pass on the tensor cores (bf16 / f16). io_vec bit 0: o's rows
// start on 16 bytes; bit 1: dq's do. It walks each 64-key tile in steps of
// KS = 32 keys, so s, dP and dQ fit in 128 registers at D = 64, 4 blocks
// an SM (64-key steps need 168 registers, 3 blocks an SM, and ran slower
// on the H100). D = 128 takes 2 blocks, without spills.
template <typename T, int D>
__global__ void __launch_bounds__(mma::kThreads, D == 64 ? 4 : 2)
    flash_attn_bwd_dq_mma_kernel(BwdParams p, int io_vec) {
  using namespace mma;
  constexpr int KS = 32;
  constexpr int P = pitch<D>();
  constexpr int TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + TE;  // then K, V of buffer 0, then of buffer 1

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kTileRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const KeyRule rule{p.mask ? p.mask + b * p.m_sb : nullptr, p.m_sq, p.m_sk, p.Lq, p.Lk,
                     p.Lk - p.Lq, p.causal};
  const long long stat0 = static_cast<long long>(bh) * p.Lq;
  const int k_end = causal_key_end(rule, q0);  // the forward's skip
  const int n_tiles = (k_end + kTileRows - 1) / kTileRows;

  load_tile<T, D>(sQ, q, p.q_sl, q0, p.Lq, p.vec);
  load_tile<T, D>(sdO, dout, p.do_sl, q0, p.Lq, p.vec);
  load_tile<T, D>(sQ + 2 * TE, k, p.k_sl, 0, p.Lk, p.vec);
  load_tile<T, D>(sQ + 3 * TE, v, p.v_sl, 0, p.Lk, p.vec);
  cp_async_commit();

  const int qi[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint32_t row_hash[2] = {p.drop.row(qi[0]), p.drop.row(qi[1])};
  float m[2] = {0.f, 0.f}, inv_l[2] = {1.f, 1.f}, delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] < p.Lq) {
      m[r] = p.m[stat0 + qi[r]];
      inv_l[r] = 1.f / p.l[stat0 + qi[r]];
    }
  }

  cp_async_wait_all();
  __syncthreads();
  {  // delta = rowsum(dO * O): lanes 2r and 2r + 1 sum the halves of row r
    const int r = lane >> 1, c0 = (lane & 1) * (D / 2);
    const int qr = q0 + warp * 16 + r;
    float part = 0.f;
    if (qr < p.Lq) {
      const T* orow = o + qr * p.o_sl + c0;
      const T* drow = sdO + (warp * 16 + r) * P + c0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        uint4 ov;
        T* oe = reinterpret_cast<T*>(&ov);
        if (io_vec & 1) {
          ov = __ldg(reinterpret_cast<const uint4*>(orow + c));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) oe[j] = orow[c + j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) part = fmaf(to_f32(drow[c + j]), to_f32(oe[j]), part);
      }
    }
    part += __shfl_xor_sync(kFull, part, 1);
    if ((lane & 1) == 0 && qr < p.Lq) p.delta[stat0 + qr] = part;
    delta[0] = __shfl_sync(kFull, part, 2 * g);        // row g
    delta[1] = __shfl_sync(kFull, part, 2 * (g + 8));  // row g + 8
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    }
    if (kt + 1 < n_tiles) {
      T* nxt = sQ + (2 + 2 * ((kt + 1) & 1)) * TE;
      load_tile<T, D>(nxt, k, p.k_sl, (kt + 1) * kTileRows, p.Lk, p.vec);
      load_tile<T, D>(nxt + TE, v, p.v_sl, (kt + 1) * kTileRows, p.Lk, p.vec);
      cp_async_commit();
    }
    const T* sK = sQ + (2 + 2 * (kt & 1)) * TE;
    const T* sV = sK + TE;

    // the tile in steps of KS keys
#pragma unroll
    for (int k0 = kt * kTileRows; k0 < (kt + 1) * kTileRows; k0 += KS) {
      if (k0 >= k_end) break;
      const T* sKs = sK + (k0 - kt * kTileRows) * P;
      const T* sVs = sV + (k0 - kt * kTileRows) * P;
      float s[KS / 8][4], dp[KS / 8][4];
#pragma unroll
      for (int j = 0; j < KS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      gemm_abt<T, D, KS / 8>(s, sQ + warp * 16 * P, sKs, lane);
      gemm_abt<T, D, KS / 8>(dp, sdO + warp * 16 * P, sVs, lane);

      // element (j, e): row qi[e / 2], key k0 + 8j + 2t + e % 2
#pragma unroll
      for (int j = 0; j < KS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, kj = k0 + 8 * j + 2 * t + (e & 1);
          float ds = 0.f;
          if (qi[r] < p.Lq && rule(qi[r], kj) == kKept) {  // dS is 0 where masked
            const float pr = expf(s[j][e] * p.scale - m[r]) * inv_l[r];
            const float z = p.drop.on ? p.drop.scale(row_hash[r], kj) : 1.f;
            ds = pr * (dp[j][e] * z - delta[r]);
          }
          s[j][e] = ds;
        }

      uint32_t a[KS / 16][4];
      to_a_frags<T, KS / 8>(a, s);  // dS rounded to T: the operand of dS.K
      gemm_ab<T, D, KS / 16>(acc, a, sKs, lane);
    }
  }

  store_rows<T, D>(sQ + warp * 16 * P, acc, p.scale, p.scale, dq, p.dq_sl, q0 + warp * 16,
                   p.Lq, lane, io_vec >> 1);
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

template <typename T, int D>
int launch_mma_d(const BwdParams& p, cudaStream_t stream) {
  const int bytes = mma::smem_bytes<T, D>(2 * mma::kTileRows, p.Lk);
  const int err = allow_smem(flash_attn_bwd_dq_mma_kernel<T, D>, bytes);
  if (err != 0) return err;
  const dim3 grid((p.Lq + mma::kTileRows - 1) / mma::kTileRows, p.B * p.H);
  const int io_vec = mma::rows_aligned16(p.o, p.o_sb, p.o_sh, p.o_sl) |
                     mma::rows_aligned16(p.dq, p.dq_sb, p.dq_sh, p.dq_sl) << 1;
  flash_attn_bwd_dq_mma_kernel<T, D><<<grid, mma::kThreads, bytes, stream>>>(p, io_vec);
  return static_cast<int>(cudaGetLastError());
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

template <typename T>
int launch(const BwdParams& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_any<T, 32>(p, stream);
    case 64:
      return launch_any<T, 64>(p, stream);
    case 128:
      return launch_any<T, 128>(p, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Pointers q, k, v, o, dO
// (dtype), m, l (f32, (B*H, Lq) contiguous), delta (f32 out, same shape),
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
    case 1:
      return launch<__nv_bfloat16>(p, head_dim, s);
    case 2:
      return launch<__half>(p, head_dim, s);
    default:
      return -1;
  }
}
