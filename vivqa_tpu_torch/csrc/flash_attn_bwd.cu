// Attention backward in one pass for Hopper (sm_90a), plain C interface:
// dQ, dK and dV from one kernel whose tiles come and go by the Tensor
// Memory Accelerator.
//
// Replaces both Pallas TPU kernels of the backward,
// vivqa_tpu/ops/flash_attention.py: _flash_bwd_dkv_kernel (:230,
// pallas_call at :351) and _flash_bwd_dq_kernel (:285, pallas_call at
// :377), with the delta pre-pass _flash_backward leaves to XLA (:336-338).
// For each (query tile, key tile) pair of a head it computes once
//   s = (q . k) / sqrt(D)  (-1e30 where masked),  p = exp(s - m) / l,
//   dP = (dO . v) z,  dS = p (dP - delta)  (0 where masked),
// and feeds dV += (p z)^T dO, dK += dS^T Q / sqrt(D), dQ += dS K / sqrt(D),
// where m and l are the forward's separate f32 stats, z = keep / (1 - rate)
// is the attention-dropout multiplier (the forward's hash,
// flash_attn_common.cuh) and delta = rowsum(dO * O). Same rules as the pair
// it replaces: ragged Lq and Lk, head dim 32, 64 or 128, bf16 or f16,
// operands by (b, h, l) strides, the boolean mask by (b, q, k) strides with
// stride-0 broadcast, causal with the diagonal at the end of the keys. A
// fully masked row (m = -1e30, l = Lk) has p = 1/Lk at every key and feeds
// dV, while its dS is 0. Nothing is skipped where p is not exactly 0 (the
// only skip is the long form's causal prefix below; ROADMAP.md, Queue C,
// for the Pallas kernels' skips that drop keyless rows). p z and dS are
// rounded to the input dtype as product operands (dS once, used by both dK
// and dQ); every sum is f32. f32 inputs stay on the SIMT templates of
// flash_attn_bwd_dq.cu and flash_attn_bwd_dkv.cu.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): 10 D flops per
// (query, key) pair against about 16 D bytes of q, k, v, o, dO, dq, dk and
// dv per head row, a few flops a byte against the card's ridge of ~295, so
// the bytes bind: 0.864 ms for the 36 calls of bench.py's step at batch
// 128 if each byte moves once (chip_smoke.py: train_attention_work), where
// the pair this kernel replaces moved q, k, v, dO, m and l twice, wrote
// and reread delta, and computed s and dP twice (its two bounds add up to
// 1.287 ms).
//
// Design, against the pair's three faults:
//   - Every byte moved and every score computed twice: one pass. A unit's
//     consumer warps compute s, p, dP and dS once per pair; delta comes
//     from the staged O and dO tiles and is never written out.
//     - Lq, Lk <= 128 (the model's shapes: 49, 50, 64, 113, 115, 118): a
//       unit is one (b, h), with one consumer warpgroup per 64-key tile
//       (NKT = 1 or 2); it owns every dq, dk and dv row it writes, and dQ
//       sums the key tiles' dS K in key-tile order from the dS tile in
//       shared memory.
//     - Otherwise (the long form: 197, 784, 1,024, 1,370 keys): a unit is
//       one (b, h, 64-key tile) walking every query tile, dK and dV in
//       registers; it writes its dQ partial in f32 to a scratch (key
//       tiles, B, H, Lq, D) that flash_attn_bwd_sum_kernel adds in key-tile
//       order: two launches a call. q, o and dO are then read once per key
//       tile (from L2 mostly).
//     No atomics: every output element has one owner or a fixed order of
//     summation, so two calls are bit-equal.
//   - Loads and math that did not overlap: TMA into a ring. One producer
//     warp walks the block's units ahead of the consumers: the unit's K
//     and V into one of kSlots slots, each 64-query tile's Q, dO and O
//     into one of kRingN stages, by cp.async.bulk.tensor over the
//     (B, L, H, D) storage in 64-row boxes (zero fill past L covers the
//     ragged rows; D = 128 rows take two 64-column boxes) under the 128-byte
//     swizzle (64-byte at D = 32), each completing on an mbarrier. The
//     stats (m, l: f32 rows not 16-byte aligned) and the stage's mask bytes
//     go by cp.async from the same warp, which does not wait for them:
//     their arrival on the stage's barrier fires when they land. A mask
//     row that does not start on 16 bytes is copied by 4-byte words at its
//     own shift, its head and tail bytes loaded; no byte past Lk is read.
//     The outputs go back the same way: the consumers leave a dq tile in
//     the stage's spent O tile and dk, dv in the unit's K and V tiles, and
//     the producer stores them by TMA (rows past L are not written) before
//     it loads the stage or slot again. Sizes (Cfg, pick()) at D = 64:
//     one-warpgroup units (the flagship's shapes) 2 stages of 25-31 KB and
//     2 K/V slots of 16 KB, 94-104 KB a block, 2 blocks an SM;
//     two-warpgroup units 2 and 2, 134-152 KB, 1 block an SM.
//   - Long key runs walked by one block: persistent blocks, min(units,
//     SMs x blocks an SM), walking the units in order (u, u + grid, ...);
//     the long form's units split the keys over blocks. Blocks an SM:
//     kBlocksPerSM (2) for one-warpgroup units where the shared memory
//     allows it, else 1 (two-warpgroup units keep their registers).
//   - Products on mma.sync m16n8k16 (flash_attn_mma.cuh), keys as rows as
//     the dK/dV template had them: S^T = K Q^T and dP^T = V dO^T with the
//     warp's 16 K or V rows as A, the 64-query tile in steps of 16 queries;
//     p z and dS^T are repacked in registers as the A operands of dV and dK.
//     S^T through K Q^T may add the same products in another order than
//     the forward's Q K^T, so p may exceed 1 / l by ~1e-7 relative: 2^-16
//     of the bf16 rounding p z and dS take next.
//     dS goes through shared memory once, for dQ = dS K (A from the dS tile,
//     K by ldmatrix.trans). Every ldmatrix address goes through the swizzle
//     (sw()), so the TMA-staged rows are read without bank conflicts.
//     wgmma was not taken here: tools/attention_variants.py's timing-only
//     variants put the data movement alone (loads, stores, no products)
//     at two thirds of the flagship step's time on the card and the
//     products with their barriers at the rest (PERF.md, Findings); whether
//     wgmma's asynchrony would hide that third is open (ROADMAP.md,
//     Queue B).
//
// The ring, slots and blocks an SM are the constants below;
// tools/attention_variants.py builds this source with other values.

#include "flash_attn_tma.cuh"

namespace vivqa {
namespace bwd {

using namespace tma;
using mma::KeyRule;
using mma::KeyState;
using mma::kKept;
using mma::kPastEnd;

constexpr int kRows = 64;          // rows of a box, a tile and a consumer warpgroup's keys
constexpr int kRing = 2;           // query-tile stages aimed for
constexpr int kBlocksPerSM = 2;    // aimed for, one-warpgroup units
constexpr int kQS = 16;            // queries a step
constexpr int kSmemPerSM = 233472;     // 228 KB, of which 1 KB is reserved a block
constexpr int kSmemPerBlock = 232448;  // 227 KB

// -- PTX: ldmatrix ---------------------------------------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// acc[j] += A . B^T for rows ra .. ra + 15 of tile tA against rows rb ..
// rb + 8 NT - 1 of tile tB, over D (S^T = K Q^T, dP^T = V dO^T)
template <typename T, int D, int NT>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4], uint32_t tA, int ra, uint32_t tB,
                                         int rb, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, tA + sw<D>(ra + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tB + sw<D>(rb + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
      mma::mma16816<T>(acc[2 * np], a, b[0], b[1]);
      mma::mma16816<T>(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += A . B for A a warp's 16 x 16 operand in registers and B rows
// rb .. rb + 15, columns c0 .. c0 + DC - 1 of tile tB (dV += (p z)^T dO,
// dK += dS^T Q, dQ += dS K)
template <typename T, int D, int DC>
__device__ __forceinline__ void gemm_ab(float (&acc)[DC / 8][4], const uint32_t (&a)[4],
                                        uint32_t tB, int rb, int c0, int lane) {
#pragma unroll
  for (int dp = 0; dp < DC / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(b, tB + sw<D>(rb + (lane & 7) + ((lane >> 3) & 1) * 8,
                            (c0 >> 3) + 2 * dp + (lane >> 4)));
    mma::mma16816<T>(acc[2 * dp], a, b[0], b[1]);
    mma::mma16816<T>(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// The per-query values of a tile, one 16-byte record a query; a query past
// Lq reads as m = 0, 1/l = 0, so its p is exactly 0
struct __align__(16) QueryStat {
  float m;
  float inv_l;
  float delta;
  uint32_t hash;  // Dropout::row(qi)
};

// What every launch of the kernel shares: the eight tensor maps (in the
// kernel's parameter space, __grid_constant__), the pointers, sizes,
// strides and dropout of the pair's BwdParams, and the unit grid.
struct Args {
  CUtensorMap q, k, v, o, dout;  // loads
  CUtensorMap dq, dk, dv;        // stores (dq: the one-pass form)
  BwdParams p;
  float* dq_part;  // long form: (key tiles, B*H, Lq, D) f32
  int n_units, n_qt, n_kt;
  int mask_mode;   // how the mask is staged (kMaskRows16, kMaskWords, kMaskBytes)
};

// The first query tile a long-form unit over keys [key0, key0 + 64) takes:
// causal without a mask, the leading query tiles whose every row has a key
// and whose last row's diagonal ends before key0 have p = 0 exactly at all
// of the unit's keys. A leading tile with a keyless row (Lq > Lk) stops
// the skip. flash_attn_bwd_sum_kernel skips the same partials.
__device__ __forceinline__ int first_query_tile(const BwdParams& p, int key0, bool masked) {
  int q = 0;
  if (p.causal && !masked) {
    const int off = p.Lk - p.Lq;
    while (q < p.Lq && off + q >= 0 && off + min(q + kRows, p.Lq) - 1 < key0) q += kRows;
  }
  return q / kRows;
}

constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// Shared memory of one instantiation (D, NKT key tiles a unit, masked,
// long form): `slots` K/V slots, `ring` query-tile stages (Q, dO, O; the
// stats m, l; the mask tile and its rows' shifts), the dS tile,
// the query records and the barriers, each piece on 1024 bytes (the
// swizzle's period), behind 1024 bytes of alignment slack.
constexpr int tile_bytes(int D) { return kRows * D * 2; }  // one 64-row tile, 16-bit
constexpr int mask_pitch(int nkt) { return nkt * 64 + 16; }  // bytes a staged mask row
constexpr int ds_pitch(int nkt) { return nkt * 64 + 8; }     // elements a dS row
constexpr int kStageTiles = 3;  // Q, dO, O
constexpr int stat_off(int D) { return kStageTiles * tile_bytes(D); }
constexpr int mask_off(int D) { return stat_off(D) + 2 * kRows * 4; }  // after m, l
// then each mask row's shift (a byte a row)
constexpr int shift_off(int D, int nkt) { return mask_off(D) + kRows * mask_pitch(nkt); }
constexpr int stage_bytes(int D, int nkt, bool mask) {
  return round1024(mask ? shift_off(D, nkt) + kRows : mask_off(D));
}
constexpr int kv_bytes(int D, int nkt) { return 2 * nkt * tile_bytes(D); }
constexpr int fixed_bytes(int nkt) {
  return round1024(kRows * ds_pitch(nkt) * 2 + kRows * 16 + 128);
}
constexpr int smem_bytes(int D, int nkt, bool mask, int ring, int slots) {
  return 1024 + slots * kv_bytes(D, nkt) + ring * stage_bytes(D, nkt, mask) + fixed_bytes(nkt);
}
// kBlocksPerSM for one-warpgroup units whose smallest layout fits that
// many blocks, else 1 (two-warpgroup units keep their registers)
constexpr int min_blocks(int D, int nkt, bool mask) {
  return nkt == 1 && smem_bytes(D, nkt, mask, 1, 1) <= kSmemPerSM / kBlocksPerSM - 1024
             ? kBlocksPerSM
             : 1;
}
// the deepest ring (and K/V slots) within a block's share, as ring * 4 + slots
constexpr int pick(int D, int nkt, bool mask, bool lng) {
  const int blocks = min_blocks(D, nkt, mask);
  const int budget = blocks == 1 ? kSmemPerBlock : kSmemPerSM / blocks - 1024;
  for (int r = kRing; r >= 1; --r) {
    const int s = lng ? 2 : (r < 2 ? r : 2);
    if (smem_bytes(D, nkt, mask, r, s) <= budget) return r * 4 + s;
    if (smem_bytes(D, nkt, mask, r, 1) <= budget) return r * 4 + 1;
  }
  return 4 + 1;
}

template <int D, int NKT, bool kMask, bool kLong>
struct Cfg {
  static constexpr int kTile = tile_bytes(D);
  static constexpr int kConsumers = 4 * NKT;  // consumer warps
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kMaskPitch = mask_pitch(NKT);
  static constexpr int kDsPitch = ds_pitch(NKT);
  static constexpr int kStatOff = stat_off(D);
  static constexpr int kMaskOff = mask_off(D);
  static constexpr int kShiftOff = shift_off(D, NKT);
  static constexpr int kStage = stage_bytes(D, NKT, kMask);
  static constexpr int kKv = kv_bytes(D, NKT);
  static constexpr int kMinBlocks = min_blocks(D, NKT, kMask);
  static constexpr int kRingN = pick(D, NKT, kMask, kLong) / 4;
  static constexpr int kSlots = pick(D, NKT, kMask, kLong) % 4;
  static constexpr int kBytes = smem_bytes(D, NKT, kMask, kRingN, kSlots);
  static_assert(kBytes <= kSmemPerBlock, "shared memory of a block");
  // byte offsets from the aligned base
  static constexpr int kRingOff = kSlots * kKv;
  static constexpr int kDsOff = kRingOff + kRingN * kStage;
  static constexpr int kQStatOff = kDsOff + kRows * kDsPitch * 2;
  static constexpr int kBarOff = kQStatOff + kRows * 16;
};

template <typename T, int D, int NKT, bool kMask, bool kLong>
__global__ void __launch_bounds__(Cfg<D, NKT, kMask, kLong>::kThreads,
                                  Cfg<D, NKT, kMask, kLong>::kMinBlocks)
    flash_attn_bwd_kernel(__grid_constant__ const Args a) {
  using C = Cfg<D, NKT, kMask, kLong>;
  static_assert(!kLong || NKT == 1, "a long-form unit is one key tile");
  constexpr int kCT = 32 * C::kConsumers;  // consumer threads
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = mma::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t bars = base + C::kBarOff;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::kRingN + s); };
  auto kv_full = [&](int s) { return bars + 8 * (2 * C::kRingN + s); };
  auto kv_empty = [&](int s) { return bars + 8 * (2 * C::kRingN + C::kSlots + s); };
  const BwdParams& p = a.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kRingN; ++s) {
      mbar_init(full(s), 65);  // the expect_tx arrival, the 32 lanes' stores and copies
      mbar_init(empty(s), C::kConsumers);
    }
    for (int s = 0; s < C::kSlots; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the outputs the consumers leave in spent tiles, stored by TMA: dk and
  // dv of unit u (the block's un-th) from its K/V slot, dq of the block's
  // t-th query tile (one-pass form) from its stage's O tile
  auto store_kv = [&](int u, int un) {
    const int bh = kLong ? u / a.n_kt : u;
    const int key0 = kLong ? (u % a.n_kt) * kRows : 0;
    const uint32_t kv = base + (un % C::kSlots) * C::kKv;
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int c = 0; c < D; c += 64) {
        tma_store(&a.dk, kv + j * C::kTile + c * 128, c, key0 + 64 * j, bh % p.H, bh / p.H);
        tma_store(&a.dv, kv + (NKT + j) * C::kTile + c * 128, c, key0 + 64 * j, bh % p.H,
                  bh / p.H);
      }
  };
  auto store_dq = [&](int t) {
    const int bh = static_cast<int>(blockIdx.x + (t / a.n_qt) * gridDim.x);
    const uint32_t o = base + C::kRingOff + (t % C::kRingN) * C::kStage + 2 * C::kTile;
#pragma unroll
    for (int c = 0; c < D; c += 64)
      tma_store(&a.dq, o + c * 128, c, (t % a.n_qt) * kRows, bh % p.H, bh / p.H);
  };

  if (warp == C::kConsumers) {
    // -- the producer warp: the next units' loads, and the stores of the
    // outputs left in a slot or stage before it is loaded again -------------
    int n = 0;
    int un = 0;
    for (int u = blockIdx.x; u < a.n_units; u += gridDim.x, ++un) {
      const int bh = kLong ? u / a.n_kt : u;
      const int key0 = kLong ? (u % a.n_kt) * kRows : 0;
      const int b = bh / p.H, h = bh % p.H;
      const int slot = un % C::kSlots;
      mbar_wait(kv_empty(slot), ((un / C::kSlots) & 1) ^ 1);
      if (lane == 0) {
        const uint32_t kv = base + slot * C::kKv;
        if (un >= C::kSlots) {  // the slot holds the dk and dv of its last unit
          store_kv(u - C::kSlots * static_cast<int>(gridDim.x), un - C::kSlots);
          bulk_commit();
          bulk_wait_read();
        }
        mbar_arrive_tx(kv_full(slot), C::kKv);
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int c = 0; c < D; c += 64) {
            tma_load(kv + j * C::kTile + c * 128, &a.k, kv_full(slot), c, key0 + 64 * j, h, b);
            tma_load(kv + (NKT + j) * C::kTile + c * 128, &a.v, kv_full(slot), c,
                     key0 + 64 * j, h, b);
          }
      }
      const long long stat0 = static_cast<long long>(bh) * p.Lq;
      const uint8_t* mask = kMask ? p.mask + b * p.m_sb : nullptr;
      for (int qt = kLong ? first_query_tile(p, key0, kMask) : 0; qt < a.n_qt; ++qt, ++n) {
        const int s = n % C::kRingN;
        mbar_wait(empty(s), ((n / C::kRingN) & 1) ^ 1);
        const uint32_t st = base + C::kRingOff + s * C::kStage;
        const int q0 = qt * kRows;
        if (lane == 0) {
          if (!kLong && n >= C::kRingN) {  // the stage's O tile holds a dq tile
            store_dq(n - C::kRingN);
            bulk_commit();
            bulk_wait_read();
          }
          mbar_arrive_tx(full(s), kStageTiles * C::kTile);
#pragma unroll
          for (int c = 0; c < D; c += 64) {
            tma_load(st + c * 128, &a.q, full(s), c, q0, h, b);
            tma_load(st + C::kTile + c * 128, &a.dout, full(s), c, q0, h, b);
            tma_load(st + 2 * C::kTile + c * 128, &a.o, full(s), c, q0, h, b);
          }
        }
        float* stats = reinterpret_cast<float*>(gbase + (st - base) + C::kStatOff);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = lane + 32 * i, qi = q0 + r;
          if (qi < p.Lq) {
            cp_async4(stats + r, p.m + stat0 + qi);
            cp_async4(stats + kRows + r, p.l + stat0 + qi);
          }
        }
        if constexpr (kMask)
          stage_mask<NKT * 64>(gbase + (st - base) + C::kMaskOff,
                               gbase + (st - base) + C::kShiftOff, mask, p.m_sq, p.m_sk, q0,
                               p.Lq, key0, p.Lk, a.mask_mode, lane);
        mbar_arrive(full(s));      // this lane's element stores are done
        cp_async_arrive(full(s));  // and its copies, when they land
      }
    }
    if (lane == 0) {  // the outputs of the last units and query tiles
      for (int i = un > C::kSlots ? un - C::kSlots : 0; i < un; ++i) {
        mbar_wait(kv_empty(i % C::kSlots), (i / C::kSlots) & 1);
        store_kv(static_cast<int>(blockIdx.x + i * gridDim.x), i);
      }
      if (!kLong) {
        for (int i = n > C::kRingN ? n - C::kRingN : 0; i < n; ++i) {
          mbar_wait(empty(i % C::kRingN), (i / C::kRingN) & 1);
          store_dq(i);
        }
      }
      bulk_commit();
      bulk_wait();
    }
    mma::cp_async_wait_all();  // no copy outlives the warp
    return;
  }

  // -- the consumer warps: warpgroup wg takes keys [64 wg, 64 wg + 64) of
  // the unit, warp wq of it 16 of them ------------------------------------
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kl[2] = {64 * wg + 16 * wq + g, 64 * wg + 16 * wq + g + 8};  // unit-local keys
  T* sDS = reinterpret_cast<T*>(gbase + C::kDsOff);
  const uint32_t uDS = base + C::kDsOff;
  QueryStat* sStat = reinterpret_cast<QueryStat*>(gbase + C::kQStatOff);
  const KeyRule rule{nullptr, 0, 0, p.Lq, p.Lk, p.Lk - p.Lq, p.causal};
  constexpr int DC = D / NKT < 64 ? D / NKT : 64;  // dQ columns a job
  constexpr int kJobs = 4 * (D / DC);              // 16-row groups x column chunks
  int n = 0;
  int un = 0;
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x, ++un) {
    const int bh = kLong ? u / a.n_kt : u;
    const int kt = kLong ? u % a.n_kt : 0;
    const int key0 = kt * kRows;
    const int slot = un % C::kSlots;
    mbar_wait(kv_full(slot), (un / C::kSlots) & 1);
    const uint32_t tK0 = base + slot * C::kKv;  // key tile j at tK0 + j * kTile
    const uint32_t tK = tK0 + wg * C::kTile, tV = tK + NKT * C::kTile;
    const int kj[2] = {key0 + kl[0], key0 + kl[1]};
    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

    for (int qt = kLong ? first_query_tile(p, key0, kMask) : 0; qt < a.n_qt; ++qt, ++n) {
      const int s = n % C::kRingN;
      mbar_wait(full(s), (n / C::kRingN) & 1);
      const uint32_t tQ = base + C::kRingOff + s * C::kStage;
      const uint32_t tdO = tQ + C::kTile;
      const unsigned char* gst = gbase + (tQ - base);
      const float* stats = reinterpret_cast<const float*>(gst + C::kStatOff);
      const uint8_t* sM = gst + C::kMaskOff;
      const uint8_t* sShift = gst + C::kShiftOff;
      const int q0 = qt * kRows;

      {  // the tile's query records; delta = rowsum(dO * O), 2 NKT threads a row
        constexpr int TPR = 2 * NKT;
        const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
        constexpr int CPT = D / 8 / TPR;  // 16-byte chunks a thread
        const unsigned char* o = gst + 2 * C::kTile;
        const unsigned char* dout = gst + C::kTile;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          const int off = sw<D>(r, part * CPT + i);
          const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
          const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
          const T* oe = reinterpret_cast<const T*>(&ov);
          const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
          for (int j = 0; j < 8; ++j) d = fmaf(to_f32(de[j]), to_f32(oe[j]), d);
        }
#pragma unroll
        for (int off = 1; off < TPR; off *= 2) d += __shfl_xor_sync(kFull, d, off);
        const int qi = q0 + r;
        if (part == 0)
          sStat[r] = qi < p.Lq ? QueryStat{stats[r], 1.f / stats[kRows + r], d, p.drop.row(qi)}
                               : QueryStat{0.f, 0.f, 0.f, 0u};
      }
      consumer_sync(1, kCT);

      // the tile in steps of kQS queries
#pragma unroll
      for (int s0 = 0; s0 < kRows; s0 += kQS) {
        if (q0 + s0 >= p.Lq) break;
        float sc[kQS / 8][4], dp[kQS / 8][4];
#pragma unroll
        for (int j = 0; j < kQS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
        gemm_abt<T, D, kQS / 8>(sc, tK, 16 * wq, tQ, s0, lane);
        gemm_abt<T, D, kQS / 8>(dp, tV, 16 * wq, tdO, s0, lane);

        // element (j, e): key kj[e / 2], query q0 + s0 + 8j + 2t + e % 2
#pragma unroll
        for (int j = 0; j < kQS / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = s0 + 8 * j + 2 * t + c;
            const QueryStat st = sStat[col];
            const uint8_t* mrow =
                kMask ? sM + col * C::kMaskPitch + (a.mask_mode == kMaskWords ? sShift[col] : 0)
                      : nullptr;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + c;
              const KeyState ks = rule.state(
                  q0 + col, kj[r], !kMask || mrow[kl[r]] != 0);
              float pz = 0.f, ds = 0.f;
              if (ks != kPastEnd) {
                // a fully masked row (m = -1e30) gives p = 1/Lk at every key
                const float pr =
                    expf((ks == kKept ? sc[j][e] * p.scale : kMasked) - st.m) * st.inv_l;
                const float z = p.drop.on ? p.drop.scale(st.hash, kj[r]) : 1.f;
                pz = pr * z;
                if (ks == kKept) ds = pr * (dp[j][e] * z - st.delta);  // 0 where masked
              }
              sc[j][e] = pz;
              dp[j][e] = ds;
              sDS[col * C::kDsPitch + kl[r]] = from_f32<T>(ds);  // dS[q][k], for dQ
            }
          }

        uint32_t af[kQS / 16][4];
        mma::to_a_frags<T, kQS / 8>(af, sc);  // (p z)^T rounded to T: the operand of dV
#pragma unroll
        for (int kc = 0; kc < kQS / 16; ++kc)
          gemm_ab<T, D, D>(dv_acc, af[kc], tdO, s0 + 16 * kc, 0, lane);
        mma::to_a_frags<T, kQS / 8>(af, dp);  // dS^T rounded to T: the operand of dK
#pragma unroll
        for (int kc = 0; kc < kQS / 16; ++kc)
          gemm_ab<T, D, D>(dk_acc, af[kc], tQ, s0 + 16 * kc, 0, lane);
      }
      consumer_sync(2, kCT);  // the tile's dS is complete

      // dQ = dS K over the unit's key tiles in order: 16 rows x DC columns a job
      for (int job = warp; job < kJobs; job += C::kConsumers) {
        const int r0 = 16 * (job & 3), c0 = (job >> 2) * DC;
        if (q0 + r0 >= p.Lq) continue;
        float acc[DC / 8][4];
#pragma unroll
        for (int i = 0; i < DC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t af[4];
            ldsm_x4(af, uDS + 2 * ((r0 + (lane & 15)) * C::kDsPitch + 64 * j + 16 * kk +
                                   (lane >> 4) * 8));
            gemm_ab<T, D, DC>(acc, af, tK0 + j * C::kTile, 16 * kk, c0, lane);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qi = q0 + r0 + g + 8 * r;
          if (qi >= p.Lq) continue;
          if constexpr (kLong) {
            float* dst = a.dq_part + ((static_cast<long long>(kt) * p.B * p.H + bh) * p.Lq + qi) * D + c0;
#pragma unroll
            for (int i = 0; i < DC / 8; ++i)
              *reinterpret_cast<float2*>(dst + 8 * i + 2 * t) =
                  make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
          } else {  // into the stage's spent O tile, for the producer's TMA store
            unsigned char* dst = gbase + (tQ - base) + 2 * C::kTile;
#pragma unroll
            for (int i = 0; i < DC / 8; ++i)
              *reinterpret_cast<uint32_t*>(dst + sw<D>(r0 + g + 8 * r, (c0 >> 3) + i) + 4 * t) =
                  mma::pack2<T>(acc[i][2 * r] * p.scale, acc[i][2 * r + 1] * p.scale);
          }
        }
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
    }
    consumer_sync(3, kCT);  // every warp's dQ is done with K

    // dK (times 1/sqrt(D)) and dV of the warp's 16 keys, over its K and V
    // rows, for the producer's TMA store (rows past Lk are not stored)
    unsigned char* sK = gbase + (tK - base);
    unsigned char* sV = gbase + (tV - base);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int off = sw<D>(16 * wq + g + 8 * r, i) + 4 * t;
        *reinterpret_cast<uint32_t*>(sK + off) =
            mma::pack2<T>(dk_acc[i][2 * r] * p.scale, dk_acc[i][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(sV + off) =
            mma::pack2<T>(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty(slot));  // this warp is done with the slot
  }
}

// The long form's sum: dq = (sum of the key tiles' f32 partials, in
// key-tile order) / sqrt(D), rounded once; 8 columns a thread. A partial a
// unit skipped (first_query_tile) is not read.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_attn_bwd_sum_kernel(const BwdParams p, const float* part, int n_kt) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rows = static_cast<long long>(p.B) * p.H * p.Lq;
  const long long row = idx / (D / 8);
  if (row >= rows) return;
  const int c = static_cast<int>(idx % (D / 8)) * 8;
  const int qi = static_cast<int>(row % p.Lq);
  const int bh = static_cast<int>(row / p.Lq);
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (qi / kRows < first_query_tile(p, kt * kRows, p.mask != nullptr)) continue;
    const float4* src = reinterpret_cast<const float4*>(part + (kt * rows + row) * D + c);
    const float4 x = src[0], y = src[1];
    acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
    acc[4] += y.x; acc[5] += y.y; acc[6] += y.z; acc[7] += y.w;
  }
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = mma::pack2<T>(acc[2 * j] * p.scale, acc[2 * j + 1] * p.scale);
  const int b = bh / p.H, h = bh % p.H;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + qi * p.dq_sl + c;
  *reinterpret_cast<uint4*>(dq) = out;
}

template <typename T, int D, int NKT, bool kMask, bool kLong>
int launch_main(const Args& a, int sms, cudaStream_t stream) {
  using C = Cfg<D, NKT, kMask, kLong>;
  auto kernel = flash_attn_bwd_kernel<T, D, NKT, kMask, kLong>;
  const int err = allow_smem(kernel, C::kBytes);
  if (err != 0) return err;
  const int resident = C::kMinBlocks * sms;
  const int grid = a.n_units > resident ? resident : a.n_units;
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kMask>
int launch_m(const Args& a, int long_form, int sms, cudaStream_t stream) {
  if (!long_form)
    return a.p.Lk > kRows ? launch_main<T, D, 2, kMask, false>(a, sms, stream)
                          : launch_main<T, D, 1, kMask, false>(a, sms, stream);
  const long long rows = static_cast<long long>(a.p.B) * a.p.H * a.p.Lq;
  const int err = launch_main<T, D, 1, kMask, true>(a, sms, stream);
  if (err != 0) return err;
  flash_attn_bwd_sum_kernel<T, D>
      <<<static_cast<unsigned>((rows * (D / 8) + 255) / 256), 256, 0, stream>>>(
          a.p, a.dq_part, a.n_kt);
  return static_cast<int>(cudaGetLastError());
}

// The launcher of one (dtype, head dim) pair; the part of the build that
// holds the pair's kernels defines it.
template <typename T, int D>
int launch_pair(const Args& a, int long_form, int sms, cudaStream_t stream);

#if VIVQA_BUILDS_KERNELS
template <typename T, int D>
int launch_pair(const Args& a, int long_form, int sms, cudaStream_t stream) {
  return a.p.mask != nullptr ? launch_m<T, D, true>(a, long_form, sms, stream)
                             : launch_m<T, D, false>(a, long_form, sms, stream);
}

// One part a (dtype, head dim) pair: parts 1-3 bf16 at D = 32, 64, 128,
// parts 4-6 f16.
#define VIVQA_PAIR(T, D) \
  template int launch_pair<T, D>(const Args&, int, int, cudaStream_t);
#if VIVQA_BUILDS_PART(1)
VIVQA_PAIR(__nv_bfloat16, 32)
#endif
#if VIVQA_BUILDS_PART(2)
VIVQA_PAIR(__nv_bfloat16, 64)
#endif
#if VIVQA_BUILDS_PART(3)
VIVQA_PAIR(__nv_bfloat16, 128)
#endif
#if VIVQA_BUILDS_PART(4)
VIVQA_PAIR(__half, 32)
#endif
#if VIVQA_BUILDS_PART(5)
VIVQA_PAIR(__half, 64)
#endif
#if VIVQA_BUILDS_PART(6)
VIVQA_PAIR(__half, 128)
#endif
#if defined(VIVQA_PART) && VIVQA_PART > 6
#error "flash_attn_bwd.cu has kernel parts 1-6 (ops/cuda_build.py: PARTS)"
#endif
#endif  // VIVQA_BUILDS_KERNELS

}  // namespace bwd
}  // namespace vivqa

#if VIVQA_BUILDS_ENTRY
namespace {

using vivqa::BwdParams;

template <typename T>
int launch(const vivqa::bwd::Args& a, int head_dim, int long_form, int sms,
           cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return vivqa::bwd::launch_pair<T, 32>(a, long_form, sms, stream);
    case 64:
      return vivqa::bwd::launch_pair<T, 64>(a, long_form, sms, stream);
    case 128:
      return vivqa::bwd::launch_pair<T, 128>(a, long_form, sms, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16 (float32 takes flash_attn_bwd_dq.cu and
// flash_attn_bwd_dkv.cu). Pointers q, k, v, o, dO, dq, dk, dv (dtype;
// bases on 16 bytes, strides in multiples of 16 bytes: the TMA's rules,
// which the wrapper meets by copying), m, l (f32, (B*H, Lq) contiguous),
// dq_part (the long form's f32 scratch, else null), mask (bool, or null).
// strides: 27 element strides, q, k, v, o, dO, dq, dk, dv (each b, h, l)
// and the mask (b, q, k). long_form: 0 for Lq, Lk <= 128 (one launch), 1
// otherwise (the kernel over (b, h, key tile) units, then the sum: two
// launches); the wrapper decides. Dropout as in flash_attn_fwd.cu. Returns
// 0, the first launch's cudaGetLastError(), 999 / 1000 + CUresult for a
// tensor map the CUDA driver refused, or -1 for a head dim or dtype this file
// was not built for.
extern "C" int vivqa_flash_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const float* m,
                                    const float* l, float* dq_part, void* dq,
                                    void* dk, void* dv, const void* mask, int dtype,
                                    int head_dim, int B, int H, int Lq, int Lk,
                                    const long long* strides, int causal, int long_form,
                                    float scale, int dropout, unsigned threshold,
                                    unsigned key, float inv_keep, void* stream) {
  vivqa::bwd::Args a;
  a.p = vivqa::make_bwd_params(q, k, v, o, dout, m, l, nullptr, dq, dk, dv, mask, B, H, Lq, Lk,
                               strides, causal, 1, scale, dropout, threshold, key, inv_keep);
  const BwdParams& p = a.p;
  CUtensorMap* maps[8] = {&a.q, &a.k, &a.v, &a.o, &a.dout, &a.dq, &a.dk, &a.dv};
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  const int lens[8] = {Lq, Lk, Lk, Lq, Lq, Lq, Lk, Lk};
  for (int i = 0; i < 8; ++i) {  // strides: (b, h, l) of q, k, v, o, dO, dq, dk, dv
    const int err = vivqa::tma::encode_map(maps[i], ptrs[i], dtype, head_dim, B, H, lens[i],
                               strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]);
    if (err != 0) return err;
  }
  a.dq_part = dq_part;
  a.n_kt = (Lk + vivqa::bwd::kRows - 1) / vivqa::bwd::kRows;
  a.n_qt = (Lq + vivqa::bwd::kRows - 1) / vivqa::bwd::kRows;
  a.n_units = long_form ? B * H * a.n_kt : B * H;
  a.mask_mode = vivqa::tma::mask_mode(mask, p.m_sb, p.m_sq, p.m_sk);
  int dev = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch<__nv_bfloat16>(a, head_dim, long_form, sms, s);
    case 2:
      return launch<__half>(a, head_dim, long_form, sms, s);
    default:
      return -1;
  }
}
#endif  // VIVQA_BUILDS_ENTRY
