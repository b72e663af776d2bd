// Blocked (flash) attention forward for Hopper (sm_90a), plain C interface.
//
// vivqa_flash_attn_fwd replaces the Pallas TPU kernel _flash_kernel
// (vivqa_tpu/ops/flash_attention.py:61, launched by _flash_forward :116
// through pl.pallas_call :127); it serves inference. vivqa_flash_attn_fwd_lse
// replaces _flash_kernel_lse (:142, launched by _flash_forward_lse :196
// through pl.pallas_call :206): the same forward, which also writes the
// per-row f32 softmax stats m (running max) and l (running sum), kept
// SEPARATE and not folded into an lse (a fully masked row has m = -1e30,
// which would absorb log l), and applies attention-probability dropout
// (flax's broadcast_dropout: one keep mask per call, shared by every batch
// row and head). It is the training forward; the one-pass backward
// (flash_attn_bwd.cu) reads m and l.
//
// Both compute softmax(Q K^T / sqrt(D) [causal]) V with the 1/sqrt(D)
// scale applied in f32, the causal diagonal anchored at the END of the key
// axis (q_offset = Lk - Lq), an online softmax with f32 running max m,
// running sum l and accumulator, and the output in the input's dtype.
// Beyond the Pallas kernels they take:
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
// over all Lk keys (m exactly -1e30, l exactly Lk), never NaN. A key
// beyond Lk gets probability exactly 0 and is not counted at all. Dropout
// multiplies the probability by keep / (1 - rate) before P.V; l sums the
// probabilities before dropout. p z is rounded to the input dtype as the
// operand of P.V; every sum is f32.
//
// f32 takes the SIMT template (flash_attn_fwd_kernel; f32 products on the
// tensor cores would round to TF32, outside the f32 tolerances, and f32 is
// not on the model's path). bf16 and f16 take one Hopper design, in three
// forms that ops/flash_attention.py:forward_plan picks for each call, the
// same for both entries (the training entry adds m, l and dropout through
// the kTrain flag; the entries' kernels are named apart, *_serve_* and
// *_train_*, so a profile counts each):
//   - tile form (Lq > 4, Lk <= 128: every flagship shape, 49, 50 and 64,
//     and the generative fusion's 113 to 118): a unit is (b, h, 64-query
//     tile) over one 64-key tile, or one 32-key tile over at most 32 keys
//     (the ablation study's experts and the generative decoder's self
//     calls in training), or, with more than 64 queries and keys, (b, h,
//     128-query tile) over one 128-key tile (64 at D = 128): one launch;
//   - long form (Lq > 4, Lk > 128: 197, 784, 1,024, 1,370 keys): the same
//     units walk their keys tile by tile. Where they are fewer than half
//     the card's SMs (32 at the zoo's 32 x 784), the keys are split over
//     units: each writes its f32 partial (o, m, l) to a scratch the
//     wrapper allocates, and flash_attn_fwd_merge_kernel merges the splits
//     in split order (two launches);
//   - decode form (Lq <= 4: the decoder's self calls over the cache, its
//     cross calls over 113 or 118 keys, KnowledgeAttention over 5): a unit
//     is one (b, h) on the CUDA cores, one launch.
// No atomics anywhere: two calls on the same inputs are bit-equal.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 132 SMs, 227 KB
// of shared memory a block, 64K registers an SM; chip_smoke.py's
// attention_work and train_attention_work): the tile form does 4 D flops a
// (query, key) pair against about 8 D bytes of q, k, v and o per head row,
// a few flops a byte against the ~295 at which the tensor cores bind, so
// the bytes bind: 0.427 ms for the 36 calls of bench.py's training step at
// batch 128, 0.026 ms for the 36 serving calls of a forward at batch 8 (a
// call there moves ~2.5 MB, under a microsecond: latency sets its time).
// The long form at 1,024 and 1,370 keys is bound by operations (4.34 us
// and 5.83 us at chip_smoke.py's long_1024 and DINOv2's 1,370), at 784 keys
// over 32 queries by bytes (2.0 us). The decode form is bound by the bytes
// of K and V (0.68 us and 4.46 us for the beam generate's self and cross
// calls at 64 x 8 rows).
//
// Design, against the four faults of the mma.sync templates it replaced
// (ROADMAP.md, Queue B; PERF.md, Findings):
//   - Long keys walked serially on mma.sync, at 11% of the tensor rate at
//     1,370 keys: the products are wgmma (m64nNk16, f32 accumulators), one
//     64-row tile a consumer warpgroup. S = Q K^T takes Q and K from
//     swizzled shared memory, K-major over D (desc_k); O += P V takes P
//     from registers as the A operand (the S accumulator rounded and
//     repacked in place: the two layouts hold the same rows and columns)
//     and V from shared memory as a transposed, MN-major B (desc_v). Every
//     descriptor is built from the same swizzle as TMA wrote (tma::sw).
//     Tile kt's P V runs under tile kt + 1's S and softmax. Over more
//     than 64 queries two consumer warpgroups share each K/V tile (half
//     the reads of K and V from L2), over 128-key tiles. Too few units to
//     fill the card (32 at 32 x 784): the key splits above.
//   - Single-query calls in a 32- or 64-row tensor-core tile, 31 or 63 of
//     its rows empty: the decode form pads nothing. Its work is a few
//     flops a byte of K and V, so it runs on the CUDA cores: a block per
//     (b, h) of up to 4 warps, each taking 32-key chunks with every copy
//     of a chunk, its mask bytes and q in flight at once; lane j scores
//     key j for every query row, a warp takes a row's max and sum by
//     shuffles, and P V gives each lane D / 32 columns; the warps'
//     partials merge in warp order. It is compiled for 1 query row and
//     for 4 (each row a template holds costs every lane its instructions,
//     run or not); from 5 queries on the tile form's 64-row tile is the
//     faster (the ablation study's 8- and 16-query calls took 3-5x as long
//     on this form; PERF.md, Findings). With ~38 KB of shared memory at
//     D = 64, several blocks, so several (b, h) units, share an SM. Short
//     calls of the tile form pad their 64-row tile instead; over at most
//     32 keys the tile is 32 keys wide (m64n32k16, half the scores, the
//     exponentials and the dropout hashes of a 64-key tile, and four
//     blocks an SM at D <= 64 in its fewer registers).
//   - Nothing overlapped inside a block at L <= 64: persistent blocks of
//     one producer warp and one or two consumer warpgroups. The producer
//     walks the block's units ahead of the consumers: each unit's Q tiles
//     into one of kQSlots slots, each key tile's K and V into one of kRing
//     stages (as deep as shared memory allows: the consumers hold two
//     while P V overlaps the next S), by cp.async.bulk.tensor over the
//     (B, L, H, D) storage in 64-row boxes (zero fill past L covers ragged
//     rows; D = 128 rows take two 64-column boxes) under the 128-byte
//     swizzle (64-byte at D = 32), each landing on an mbarrier; the
//     stage's mask bytes go by cp.async from the same warp and arrive on
//     the stage's barrier (tma::stage_mask; unaligned rows by 4-byte words
//     at a per-row shift; no byte past Lk is read). o is staged in the
//     unit's spent Q tile and leaves by the producer's TMA store before the
//     slot is loaded again (rows past Lq are not written; each warp's own
//     16-byte stores ran slower on the card); m and l by plain stores.
//     Every mbarrier wait traps after about 10 s. One consumer warpgroup:
//     three blocks an SM (kMinBlocks), so one block's softmax runs under
//     another's products and loads; two: one block, taking their own
//     turns. setmaxnreg was not taken: the consumers fit their registers.
//   - The chain of elementwise steps per score (rules, mask byte, dropout
//     hash, exp, row max and sum): a tile whose keys no rule removes (past
//     Lk at most) takes the scale and log2(e) in one FMA before one ex2;
//     elsewhere the exponential is ex2((s - m) log2(e)), so m stays in
//     natural units and exactly -1e30 on a row whose keys are all removed.
//     The rules apply on wgmma's accumulator coordinates (row 16 w + g + 8
//     i, key 8 j + 2 t + c for warp w, lane 4 g + t, register 4 j + 2 i +
//     c), the mask bytes read two at a time, the mask code compiled out of
//     calls without a mask, and without a branch: the causal limit and
//     the mask bit select the score (a branch a score, as mma::KeyRule's
//     state compiles, made a masked call cost about twice its products;
//     PERF.md, Findings).
//
// The ring, Q slots and blocks an SM are the constants below;
// tools/attention_variants.py builds this source with other values.

#include <climits>

#include "flash_attn_tma.cuh"

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

// What a launch of the bf16/f16 forward shares: the tensor maps of q, k, v
// and o (the tile and long forms; in the kernel's parameter space,
// __grid_constant__), the call's Params, and the units.
struct Args {
  CUtensorMap q, k, v, o;
  Params p;
  // key splits > 1: the f32 partials, o (splits, B*H, Lq, D), then m and
  // l (splits, B*H, Lq) each
  float* part;
  int form;  // kFormDecode, kFormTiles, kFormWideTiles or kFormNarrowTiles
  int n_units, n_qt, n_kt, splits, tiles_per_split;
  int mask_mode;  // tma::kMaskRows16, kMaskWords or kMaskBytes
  int sms;
};

constexpr int kFormDecode = 0;     // Lq <= 4: CUDA cores, a unit per (b, h)
constexpr int kFormTiles = 1;      // the tile and long forms: TMA and wgmma, 64-query units
constexpr int kFormWideTiles = 2;  // the tile and long forms over 128-query units
constexpr int kFormNarrowTiles = 3;  // the tile form over at most 32 keys, 64-query units

// keys a tile: 64 in 64-query units; 128 in 128-query units (64 at D =
// 128); 32 over at most 32 keys
__host__ __device__ constexpr int key_tile(int form, int D) {
  return form == kFormNarrowTiles ? 32 : form == kFormWideTiles && D <= 64 ? 128 : 64;
}

// The launchers of one (dtype, head dim) pair, serving and training; the
// part of the build that holds the pair's kernels defines them.
template <typename T, int D>
int serve_pair(const Args& a, cudaStream_t stream);
template <typename T, int D>
int train_pair(const Args& a, cudaStream_t stream);

}  // namespace vivqa::fwd

namespace {

using namespace vivqa;
using namespace vivqa::tma;
using fwd::Args;
using fwd::Params;
using mma::KeyRule;
using mma::kKept;

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

template <typename T, int D, bool kTrain>
int launch_simt(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  const dim3 block(kThreads);
  flash_attn_fwd_kernel<T, D, kTrain><<<grid, block, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// -- the bf16/f16 forward: wgmma -----------------------------------------------
template <typename T> constexpr bool kIsBf16 = false;
template <> constexpr bool kIsBf16<__nv_bfloat16> = true;

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are pending (they complete in order)
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// after a wait: later reads of d see what the products wrote (the
// compiler may not move them above the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// the A operand's registers stay allocated until here (a product reads
// them after it is issued)
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(a[j][e]) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, f32) (+)= A . B^T, A and B K-major in shared memory
#define VIVQA_WGMMA_SS64(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "l"(da), "l"(db), "r"(scale_d))

// d (64 x 128, f32) (+)= A . B^T, A and B K-major in shared memory
#define VIVQA_WGMMA_SS128(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "l"(da), "l"(db), "r"(scale_d))

// d (64 x 32, f32) (+)= A . B^T, A and B K-major in shared memory
#define VIVQA_WGMMA_SS32(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]) \
      : "l"(da), "l"(db), "r"(scale_d))

// d (64 x 32, f32) += A . B, A in registers, B MN-major in shared memory
#define VIVQA_WGMMA_RS32(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                 \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// d (64 x 64, f32) += A . B, A in registers, B MN-major in shared memory
#define VIVQA_WGMMA_RS64(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                 \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// d (64 x 128, f32) += A . B, A in registers, B MN-major in shared memory
#define VIVQA_WGMMA_RS128(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                 \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))


// d (64 x N) (+)= A (64 x 16) . B (16 x N); scale_d = 0: d = A . B
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "S tiles of 32, 64 or 128 keys");
  if constexpr (N == 32) {
    if constexpr (kIsBf16<T>) VIVQA_WGMMA_SS32("bf16"); else VIVQA_WGMMA_SS32("f16");
  } else if constexpr (N == 64) {
    if constexpr (kIsBf16<T>) VIVQA_WGMMA_SS64("bf16"); else VIVQA_WGMMA_SS64("f16");
  } else {
    if constexpr (kIsBf16<T>) VIVQA_WGMMA_SS128("bf16"); else VIVQA_WGMMA_SS128("f16");
  }
}
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  const int scale_d = 1;
  if constexpr (N == 32) {
    if constexpr (kIsBf16<T>) VIVQA_WGMMA_RS32("bf16"); else VIVQA_WGMMA_RS32("f16");
  } else if constexpr (N == 64) {
    if constexpr (kIsBf16<T>) VIVQA_WGMMA_RS64("bf16"); else VIVQA_WGMMA_RS64("f16");
  } else {
    if constexpr (kIsBf16<T>) VIVQA_WGMMA_RS128("bf16"); else VIVQA_WGMMA_RS128("f16");
  }
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (each >> 4), and the swizzle (1: 128-byte, 2:
// 64-byte), matching what TMA wrote (tma::sw: tiles on 1024 bytes, rows of
// 128 bytes, or 64 at D = 32; D = 128 rows as two 64-column boxes of R rows).
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kSwizzle = D == 32 ? 2 : 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (kSwizzle << 62);
}
__host__ __device__ constexpr int row_bytes(int D) { return D == 32 ? 64 : 128; }  // a staged row of one box
// columns [16 kk, 16 kk + 16) of a K-major tile of R rows (Q, K): 8-row
// groups 8 rows apart (the stride byte offset); the leading offset is not
// used under a swizzle; the kk-th 32 bytes of a row are a start address
// inside the swizzle's row, as tma::sw places them
template <int D, int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  const uint32_t addr = tile + sw<D, R>(0, 2 * kk);
  return make_desc<D>(addr, 16, 8 * row_bytes(D));
}
// rows [16 kc, 16 kc + 16) of an MN-major tile of R rows (V read as a
// transposed B: its D columns are N): 8-row groups 8 rows apart (stride),
// and at D = 128 the second 64 columns one box of R rows on (leading)
template <int D, int R>
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kc) {
  const uint32_t addr = tile + sw<D, R>(16 * kc, 0);
  return make_desc<D>(addr, D == 128 ? R * 128 : 16, 8 * row_bytes(D));
}

constexpr int kRows = 64;             // query rows a consumer warpgroup: its wgmma tile
constexpr int kQSlots = 2;            // units' Q tiles in flight a block
constexpr int kRing = 4;              // K/V stages aimed for
constexpr int kBlocksPerSM = 3;       // aimed for, one consumer warpgroup, 64-key tiles
constexpr int kSmemPerSM = 233472;     // 228 KB, of which 1 KB is reserved a block
constexpr int kSmemPerBlock = 232448;  // 227 KB

__host__ __device__ constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int tile_bytes(int D, int rows) { return rows * D * 2; }  // 16-bit
// rows of a staged K or V tile: whole 64-row TMA boxes (a 32-key tile
// lands in one box, of which its products read the first 32 rows)
__host__ __device__ constexpr int kv_rows(int nk) { return nk < kRows ? kRows : nk; }
__host__ __device__ constexpr int mask_pitch(int nk) { return nk + 16; }  // bytes a staged mask row
// a staged mask tile of 64 query rows: the rows, then each row's shift
__host__ __device__ constexpr int mask_bytes(int nk) { return kRows * mask_pitch(nk) + kRows; }
// a K/V stage: the K and V tiles, then a mask tile per consumer warpgroup
__host__ __device__ constexpr int stage_bytes(int D, int nk, int wg, bool mask) {
  return round1024(2 * tile_bytes(D, kv_rows(nk)) + (mask ? wg * mask_bytes(nk) : 0));
}
// One consumer warpgroup: kBlocksPerSM where its registers allow it (S of
// 64 keys and O of at most 64 columns), one more over 32 keys, else 2.
// Two: one block an SM.
__host__ __device__ constexpr int min_blocks(int D, int nk, int wg) {
  return wg == 2 ? 1 : D > 64 ? 2 : nk == 32 ? kBlocksPerSM + 1 : nk == 64 ? kBlocksPerSM : 2;
}
// behind 1024 bytes of alignment slack: the Q slots, the stages, the barriers
__host__ __device__ constexpr int smem_bytes(int D, int nk, int wg, bool mask, int ring) {
  return 1024 + kQSlots * wg * tile_bytes(D, kRows) + ring * stage_bytes(D, nk, wg, mask) + 128;
}
// the deepest ring within a block's share
__host__ __device__ constexpr int pick_ring(int D, int nk, int wg, bool mask) {
  for (int r = kRing; r > 1; --r)
    if (smem_bytes(D, nk, wg, mask, r) <= kSmemPerSM / min_blocks(D, nk, wg) - 1024) return r;
  return 1;
}

// NK keys a tile, WG consumer warpgroups a block (each 64 of a unit's
// 64 WG query rows), kMask: the call has a mask
template <int D, int NK, int WG, bool kMask>
struct Cfg {
  static constexpr int kUnitRows = kRows * WG;
  static constexpr int kConsumers = 128 * WG;   // consumer threads
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
  static constexpr int kQTile = tile_bytes(D, kRows);  // a multiple of 1024
  static constexpr int kQSlot = WG * kQTile;
  static constexpr int kKRows = kv_rows(NK);
  static constexpr int kKTile = tile_bytes(D, kKRows);
  static constexpr int kMaskPitch = mask_pitch(NK);
  static constexpr int kMaskOff = 2 * kKTile;  // warpgroup g's tile at + g mask_bytes(NK)
  static constexpr int kStage = stage_bytes(D, NK, WG, kMask);
  static constexpr int kMinBlocks = min_blocks(D, NK, WG);
  static constexpr int kRingN = pick_ring(D, NK, WG, kMask);
  static constexpr int kBytes = smem_bytes(D, NK, WG, kMask, kRingN);
  static_assert(kBytes <= kSmemPerBlock, "shared memory of a block");
  static_assert((NK == 32 || NK % kRows == 0) && (D < 128 || NK <= kRows),
                "key tiles in 64-row boxes");
  // byte offsets from the aligned base
  static constexpr int kRingOff = kQSlots * kQSlot;
  static constexpr int kBarOff = kRingOff + kRingN * kStage;
};

// A unit: (b*h, query tile of R rows, key split), and the key tiles [kt0,
// kt1) it takes. Causal without a mask, the tiles past the query tile's
// last diagonal carry weight exactly 0 and are not taken -- unless its
// first row has no key (Lq > Lk), which must average over all Lk keys. A
// split left with no tile (kt0 >= kt1) has no key; the merge gives it
// weight 0. Split 0 always has a tile.
struct Unit {
  int bh, q0, sp, kt0, kt1;
};
template <int NK, int R, bool kMask>
__device__ __forceinline__ Unit unit_at(const Args& a, int u) {
  const Params& p = a.p;
  Unit x;
  x.sp = u % a.splits;
  const int rest = u / a.splits;
  x.q0 = (rest % a.n_qt) * R;
  x.bh = rest / a.n_qt;
  x.kt0 = x.sp * a.tiles_per_split;
  x.kt1 = min(a.n_kt, x.kt0 + a.tiles_per_split);
  const int off = p.Lk - p.Lq;
  if (p.causal && !kMask && off + x.q0 >= 0) {
    const int k_end = min(p.Lk, off + min(x.q0 + R, p.Lq));
    x.kt1 = min(x.kt1, (k_end + NK - 1) / NK);
  }
  return x;
}

// a tensor map's descriptor into the cache before its first TMA
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// S = Q K^T over D for one key tile, committed, not waited for
template <typename T, int D, int NK>
__device__ __forceinline__ void issue_s(float (&sc)[NK / 8][4], uint32_t tQ, uint32_t tK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T, NK>(sc, desc_k<D, kRows>(tQ, kk), desc_k<D, kv_rows(NK)>(tK, kk), kk > 0);
  wg_commit();
}

// A consumer thread's two query rows (queries qi): the running max m and
// sum l, and the dropout row hashes
struct Rows {
  int qi[2];
  float m[2], l[2];
  uint32_t hash[2];
};

// The softmax of one key tile's scores (keys k0 ..) in place: sc becomes
// p z, m and l are updated, alpha is the rescale of the rows' earlier
// sums. Element (j, e) is query w.qi[e / 2] (tile row r0 + 8 (e / 2) of
// the warpgroup's 64), key k0 + 8 j + 2 t + e % 2. mask: the warpgroup's
// staged mask rows (kMask) at mask_pitch, each row's shift after them; q0:
// the unit's first query.
template <int NK, bool kTrain, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[NK / 8][4], Rows& w, float (&alpha)[2],
                                             const Params& p, const KeyRule& rule, int q0,
                                             int k0, const unsigned char* mask,
                                             int mask_pitch, int mask_mode, int r0, int t) {
  constexpr float kLog2e = 1.4426950408889634f;
  float tmax[2] = {-INFINITY, -INFINITY};
  float tsum[2] = {0.f, 0.f};
  const bool drop = kTrain && p.drop.on;
  if (!kMask && !(p.causal && k0 + NK - 1 > rule.q_offset + q0)) {
    // no key of the tile removed (past Lk at most): the scale and log2(e)
    // in one FMA, m a real score
    if (k0 + NK > p.Lk) {
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= p.Lk) sc[j][e] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[j][e]);
    float ml[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(w.m[i], mma::quad_max(tmax[i]) * p.scale);
      alpha[i] = ex2((w.m[i] - m_new) * kLog2e);
      w.m[i] = m_new;
      ml[i] = m_new * kLog2e;
    }
    const float sl = p.scale * kLog2e;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = ex2(fmaf(sc[j][e], sl, -ml[e >> 1]));  // 0 past Lk (-inf)
        tsum[e >> 1] += pr;
        if (drop)
          pr *= p.drop.scale(w.hash[e >> 1], k0 + 8 * j + 2 * t + (e & 1));
        sc[j][e] = pr;
      }
  } else {
    // the mask bytes of keys 8 j + 2 t and + 1 of each row, 16 bits a load
    // (rows staged at a shift, kMaskWords, a byte a load)
    uint32_t keep[2][NK / 8];
    if constexpr (kMask) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const uint8_t* row = mask + r * mask_pitch + 2 * t;
        if (mask_mode == kMaskWords) {
          row += mask[kRows * mask_pitch + r];
#pragma unroll
          for (int j = 0; j < NK / 8; ++j) keep[i][j] = row[8 * j] | (row[8 * j + 1] << 8);
        } else {
#pragma unroll
          for (int j = 0; j < NK / 8; ++j)
            keep[i][j] = *reinterpret_cast<const uint16_t*>(row + 8 * j);
        }
      }
    }
    // the rules without branches (a branch a score cost a masked call more
    // than its products): a key is kept up to the row's causal limit and
    // where its mask byte is set, scored -1e30 where removed, -inf past Lk
    const int lim[2] = {p.causal ? rule.q_offset + w.qi[0] : INT_MAX,
                        p.causal ? rule.q_offset + w.qi[1] : INT_MAX};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        bool kept = kj <= lim[e >> 1];
        if constexpr (kMask) kept = kept & ((keep[e >> 1][j] >> (8 * (e & 1)) & 0xffu) != 0u);
        float v = kept ? sc[j][e] * p.scale : kMasked;
        v = kj < p.Lk ? v : -INFINITY;
        sc[j][e] = v;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], v);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(w.m[i], mma::quad_max(tmax[i]));
      alpha[i] = ex2((w.m[i] - m_new) * kLog2e);
      w.m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // (s - m) first: exactly 0 where s = m (a row of removed keys)
        float pr = ex2((sc[j][e] - w.m[e >> 1]) * kLog2e);  // 0 past Lk (-inf)
        tsum[e >> 1] += pr;
        if (drop)
          pr *= p.drop.scale(w.hash[e >> 1], k0 + 8 * j + 2 * t + (e & 1));
        sc[j][e] = pr;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) w.l[i] = alpha[i] * w.l[i] + mma::quad_sum(tsum[i]);
}

template <typename T, int D, int NK, int WG, bool kTrain, bool kMask>
__device__ __forceinline__ void fwd_tiles_body(const Args& a) {
  using C = Cfg<D, NK, WG, kMask>;
  constexpr int R = C::kUnitRows;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const uint32_t raw = mma::smem_u32(fwd_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = fwd_smem + (base - raw);  // the same bytes, generic
  const uint32_t bars = base + C::kBarOff;
  auto q_full = [&](int s) { return bars + 8 * s; };
  auto q_empty = [&](int s) { return bars + 8 * (kQSlots + s); };
  auto kv_full = [&](int s) { return bars + 8 * (2 * kQSlots + s); };
  auto kv_empty = [&](int s) { return bars + 8 * (2 * kQSlots + C::kRingN + s); };
  const Params& p = a.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t ring = base + C::kRingOff;  // the K/V stages

  if (warp == C::kConsumers / 32 && lane == 0) {  // the producer's first loads need them
    prefetch_map(&a.q);
    prefetch_map(&a.k);
    prefetch_map(&a.v);
    prefetch_map(&a.o);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQSlots; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), 4 * WG);  // the consumer warps
    }
    for (int s = 0; s < C::kRingN; ++s) {
      // the expect_tx arrival, and with a mask the 32 lanes' stores and copies
      mbar_init(kv_full(s), kMask ? 65 : 1);
      mbar_init(kv_empty(s), 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::kConsumers / 32) {
    // -- the producer warp: the block's units' Q tiles, then their key
    // tiles' K, V and mask, each into the next free slot or stage; before
    // a Q slot is loaded again, the TMA store of the o its last unit left
    // there (rows past Lq are not written) ------------------------------------
    int qn = 0, it = 0;
    int slot_q0[kQSlots], slot_bh[kQSlots];
    auto store_o = [&](int qs) {
#pragma unroll
      for (int g = 0; g < WG; ++g)
#pragma unroll
        for (int c = 0; c < D; c += 64)
          tma_store(&a.o, base + qs * C::kQSlot + g * C::kQTile + (c / 64) * kRows * 128, c,
                    slot_q0[qs] + g * kRows, slot_bh[qs] % p.H, slot_bh[qs] / p.H);
    };
    for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
      const Unit x = unit_at<NK, R, kMask>(a, u);
      if (x.kt0 >= x.kt1) continue;
      const int b = x.bh / p.H, h = x.bh % p.H;
      const int qs = qn % kQSlots;
      mbar_wait(q_empty(qs), ((qn / kQSlots) & 1) ^ 1);
      if (lane == 0) {
        if (a.splits == 1 && qn >= kQSlots) {  // the slot holds its last unit's o
          store_o(qs);
          bulk_commit();
          bulk_wait_read();
        }
        slot_q0[qs] = x.q0;
        slot_bh[qs] = x.bh;
        const uint32_t tq = base + qs * C::kQSlot;
        mbar_arrive_tx(q_full(qs), C::kQSlot);
#pragma unroll
        for (int g = 0; g < WG; ++g)
#pragma unroll
          for (int c = 0; c < D; c += 64)
            tma_load(tq + g * C::kQTile + (c / 64) * kRows * 128, &a.q, q_full(qs), c,
                     x.q0 + g * kRows, h, b);
      }
      const uint8_t* mask = kMask ? p.mask + b * p.m_sb : nullptr;
      for (int kt = x.kt0; kt < x.kt1; ++kt, ++it) {
        const int s = it % C::kRingN;
        mbar_wait(kv_empty(s), ((it / C::kRingN) & 1) ^ 1);
        const uint32_t st = ring + s * C::kStage;
        if (lane == 0) {
          mbar_arrive_tx(kv_full(s), 2 * C::kKTile);
#pragma unroll
          for (int c = 0; c < D; c += 64)
#pragma unroll
            for (int i = 0; i < C::kKRows / kRows; ++i) {
              const uint32_t off = sw<D, C::kKRows>(i * kRows, c / 8);
              tma_load(st + off, &a.k, kv_full(s), c, kt * NK + i * kRows, h, b);
              tma_load(st + C::kKTile + off, &a.v, kv_full(s), c, kt * NK + i * kRows, h, b);
            }
        }
        if constexpr (kMask) {
          unsigned char* gm = gbase + (st - base) + C::kMaskOff;
#pragma unroll
          for (int g = 0; g < WG; ++g)  // warpgroup g's 64 rows and their shifts
            stage_mask<NK>(gm + g * mask_bytes(NK), gm + g * mask_bytes(NK) + kRows * C::kMaskPitch,
                           mask, p.m_sq, p.m_sk, x.q0 + g * kRows, p.Lq, kt * NK, p.Lk,
                           a.mask_mode, lane);
          mbar_arrive(kv_full(s));      // this lane's element stores are done
          cp_async_arrive(kv_full(s));  // and its copies, when they land
        }
      }
      ++qn;
    }
    if (lane == 0 && a.splits == 1) {  // the o of the last units
      for (int i = qn > kQSlots ? qn - kQSlots : 0; i < qn; ++i) {
        mbar_wait(q_empty(i % kQSlots), (i / kQSlots) & 1);
        store_o(i % kQSlots);
      }
      bulk_commit();
      bulk_wait_read();  // the block's shared memory may go; the grid's end completes the stores
    }
    mma::cp_async_wait_all();  // no copy outlives the warp
    return;
  }

  // -- the consumer warpgroups: warpgroup wg takes the unit's query rows
  // 64 wg .. 64 wg + 63, its warp wq rows 16 wq .. 16 wq + 15 ---------------
  const int wg = warp / 4, wq = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wq + g;  // this thread's rows r0 and r0 + 8 of its warpgroup's 64
  const KeyRule rule{nullptr, 0, 0, p.Lq, p.Lk, p.Lk - p.Lq, p.causal};
  const unsigned char* gring = gbase + C::kRingOff + C::kMaskOff + wg * mask_bytes(NK);
  const long long rows = static_cast<long long>(p.B) * p.H * p.Lq;
  float* part_m = a.part + static_cast<long long>(a.splits) * rows * D;
  float* part_l = part_m + a.splits * rows;
  int qn = 0, it = 0;
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    const Unit x = unit_at<NK, R, kMask>(a, u);
    const int q0 = x.q0 + wg * kRows;  // the warpgroup's first query
    Rows w;
    w.qi[0] = q0 + r0;
    w.qi[1] = q0 + r0 + 8;
    const long long row0 = (static_cast<long long>(x.sp) * p.B * p.H + x.bh) * p.Lq;
    if (x.kt0 >= x.kt1) {  // a split with no key: weight 0 in the merge
      if (t == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (w.qi[i] < p.Lq) part_m[row0 + w.qi[i]] = -INFINITY;
      continue;
    }
    const int qs = qn % kQSlots;
    const uint32_t tQ = base + qs * C::kQSlot + wg * C::kQTile;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w.m[i] = kMasked;
      w.l[i] = 0.f;
      w.hash[i] = kTrain ? p.drop.row(w.qi[i]) : 0u;
    }
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    mbar_wait(q_full(qs), (qn / kQSlots) & 1);
    float sc[NK / 8][4];
    // Tile kt's P V runs under tile kt + 1's S and softmax (with two or
    // more stages): S(kt + 1) and PV(kt) are committed in that order, so
    // waiting for all but one group leaves PV(kt) running while the
    // softmax reads S(kt + 1).
    constexpr bool kAhead = C::kRingN > 1;
    int s = it % C::kRingN;
    mbar_wait(kv_full(s), (it / C::kRingN) & 1);
    __syncwarp();  // converged for wgmma's .aligned
    wg_fence();
    issue_s<T, D, NK>(sc, tQ, ring + s * C::kStage);
    wg_wait<0>();
    fence_regs(sc);
    float alpha[2];
    softmax_tile<NK, kTrain, kMask>(sc, w, alpha, p, rule, q0, x.kt0 * NK,
                                    gring + s * C::kStage, C::kMaskPitch, a.mask_mode, r0, t);
    uint32_t pa[NK / 16][4];
    mma::to_a_frags<T, NK / 8>(pa, sc);  // p z rounded to T: the A operand of P V
    for (int kt = x.kt0;; ++kt) {
      const bool more = kt + 1 < x.kt1;
      const bool ahead = kAhead && more;
      const int s_next = (it + 1) % C::kRingN;
      if (ahead) {
        mbar_wait(kv_full(s_next), ((it + 1) / C::kRingN) & 1);
        __syncwarp();
      }
      wg_fence();
      if (ahead) issue_s<T, D, NK>(sc, tQ, ring + s_next * C::kStage);
      const uint32_t tV = ring + s * C::kStage + C::kKTile;
#pragma unroll
      for (int kc = 0; kc < NK / 16; ++kc)
        wgmma_rs<T, D>(o, pa[kc], desc_v<D, C::kKRows>(tV, kc));
      wg_commit();
      if (ahead) {
        wg_wait<1>();
        fence_regs(sc);
        softmax_tile<NK, kTrain, kMask>(sc, w, alpha, p, rule, q0, (kt + 1) * NK,
                                        gring + s_next * C::kStage, C::kMaskPitch, a.mask_mode,
                                        r0, t);
      }
      wg_wait<0>();
      fence_regs(o);
      keep_regs(pa);  // P V read them until here
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty(s));  // this warp is done with the stage
      ++it;
      if (!more) break;
      s = s_next;
      if (!kAhead) {
        mbar_wait(kv_full(s), (it / C::kRingN) & 1);
        __syncwarp();
        wg_fence();
        issue_s<T, D, NK>(sc, tQ, ring + s * C::kStage);
        wg_wait<0>();
        fence_regs(sc);
        softmax_tile<NK, kTrain, kMask>(sc, w, alpha, p, rule, q0, (kt + 1) * NK,
                                        gring + s * C::kStage, C::kMaskPitch, a.mask_mode, r0,
                                        t);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      mma::to_a_frags<T, NK / 8>(pa, sc);
    }

    // the warpgroup's products are done with its Q tile (a barrier id a
    // warpgroup, constant: a computed id reserves all 16 of the block's)
    if (wg == 0) {
      consumer_sync(1, 128);
    } else {
      consumer_sync(2, 128);
    }
    if (a.splits == 1) {
      // o = acc / l into the spent Q tile, for the producer's TMA store
      const float lr[2] = {fmaxf(w.l[0], 1e-30f), fmaxf(w.l[1], 1e-30f)};
      const float inv[2] = {1.f / lr[0], 1.f / lr[1]};
      unsigned char* gq = gbase + (tQ - base);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(gq + sw<D>(r0 + 8 * i, n) + 4 * t) =
              mma::pack2<T>(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
      fence_async_smem();
      if (kTrain && t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (w.qi[i] < p.Lq) {
            p.m_out[static_cast<long long>(x.bh) * p.Lq + w.qi[i]] = w.m[i];
            p.l_out[static_cast<long long>(x.bh) * p.Lq + w.qi[i]] = lr[i];
          }
        }
      }
    } else {
      // the split's f32 partial: the unnormalised o, m and l
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (w.qi[i] >= p.Lq) continue;
        float* po = a.part + (row0 + w.qi[i]) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(po + 8 * n + 2 * t) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
        if (t == 0) {
          part_m[row0 + w.qi[i]] = w.m[i];
          part_l[row0 + w.qi[i]] = w.l[i];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty(qs));  // this warp is done with the Q slot
    ++qn;
  }
}

// The long form's merge: o = (sum over splits of exp(m_i - m) o_i) / l with
// m = max m_i and l = sum exp(m_i - m) l_i, in split order; 8 columns a
// thread. A split with no key (m_i = -inf) is not read. A row whose keys are
// all removed has m_i = -1e30 in every split, so it sums every split with
// weight 1: the mean over all Lk keys, l = Lk, m = -1e30.
template <typename T, int D, bool kTrain>
__global__ void __launch_bounds__(256)
    flash_attn_fwd_merge_kernel(const Params p, const float* part, int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rows = static_cast<long long>(p.B) * p.H * p.Lq;
  const long long row = idx / (D / 8);
  if (row >= rows) return;
  const int c = static_cast<int>(idx % (D / 8)) * 8;
  const float* part_m = part + splits * rows * D;
  const float* part_l = part_m + splits * rows;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, part_m[i * rows + row]);
  float l = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float mi = part_m[i * rows + row];
    if (mi == -INFINITY) continue;
    const float w = expf(mi - m);
    l += w * part_l[i * rows + row];
    const float4* src = reinterpret_cast<const float4*>(part + (i * rows + row) * D + c);
    const float4 x = src[0], y = src[1];
    acc[0] += w * x.x; acc[1] += w * x.y; acc[2] += w * x.z; acc[3] += w * x.w;
    acc[4] += w * y.x; acc[5] += w * y.y; acc[6] += w * y.z; acc[7] += w * y.w;
  }
  const float lr = fmaxf(l, 1e-30f), inv = 1.f / lr;
  uint4 out;
  uint32_t* wd = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) wd[j] = mma::pack2<T>(acc[2 * j] * inv, acc[2 * j + 1] * inv);
  const int qi = static_cast<int>(row % p.Lq);
  const int bh = static_cast<int>(row / p.Lq);
  const int b = bh / p.H, h = bh % p.H;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + qi * p.o_sl + c;
  *reinterpret_cast<uint4*>(o) = out;
  if (kTrain && c == 0) {
    p.m_out[row] = m;
    p.l_out[row] = lr;
  }
}

template <typename T, int D, int NK, int WG, bool kMask>
__global__ void __launch_bounds__(Cfg<D, NK, WG, kMask>::kThreads,
                                  Cfg<D, NK, WG, kMask>::kMinBlocks)
    flash_attn_fwd_serve_kernel(__grid_constant__ const Args a) {
  fwd_tiles_body<T, D, NK, WG, false, kMask>(a);
}
template <typename T, int D, int NK, int WG, bool kMask>
__global__ void __launch_bounds__(Cfg<D, NK, WG, kMask>::kThreads,
                                  Cfg<D, NK, WG, kMask>::kMinBlocks)
    flash_attn_fwd_train_kernel(__grid_constant__ const Args a) {
  fwd_tiles_body<T, D, NK, WG, true, kMask>(a);
}

// -- the decode form (Lq <= 4), on the CUDA cores -----------------------------
constexpr int kDecRows = 4;    // query rows, at most
constexpr int kDecWarps = 4;   // warps a block, at most; a block takes one (b, h)

// A decode warp's shared memory at Lq query rows: its 32 K and 32 V rows in
// their dtype (rows padded to D + 8 elements: 16-byte row starts, and a
// lane's 16-byte reads of its own row meet no bank conflict), its chunk's
// probabilities (Lq x 32, f32), then its m and l (Lq each). For the merge
// the warp's f32 sums (Lq x D) reuse its K and V rows.
template <int D>
__host__ __device__ constexpr int dec_warp_bytes(int Lq) {
  return (2 * 32 * (D + 8) * 2 + Lq * 32 * 4 + 2 * Lq * 4 + 15) / 16 * 16;
}

// rows [row0, row0 + 32) of an (n_rows, D) matrix with row stride ld into
// dst (pitch D + 8), by one warp; rows at or past n_rows are 0. vec: 16-byte
// cp.async copies (the caller commits and waits); else element loads.
template <typename T, int D>
__device__ __forceinline__ void warp_rows(T* dst, const T* src, long long ld, int row0,
                                          int n_rows, int vec, int lane) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    T* d = dst + r * (D + 8) + c;
    if (row0 + r < n_rows) {
      const T* src_r = src + (row0 + r) * ld + c;
      if (vec) {
        mma::cp_async16(d, src_r);
      } else {
        uint4 buf;
        T* e = reinterpret_cast<T*>(&buf);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = src_r[j];
        *reinterpret_cast<uint4*>(d) = buf;
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// One block per (b, h), of min(4, ceil(Lk / 32)) warps. Warp w takes the
// 32-key chunks at 32 w, 32 (w + warps), ... of the keys, lane j key j of
// a chunk: the chunk's K and V rows, its mask bytes and q are all in
// flight at once; lane j scores its key for every query row, the warp
// takes each row's max and sum by shuffles, and P V gives each lane D / 32
// output columns. The warps' partials (m, l and f32 sums) are merged in
// warp order, as the long form merges its splits.
template <typename T, int D, int ROWS, bool kTrain, bool kMask>
__device__ __forceinline__ void fwd_dec_body(const Params& p) {
  constexpr int P = D + 8;
  constexpr int C = D / 32;  // output columns a lane
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Lq = p.Lq, Lk = p.Lk;
  const int wbytes = dec_warp_bytes<D>(Lq);
  float* sQ = reinterpret_cast<float*>(fwd_smem);
  unsigned char* wb = fwd_smem + Lq * D * 4;
  T* sK = reinterpret_cast<T*>(wb + warp * wbytes);
  T* sV = sK + 32 * P;
  float* sP = reinterpret_cast<float*>(sV + 32 * P);
  auto m_of = [&](int w) { return reinterpret_cast<float*>(wb + w * wbytes + 2 * 32 * P * 2) + Lq * 32; };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const KeyRule rule{kMask ? p.mask + b * p.m_sb : nullptr, p.m_sq, p.m_sk, Lq, Lk, Lk - Lq,
                     p.causal};

  const int stride = 32 * nw;  // keys from one of a warp's chunks to its next
  int k0 = 32 * warp;          // < Lk: a block has no warp without keys
  warp_rows<T, D>(sK, k, p.k_sl, k0, Lk, p.vec, lane);
  warp_rows<T, D>(sV, v, p.v_sl, k0, Lk, p.vec, lane);
  mma::cp_async_commit();
  for (int i = threadIdx.x; i < Lq * D; i += blockDim.x) sQ[i] = to_f32(q[(i / D) * p.q_sl + i % D]);
  __syncthreads();  // q is in

  float m[ROWS], l[ROWS], acc[ROWS][C];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  for (;;) {
    const int kj = k0 + lane;
    uint32_t kept = 0u;  // bit r: row r takes the lane's key (its mask bytes, read now)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if ((ROWS == 1 || r < Lq) && kj < Lk && rule(r, kj) == kKept) kept |= 1u << r;
    mma::cp_async_wait_all();
    __syncwarp();  // the chunk's rows are in

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 kv = *reinterpret_cast<const uint4*>(sK + lane * P + 8 * c);
      const T* ke = reinterpret_cast<const T*>(&kv);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = to_f32(ke[e]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (ROWS == 1 || r < Lq) {
          const float4 qa = *reinterpret_cast<const float4*>(sQ + r * D + 8 * c);
          const float4 qb = *reinterpret_cast<const float4*>(sQ + r * D + 8 * c + 4);
          const float qf[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) s[r] = fmaf(qf[e], kf[e], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (ROWS == 1 || r < Lq) {
        const float x = kj >= Lk ? -INFINITY : (kept >> r) & 1u ? s[r] * p.scale : kMasked;
        const float m_new = fmaxf(m[r], warp_max(x));
        float pr = ex2((x - m_new) * kLog2e);  // (x - m) first: exactly 1 where x = m
        const float alpha = ex2((m[r] - m_new) * kLog2e);
        l[r] = alpha * l[r] + warp_sum(pr);
        m[r] = m_new;
        if (kTrain && p.drop.on) pr *= p.drop.scale(p.drop.row(r), kj);
        sP[r * 32 + lane] = to_f32(from_f32<T>(pr));  // p z rounded to T
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
      }
    }
    __syncwarp();
    const int nk = min(32, Lk - k0);
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = to_f32(sV[j * P + C * lane + c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (ROWS == 1 || r < Lq) {
          const float pj = sP[r * 32 + j];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
    __syncwarp();  // the chunk is consumed
    k0 += stride;
    if (k0 >= Lk) break;
    warp_rows<T, D>(sK, k, p.k_sl, k0, Lk, p.vec, lane);
    warp_rows<T, D>(sV, v, p.v_sl, k0, Lk, p.vec, lane);
    mma::cp_async_commit();
  }

  // the warp's partial: f32 sums over its K and V rows, then m and l
  float* sAcc = reinterpret_cast<float*>(sK);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (ROWS == 1 || r < Lq) {
#pragma unroll
      for (int c = 0; c < C; ++c) sAcc[r * D + C * lane + c] = acc[r][c];
      if (lane == 0) {
        m_of(warp)[r] = m[r];
        m_of(warp)[Lq + r] = l[r];
      }
    }
  }
  __syncthreads();
  // the warps' partials merged in warp order: a row whose keys are all
  // removed has m = -1e30 in every warp, so each adds its keys' sum whole
  for (int i = threadIdx.x; i < Lq * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float mm = -INFINITY;
    for (int w = 0; w < nw; ++w) mm = fmaxf(mm, m_of(w)[r]);
    float ll = 0.f, oo = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float e = expf(m_of(w)[r] - mm);
      ll += e * m_of(w)[Lq + r];
      oo += e * reinterpret_cast<const float*>(wb + w * wbytes)[r * D + c];
    }
    const float lr = fmaxf(ll, 1e-30f);
    o[r * p.o_sl + c] = from_f32<T>(oo / lr);
    if (kTrain && c == 0) {
      p.m_out[static_cast<long long>(bh) * Lq + r] = mm;
      p.l_out[static_cast<long long>(bh) * Lq + r] = lr;
    }
  }
}

template <typename T, int D, int ROWS, bool kMask>
__global__ void __launch_bounds__(32 * kDecWarps) flash_attn_fwd_serve_dec_kernel(Params p) {
  fwd_dec_body<T, D, ROWS, false, kMask>(p);
}
template <typename T, int D, int ROWS, bool kMask>
__global__ void __launch_bounds__(32 * kDecWarps) flash_attn_fwd_train_dec_kernel(Params p) {
  fwd_dec_body<T, D, ROWS, true, kMask>(p);
}

// -- launchers ------------------------------------------------------------------
template <typename T, int D, int ROWS, bool kTrain, bool kMask>
int launch_dec_rows(const Params& p, cudaStream_t stream) {
  void (*kernel)(Params);
  if constexpr (kTrain) {
    kernel = flash_attn_fwd_train_dec_kernel<T, D, ROWS, kMask>;
  } else {
    kernel = flash_attn_fwd_serve_dec_kernel<T, D, ROWS, kMask>;
  }
  const int warps = (p.Lk + 31) / 32 < kDecWarps ? (p.Lk + 31) / 32 : kDecWarps;
  const int bytes = p.Lq * D * 4 + warps * dec_warp_bytes<D>(p.Lq);
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  kernel<<<p.B * p.H, 32 * warps, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the decode form compiled for one query row (the decoder's and
// KnowledgeAttention's calls) and for four: every row a template holds
// costs each lane its instructions
template <typename T, int D, bool kTrain, bool kMask>
int launch_dec(const Params& p, cudaStream_t stream) {
  if (p.Lq == 1) return launch_dec_rows<T, D, 1, kTrain, kMask>(p, stream);
  return launch_dec_rows<T, D, kDecRows, kTrain, kMask>(p, stream);
}

template <typename T, int D, int NK, int WG, bool kTrain, bool kMask>
int launch_tiles(const Args& a, cudaStream_t stream) {
  using C = Cfg<D, NK, WG, kMask>;
  void (*kernel)(Args);
  if constexpr (kTrain) {
    kernel = flash_attn_fwd_train_kernel<T, D, NK, WG, kMask>;
  } else {
    kernel = flash_attn_fwd_serve_kernel<T, D, NK, WG, kMask>;
  }
  int err = allow_smem(kernel, C::kBytes);
  if (err != 0) return err;
  const int resident = C::kMinBlocks * a.sms;
  kernel<<<a.n_units < resident ? a.n_units : resident, C::kThreads, C::kBytes, stream>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || a.splits == 1) return err;
  const long long threads = static_cast<long long>(a.p.B) * a.p.H * a.p.Lq * (D / 8);
  flash_attn_fwd_merge_kernel<T, D, kTrain>
      <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(a.p, a.part, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// The tile and long forms' two shapes: 64-query units of one consumer
// warpgroup over 64-key tiles; and, for long keys over more than 64
// queries, 128-query units of two warpgroups sharing each K/V tile (half
// the reads of K and V from L2), over 128-key tiles (64 at D = 128)
template <typename T, int D, bool kTrain, bool kMask>
int launch_tc_m(const Args& a, cudaStream_t stream) {
  if (a.form == fwd::kFormDecode) return launch_dec<T, D, kTrain, kMask>(a.p, stream);
  if (a.form == fwd::kFormTiles)
    return launch_tiles<T, D, fwd::key_tile(fwd::kFormTiles, D), 1, kTrain, kMask>(a, stream);
  if (a.form == fwd::kFormNarrowTiles)
    return launch_tiles<T, D, 32, 1, kTrain, kMask>(a, stream);
  return launch_tiles<T, D, fwd::key_tile(fwd::kFormWideTiles, D), 2, kTrain, kMask>(a, stream);
}

// bf16 and f16 on the Hopper design
template <typename T, int D, bool kTrain>
int launch_tc(const Args& a, cudaStream_t stream) {
  return a.p.mask != nullptr ? launch_tc_m<T, D, kTrain, true>(a, stream)
                             : launch_tc_m<T, D, kTrain, false>(a, stream);
}

}  // namespace

namespace vivqa::fwd {

#if VIVQA_BUILDS_KERNELS
// f32 takes the SIMT template (no TF32 rounding), bf16 and f16 the Hopper
// design.
template <typename T, int D>
int serve_pair(const Args& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    return launch_simt<T, D, false>(a.p, stream);
  } else {
    return launch_tc<T, D, false>(a, stream);
  }
}

template <typename T, int D>
int train_pair(const Args& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    return launch_simt<T, D, true>(a.p, stream);
  } else {
    return launch_tc<T, D, true>(a, stream);
  }
}

#define VIVQA_SERVE(T, D) template int serve_pair<T, D>(const Args&, cudaStream_t);
#define VIVQA_TRAIN(T, D) template int train_pair<T, D>(const Args&, cudaStream_t);
// parts 1-12: the serving then the training launcher of bf16 at D = 32,
// 64, 128, then of f16 at the same; 13: f32 at every D
#if VIVQA_BUILDS_PART(1)
VIVQA_SERVE(__nv_bfloat16, 32)
#endif
#if VIVQA_BUILDS_PART(2)
VIVQA_TRAIN(__nv_bfloat16, 32)
#endif
#if VIVQA_BUILDS_PART(3)
VIVQA_SERVE(__nv_bfloat16, 64)
#endif
#if VIVQA_BUILDS_PART(4)
VIVQA_TRAIN(__nv_bfloat16, 64)
#endif
#if VIVQA_BUILDS_PART(5)
VIVQA_SERVE(__nv_bfloat16, 128)
#endif
#if VIVQA_BUILDS_PART(6)
VIVQA_TRAIN(__nv_bfloat16, 128)
#endif
#if VIVQA_BUILDS_PART(7)
VIVQA_SERVE(__half, 32)
#endif
#if VIVQA_BUILDS_PART(8)
VIVQA_TRAIN(__half, 32)
#endif
#if VIVQA_BUILDS_PART(9)
VIVQA_SERVE(__half, 64)
#endif
#if VIVQA_BUILDS_PART(10)
VIVQA_TRAIN(__half, 64)
#endif
#if VIVQA_BUILDS_PART(11)
VIVQA_SERVE(__half, 128)
#endif
#if VIVQA_BUILDS_PART(12)
VIVQA_TRAIN(__half, 128)
#endif
#if VIVQA_BUILDS_PART(13)
VIVQA_SERVE(float, 32)
VIVQA_TRAIN(float, 32)
VIVQA_SERVE(float, 64)
VIVQA_TRAIN(float, 64)
VIVQA_SERVE(float, 128)
VIVQA_TRAIN(float, 128)
#endif
#if defined(VIVQA_PART) && VIVQA_PART > 13
#error "flash_attn_fwd.cu has kernel parts 1-13 (ops/cuda_build.py: PARTS)"
#endif
#endif  // VIVQA_BUILDS_KERNELS

}  // namespace vivqa::fwd

#if VIVQA_BUILDS_ENTRY
namespace {

template <typename T>
int run(const Args& a, int head_dim, bool train, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return train ? fwd::train_pair<T, 32>(a, stream) : fwd::serve_pair<T, 32>(a, stream);
    case 64:
      return train ? fwd::train_pair<T, 64>(a, stream) : fwd::serve_pair<T, 64>(a, stream);
    case 128:
      return train ? fwd::train_pair<T, 128>(a, stream) : fwd::serve_pair<T, 128>(a, stream);
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



// The units and tensor maps of a bf16/f16 call in the tile and long forms
// (``form`` kFormTiles, kFormWideTiles or kFormNarrowTiles), then the
// launch; in the decode form and in f32 the Params alone.
int launch(Args& a, int dtype, int head_dim, bool train, int form, int tiles_per_split,
           float* part, cudaStream_t stream) {
  Params& p = a.p;
  a.form = form;
  a.part = part;
  a.splits = 1;
  if (dtype != 0 && (form < fwd::kFormDecode || form > fwd::kFormNarrowTiles ||
                     (form == fwd::kFormDecode && p.Lq > kDecRows) ||
                     (form == fwd::kFormNarrowTiles && p.Lk > 32)))
    return -1;
  if (dtype != 0 && form != fwd::kFormDecode) {
    if (tiles_per_split < 1) return -1;
    const void* ptrs[4] = {p.q, p.k, p.v, p.o};
    CUtensorMap* maps[4] = {&a.q, &a.k, &a.v, &a.o};
    const int lens[4] = {p.Lq, p.Lk, p.Lk, p.Lq};
    const long long strides[12] = {p.q_sb, p.q_sh, p.q_sl, p.k_sb, p.k_sh, p.k_sl,
                                   p.v_sb, p.v_sh, p.v_sl, p.o_sb, p.o_sh, p.o_sl};
    for (int i = 0; i < 4; ++i) {
      const int err = tma::encode_map(maps[i], ptrs[i], dtype, head_dim, p.B, p.H, lens[i],
                                      strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]);
      if (err != 0) return err;
    }
    const int nk = fwd::key_tile(form, head_dim);
    const int unit_rows = form == fwd::kFormWideTiles ? 128 : 64;
    a.n_qt = (p.Lq + unit_rows - 1) / unit_rows;
    a.n_kt = (p.Lk + nk - 1) / nk;
    a.tiles_per_split = tiles_per_split < a.n_kt ? tiles_per_split : a.n_kt;
    a.splits = (a.n_kt + a.tiles_per_split - 1) / a.tiles_per_split;
    if (a.splits > 1 && part == nullptr) return -1;
    a.n_units = p.B * p.H * a.n_qt * a.splits;
    a.mask_mode = tma::mask_mode(p.mask, p.m_sb, p.m_sq, p.m_sk);
    int dev = 0;
    int err = static_cast<int>(cudaGetDevice(&dev));
    if (err == 0)
      err = static_cast<int>(cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount, dev));
    if (err != 0) return err;
  }
  switch (dtype) {
    case 0:
      return run<float>(a, head_dim, train, stream);  // SIMT: no TF32 rounding
    case 1:
      return run<__nv_bfloat16>(a, head_dim, train, stream);
    case 2:
      return run<__half>(a, head_dim, train, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// strides: 15 element strides, in order q (b, h, l), k (b, h, l),
// v (b, h, l), o (b, h, l), mask (b, q, k); the mask's are ignored when
// mask is null. vec = 1 promises that q, k and v and all their b/h/l
// strides are 16-byte aligned, so tiles load as 16-byte vectors (f32 and
// the decode form). bf16 and f16 take the form that
// ops/flash_attention.py:forward_plan chose: form 0 (decode, Lq <= 4), 1
// (tile and long over 64-query units and 64-key tiles), 2 (tile and long
// over 128-query units and 128-key tiles, 64 at D = 128) or 3 (tile over
// 64-query units and one 32-key tile, Lk <= 32); in forms 1 to 3 q, k, v
// and o are read and written by TMA, so their bases on 16 bytes and their
// strides in multiples of 16 bytes, which the wrapper meets by copying,
// and each (b, h, query tile) takes its key tiles tiles_per_split at a
// time: more than one split writes f32 partials to part (else null),
// which a second kernel merges; f32 ignores the two. Returns 0, the first
// launch's cudaGetLastError(), 999 / 1000 + CUresult for a tensor map the
// CUDA driver refused, or -1 for a head dim, dtype or plan this file does
// not take (form 0 past 4 queries, form 3 past 32 keys among them).
extern "C" int vivqa_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* part, const void* mask, int dtype, int head_dim,
                                    int B, int H, int Lq, int Lk, const long long* strides,
                                    int causal, int vec, float scale, int form,
                                    int tiles_per_split, void* stream) {
  Args a;
  a.p = make_params(q, k, v, o, mask, B, H, Lq, Lk, strides, causal, vec, scale);
  return launch(a, dtype, head_dim, false, form, tiles_per_split, part,
                static_cast<cudaStream_t>(stream));
}

// The training forward: as vivqa_flash_attn_fwd, and also writes m and l,
// each (B*H, Lq) f32 contiguous, and applies dropout when dropout = 1:
// key (q, k) is kept iff mix32(mix32(key ^ q) ^ k) >= threshold, and a
// kept probability is multiplied by inv_keep.
extern "C" int vivqa_flash_attn_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                        float* m, float* l, float* part, const void* mask,
                                        int dtype, int head_dim, int B, int H, int Lq, int Lk,
                                        const long long* strides, int causal, int vec,
                                        float scale, int dropout, unsigned threshold,
                                        unsigned key, float inv_keep, int form,
                                        int tiles_per_split, void* stream) {
  Args a;
  a.p = make_params(q, k, v, o, mask, B, H, Lq, Lk, strides, causal, vec, scale);
  a.p.m_out = m;
  a.p.l_out = l;
  a.p.drop.on = dropout;
  a.p.drop.threshold = threshold;
  a.p.drop.key = key;
  a.p.drop.inv_keep = inv_keep;
  return launch(a, dtype, head_dim, true, form, tiles_per_split, part,
                static_cast<cudaStream_t>(stream));
}
#endif  // VIVQA_BUILDS_ENTRY
