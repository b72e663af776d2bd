// The Tensor Memory Accelerator pieces shared by the port's Hopper
// attention kernels (the forward in flash_attn_fwd.cu, the one-pass
// backward in flash_attn_bwd.cu): mbarriers, TMA loads and stores of
// 64-row boxes and the bulk groups that track them, the swizzled address
// of a staged element, the mask's staging by cp.async onto a stage's
// barrier, and, on the host, the tensor maps over (B, L, H, D) storage.
//
// ops/cuda_build.py hashes every csrc/*.cuh into each library's name.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_attn_mma.cuh"

namespace vivqa {
namespace tma {

constexpr int kBoxRows = 64;  // rows of a TMA box
constexpr long long kHangCycles = 20000000000LL;  // ~10 s: a lost barrier traps, never hangs

// -- PTX: mbarriers, TMA, cp.async ------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) {
      start = clock64();
    } else if (clock64() - start > kHangCycles) {
      __trap();
    }
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// TMA store of a box from shared memory, and the bulk groups that track it
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory (it may be written again)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's writes to shared memory, visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(mma::smem_u32(dst)), "l"(src)
               : "memory");
}
// an arrival on bar once this thread's cp.async copies so far have landed
// (counted in the barrier's arrivals), so the thread need not wait for them
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// a barrier among the consumer warps alone (the producer warp never joins)
__device__ __forceinline__ void consumer_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of the 16-byte chunk c of row r in a TMA-staged tile of R
// rows: rows of 128 bytes under the 128-byte swizzle (chunk ^ row % 8; D =
// 128 as two 64-column boxes of R rows, one after the other), rows of 64
// bytes under the 64-byte swizzle at D = 32 (chunk ^ (row / 2) % 4). Tiles
// start on 1024 bytes, where the pattern repeats.
template <int D, int R = kBoxRows>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  if constexpr (D == 32) {
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  } else {
    return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
}

// The mask's staging: rows on 16 bytes with unit key stride by 16-byte
// copies; other unit-stride rows by 4-byte copies, each row stored at its
// own shift (its address mod 4) with head and tail bytes loaded; any other
// key stride (0: broadcast) byte by byte.
constexpr int kMaskRows16 = 0, kMaskWords = 1, kMaskBytes = 2;

inline int mask_mode(const void* mask, long long sb, long long sq, long long sk) {
  return mma::mask_rows_aligned16(mask, sb, sq, sk) ? kMaskRows16
         : sk == 1                                   ? kMaskWords
                                                     : kMaskBytes;
}

// Stage the mask bytes of rows [row0, row0 + 64) and keys [col0, col0 + W)
// into dst (pitch W + 16), row r at dst + r (W + 16) + shift[r], by the
// 32 lanes of the producer warp (``mode``, see kMaskWords): copies by
// cp.async, which arrive on the stage's barrier when they land, element
// loads for the rest. No byte at or past n_cols (Lk), or of a row at or
// past n_rows, is read; what is left of the tile is never used.
template <int W>
__device__ __forceinline__ void stage_mask(uint8_t* dst, uint8_t* shift, const uint8_t* mask,
                                           long long sq, long long sk, int row0, int n_rows,
                                           int col0, int n_cols, int mode, int lane) {
  constexpr int kPitch = W + 16;
  const int n = min(W, n_cols - col0);  // bytes a row
  if (mode == kMaskWords) {
    // the whole 4-byte words of each row, along the row
#pragma unroll 1
    for (int r = 0; r < kBoxRows && row0 + r < n_rows; ++r) {
      const uint8_t* src = mask + (row0 + r) * sq + col0;
      const int a = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
      const int i = min((4 - a) & 3, n) + 4 * lane;
      if (i + 4 <= n) cp_async4(dst + r * kPitch + a + i, src + i);
    }
    // the head and tail bytes and the shift of rows lane and lane + 32
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = lane + 32 * k;
      if (row0 + r >= n_rows) {
        shift[r] = 0;
        continue;
      }
      const uint8_t* src = mask + (row0 + r) * sq + col0;
      const int a = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
      const int h = min((4 - a) & 3, n);
      const int tail = h + (n - h) / 4 * 4;
      uint8_t* d = dst + r * kPitch + a;
      uint8_t head_b[3], tail_b[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        head_b[j] = j < h ? __ldg(src + j) : 0;
        tail_b[j] = tail + j < n ? __ldg(src + tail + j) : 0;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j < h) d[j] = head_b[j];
        if (tail + j < n) d[tail + j] = tail_b[j];
      }
      shift[r] = static_cast<uint8_t>(a);
    }
    return;
  }
  // 16-byte chunks (kMaskRows16, where whole) or element loads, kGroup
  // chunks a lane in flight at once; no shift
  constexpr int kChunks = W / 16;
  constexpr int kGroup = 4;
  static_assert(kBoxRows * kChunks % (32 * kGroup) == 0, "whole groups");
  shift[lane] = shift[lane + 32] = 0;
#pragma unroll 1
  for (int idx0 = lane; idx0 < kBoxRows * kChunks; idx0 += 32 * kGroup) {
    uint4 buf[kGroup];
    bool copied[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int idx = idx0 + 32 * i;
      const int r = idx / kChunks, c = (idx % kChunks) * 16;
      const int row = row0 + r, col = col0 + c;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      copied[i] = mode == kMaskRows16 && row < n_rows && col + 16 <= n_cols;
      if (copied[i]) {
        mma::cp_async16(dst + r * kPitch + c, mask + row * sq + col);
      } else if (row < n_rows) {
        uint8_t* e = reinterpret_cast<uint8_t*>(&buf[i]);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (col + j < n_cols) e[j] = __ldg(mask + row * sq + (col + j) * sk);
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int idx = idx0 + 32 * i;
      if (!copied[i])
        *reinterpret_cast<uint4*>(dst + (idx / kChunks) * kPitch + (idx % kChunks) * 16) =
            buf[i];
    }
  }
}

// -- host: tensor maps ------------------------------------------------------
// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

constexpr int kNoEncoder = 999;  // error: the CUDA driver has no tensor-map encoder
constexpr int kEncodeError = 1000;  // + the CUresult of a refused encoding

// The map of a (B, H, L, D) operand held by (b, h, l) element strides: dims
// (D, L, H, B), boxes of 64 rows by min(D, 64) columns, zero fill past L,
// the 128-byte swizzle (64-byte at D = 32). A dimension of size 1 is never
// stepped, so its stride, which torch leaves arbitrary, is given one that
// TMA takes.
inline int encode_map(CUtensorMap* map, const void* ptr, int dtype, int D, int B, int H, int L,
                      long long sb, long long sh, long long sl) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t sizes[3] = {static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(H),
                               static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2, static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint64_t extent = static_cast<cuuint64_t>(D) * 2;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && strides[i] * sizes[i] > extent) extent = strides[i] * sizes[i];
  for (int i = 0; i < 3; ++i)
    if (sizes[i] == 1) strides[i] = (extent + 15) / 16 * 16;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), sizes[0], sizes[1], sizes[2]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D < 64 ? D : 64), kBoxRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace tma
}  // namespace vivqa
