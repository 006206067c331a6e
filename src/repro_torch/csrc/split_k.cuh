// Building blocks of the port's split-K bodies (dbb_gemm_skinny.cu's
// float body, dbb_gemm.cu's narrow-N f32 body, split_k_s8.cuh's int8
// body): 16-byte and 4-byte cp.async copies into shared memory, ldmatrix,
// the bf16 mma.sync.m16n8k16 and s8 m16n8k32 products, a 2-D tensor-map
// encoder for TMA boxes, and a thread-block cluster whose blocks each own
// one slice of K and sum their partial tiles through distributed shared
// memory in a fixed order.
//
// The float bodies keep a split-K result deterministic without atomics:
// the narrow body's cluster sums element e over its ranks in order 0, 1,
// ..., S - 1 in one block after a cluster barrier; the skinny body writes
// its slices to a workspace that a second launch adds in the same order.
// Two calls give the same bits, and a row's bits depend on its own
// operands and on S alone. (The int8 body's int32 sums are exact in any
// order.)
#pragma once

#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace repro {
namespace splitk {

namespace cg = cooperative_groups;
using sm90::smem_u32;

// the most K slices of a call (the largest portable cluster)
constexpr int kMaxSplit = 8;
constexpr int kSMs = 132;  // H100 SXM

// ---------------------------------------------------------------------------
// cp.async: a copy that skips the registers and completes by group; a
// source of `ok == false` writes zeros (src-size 0) and reads nothing
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + rows) x columns [n0, n0 + cols) of a row-major
// [*, N] array of esz-byte elements into a dense shared tile (row stride
// cols * esz bytes); rows >= r_end and columns >= N read as zero. Tile row
// r reads source row (r0 + r) / row_div (1 for a plain tile; the w4 group
// scales repeat each group's row for its DBB blocks). One copy moves
// 1 << lv bytes: 16 (cp.async.cg; needs N * esz % 16 == 0 and n0 on a
// 16-byte column), 4 (cp.async.ca; N * esz % 4 == 0) or 1 (a plain byte
// load and store, for int8 rows of any N). Strided over the block; cols
// and esz are powers of two, so the chunk index splits by shifts.
__device__ __forceinline__ void copy_tile(char* dst, const char* src, int r0,
                                          int rows, int r_end, int n0,
                                          int cols, int N, int esz, int lv,
                                          int row_div = 1) {
  const int row_bytes = cols * esz;
  const int sh = __ffs(row_bytes) - 1 - lv;  // log2 of the copies a row
  for (int i = threadIdx.x; i < rows << sh; i += blockDim.x) {
    const int r = i >> sh, b = (i - (r << sh)) << lv;  // row, byte in it
    const int row = r0 + r, col = n0 + b / esz;
    const bool ok = row < r_end && col < N;
    const int srow = row_div == 1 ? row : row / row_div;
    const char* g =
        src + ((size_t)(ok ? srow : 0) * N + (ok ? col : 0)) * esz;
    char* d = dst + r * row_bytes + b;
    if (lv == 4)
      cp_async16(d, g, ok);
    else if (lv == 2)
      cp_async4(d, g, ok);
    else
      *d = ok ? *g : char(0);
  }
}

// log2 of the widest cp.async copy the rows of a [*, N] array of esz-byte
// elements allow: 16 bytes (N * esz % 16 == 0; tiles start on columns that
// are multiples of 16), 4, or 1 byte (a plain load and store)
inline int copy_lv(int N, int esz) {
  if ((N * esz) % 16 == 0) return 4;
  if ((N * esz) % 4 == 0) return 2;
  return 0;
}

// four 8x8 b16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8; r[j] is matrix j in the mma fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ---------------------------------------------------------------------------
// mma.sync.m16n8k16, bf16 operands, f32 accumulators. a: the A fragment
// (row lane / 4 and + 8, columns 2 (lane % 4) (+ 1) and + 8, as bf16
// pairs with the lower column in the low half), b: the B fragment (rows
// 2 (lane % 4) (+ 1) and + 8 of column lane / 4), d: rows lane / 4 and + 8,
// columns 2 (lane % 4) and + 1.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync.m16n8k32, s8 operands, int32 accumulators (no .satfinite: the
// sum wraps mod 2^32). The fragments are m16n8k16's with each b16 element
// read as two int8: a: rows lane / 4 and + 8, K 4 (lane % 4) .. + 3 and
// + 16; b: K 4 (lane % 4) .. + 3 and + 16 of column lane / 4; d as
// mma_bf16_16816's.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The cluster: S blocks along gridDim.y, one per K slice
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// element e of `part` summed over the cluster's ranks in order 0 .. S - 1
// (call between two cluster_sync()s: after every rank wrote its part,
// before any rank leaves)
__device__ __forceinline__ float cluster_sum(float* part, int e, int S) {
  cg::cluster_group cl = cg::this_cluster();
  float sum = cl.map_shared_rank(part, 0)[e];
  for (int s = 1; s < S; ++s) sum += cl.map_shared_rank(part, s)[e];
  return sum;
}

// this block's rank in its cluster (its K slice)
__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}

// Launch `kernel` on grid (gx, S) with clusters of (1, S, 1), so that the
// S blocks of column tile x share one cluster; `smem` bytes of dynamic
// shared memory (the attribute is raised first where it passes 48 KB).
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), int gx, int S, int threads,
                   int smem, cudaStream_t stream, Act&&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, S, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

using sm90::make_map_2d;  // the TMA boxes of the planes and x

}  // namespace splitk
}  // namespace repro
