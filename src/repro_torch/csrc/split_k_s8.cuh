// The skinny int8 body: the INT8 x INT8 -> INT32 branches of
// dbb_gemm_skinny.cu (int8 x on the INT8 DBB values plane) and
// sta_gemm_skinny.cu (int8 x, a dense int8 w) at M <= 32, on the integer
// tensor cores. out = finish<TO>(sum_k x[m, k] W[k, n]) (common.cuh: int32
// raw or truncated, f32 after scale -> bias -> act, or int8 rounded half to
// even and clipped to +-127).
//
// What bounds it on the H100: bytes, in principle. At M <= 32 the work is at
// most 64 operations per weight byte (the card's int8 balance is ~590), so the
// least time is the weight stream (1 byte a dense weight; values + bitmask =
// 1.0 byte a weight on the INT8 plane at k = 4) over 3.35 TB/s. At the decode
// shapes that stream is 4-17 MB, a few microseconds, so a call is as much
// latency (the launch, the first loads, the slices' meeting) as bandwidth.
// Measured (PERF.md): 4-10x the byte bound at olmo-1b's layer GEMMs, about the
// same time at M 8 and 24; the fixed latency of the two launches and a slice's
// short stage pipeline (2-8 stages), not the bytes, sets the time.
//
// Design (dbb_gemm_skinny.cu's float split-K body, on int8):
//   - A block owns 64 output columns, every row of the batch (so each
//     weight byte is read from memory once per call at any M) and one of S
//     = splits(K, N) slices of K (S <= 8, a rule on K and N alone, so that
//     the grid holds about 2 blocks per SM: N 2048 runs 256 blocks). A
//     slice is whole stages: slice s takes stages [s T / S, (s + 1) T / S)
//     of T = ceil(K / 128).
//   - A stage is 128 K: 16 DBB blocks, one 128-byte swizzle row of int8.
//     It streams through a ring of kStages shared-memory slots, kAhead
//     stages in flight past the one converted. Thread 0 issues a stage as
//     TMA boxes against the slot's mbarrier (DBB: bitmask [16, 64] int32 and
//     values [16 nnz, 64] int8; dense: w [128, 64]; and x [M rounded up to
//     8, 128] 128-byte swizzled; TMA zero-fills past K, N and M) where
//     every row is a 16-byte multiple; else every thread issues cp.async
//     copies of 4 or 1 bytes with zero-fill (int8 N % 16, the classifier's
//     N 10; K % 16 == 8 on the dense branch), x swizzled as TMA would.
//   - The producers are tc_gemm_s8.cuh's, shared: 128 threads each write
//     4 columns x 16 K of the stage's K-major int8 W^T tile [64][128]
//     (128-byte swizzled), the dense w by 4 x 4 byte transposes
//     (transpose_stage), the DBB planes by byte-permute selectors
//     (expand_stage: slot min(rank, nnz - 1) at a kept position, a zero
//     byte at a dropped one).
//   - The product: mma.sync.m16n8k32.s32.s8.s8 computes out^T = W^T x^T:
//     A is 16 columns of W^T (ldmatrix.x4, 32 int8 read as 16 b16), B is 8
//     rows of x, already K-contiguous (two 32-bit loads a lane). 16 warps =
//     4 column groups x the stage's 4 k32 steps; each keeps int32
//     accumulators for ceil(M / 8) 8-row n-tiles. Iteration i converts
//     stage i into one of two W^T tiles while the warps multiply stage
//     i - 1 from the other, one block barrier apart.
//   - The slices meet: each block adds its four k32 steps' partial [M, 64]
//     tiles in shared memory and stores the sum to a workspace [S, M, N]
//     int32 that the wrapper allocates; a second launch adds the S slices
//     and runs the epilogue, launched as a programmatic dependent launch
//     so that its launch overlaps the body's last blocks (it waits for
//     their stores). No atomics. (A cluster of the S blocks adding
//     their tiles over distributed shared memory, one launch and no
//     workspace, was slower on the card at S = 8: PERF.md.) Integer
//     sums are exact in any order (the mma wraps mod 2^32 as the adds of
//     the plain version do), so every output equals the plain version's bit
//     for bit whatever S, M or the K order.
#pragma once

#include "split_k.cuh"
#include "tc_gemm_s8.cuh"

namespace repro {
namespace splitk8 {

using namespace sm90;
namespace sk = splitk;

constexpr int kCols = 64;                      // output columns a block
constexpr int kStageK = 128;                   // K a stage
constexpr int kStageKb = kStageK / kDbbBlock;  // DBB blocks a stage: 16
constexpr int kThreads = 512;  // 16 warps: 4 column groups x 4 k32 steps
constexpr int kStages = 6;     // the ring's slots
constexpr int kAhead = kStages - 2;      // stages in flight past the current
constexpr int kWorkers = 128;            // threads writing a W^T tile
constexpr int kWtBytes = kCols * kStageK;  // one K-major int8 W^T tile
static_assert(kStageK == kSwizzleRow, "a stage's K is one swizzle row");
static_assert(tc8::BK == kStageK && tc8::BN == kCols &&
                  tc8::kBlocks == kStageKb,
              "tc_gemm_s8.cuh's producers write this stage's tile");
static_assert(kWorkers == (kCols / 4) * (kStageK / 16),
              "a producer task is 4 columns x 16 K");

// The K slices of a call: doubled while the grid stays within 2 blocks per
// SM and every slice keeps at least two stages, up to 8. A rule on K and N
// alone.
__host__ __device__ inline int splits(int K, int N) {
  const int stages = (K + kStageK - 1) / kStageK;
  const int tiles = (N + kCols - 1) / kCols;
  int s = 1;
  while (s < sk::kMaxSplit && tiles * 2 * s <= 2 * sk::kSMs &&
         stages >= 2 * 2 * s)
    s *= 2;
  return s;
}

// A ring slot: the stage's weight data as stored (DBB: bitmask [16][64]
// int32, then values [16 nnz][64]; dense: w [128][64]), then x [mp][128]
// on a 1024-byte boundary (the swizzle's atom).
__host__ __device__ inline int raw_bytes(bool dbb, int nnz) {
  return dbb ? tc8::kMaskBytes + kStageKb * nnz * kCols : kStageK * kCols;
}
__host__ __device__ inline int slot_bytes(bool dbb, int nnz, int mp) {
  return (raw_bytes(dbb, nnz) + mp * kStageK + 1023) / 1024 * 1024;
}
// dynamic shared memory: the ring, two W^T tiles, the DBB expansion
// table, the ring's mbarriers, and the slack that aligns the ring to 1024
// bytes (the slices' partial tiles reuse the ring)
__host__ __device__ inline int smem_bytes(bool dbb, int nnz, int mp) {
  return kStages * slot_bytes(dbb, nnz, mp) + 2 * kWtBytes + 256 * 4 +
         kStages * 8 + 1024;
}

struct Args {
  const int8_t* x;
  const int8_t* w;         // dense w [K, N], or values [K/8 * nnz, N]
  const int32_t* bitmask;  // DBB: [K/8, N]; dense: unused
  const float* scale;
  const float* bias;
  void* out;
  int* work;  // [S, M, N]: each K slice's partial sums
  int M, K, N, nnz, act;
  int tma;  // 1: the stages come as TMA boxes (every row 16-byte aligned)
  int lv_x, lv_w, lv_mask;  // log2 of the copy widths (copy_tile's 4, 2, 0)
};

// the TMA boxes: w (dense w, or the values plane), the bitmask, x
struct Maps {
  CUtensorMap w, mask, x;
};

// x rows [0, mp) x K [k0, k0 + 128) into a 128-byte swizzled tile (16-byte
// chunk c of row r at c ^ (r % 8), as TMA lays it); rows >= M and K >= K
// read as zero. One copy moves 1 << lv bytes: 16 (K % 16 == 0) or 4 (K % 8
// == 0, the wrappers' rule).
__device__ __forceinline__ void copy_x(uint8_t* dst, const int8_t* x, int k0,
                                       int M, int K, int mp, int lv) {
  const int sh = 7 - lv;  // log2 of the copies a row
  for (int i = threadIdx.x; i < mp << sh; i += blockDim.x) {
    const int r = i >> sh, b = (i - (r << sh)) << lv;  // row, byte in it
    const int k = k0 + b;
    const bool ok = r < M && k < K;
    const int8_t* g = x + (ok ? (size_t)r * K + k : 0);
    uint8_t* d = dst + r * kStageK + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
    if (lv == 4)
      sk::cp_async16(d, g, ok);
    else
      sk::cp_async4(d, g, ok);
  }
}

template <typename TO, bool kDbb>
__global__ void __launch_bounds__(kThreads, 2)
skinny_s8_kernel(const Args a, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int M = a.M, K = a.K, N = a.N, nnz = a.nnz;
  const int mp = (M + 7) / 8 * 8;
  const int raw = raw_bytes(kDbb, nnz), slot = slot_bytes(kDbb, nnz, mp);
  uint8_t* wt = smem + kStages * slot;  // the two W^T tiles
  uint32_t* table = reinterpret_cast<uint32_t*>(wt + 2 * kWtBytes);
  const uint32_t bars = smem_u32(table + 256);
  const int n0 = blockIdx.x * kCols;
  // this block's K slice
  const int S = gridDim.y, slice = blockIdx.y;
  const int stages = (K + kStageK - 1) / kStageK;
  const int st0 = slice * stages / S;
  const int n_st = (slice + 1) * stages / S - st0;

  if (kDbb && tid < 256) table[tid] = tc8::expand_selectors(tid, nnz);
  if (a.tma && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // issue the copies of stage `it` of the slice into slot it % kStages:
  // its TMA boxes (thread 0; the slot's mbarrier counts their bytes), or
  // every thread's cp.async copies (one group per call, issued or not)
  auto issue = [&](int it) {
    const int st = st0 + it;
    uint8_t* sb = smem + (it % kStages) * slot;
    if (a.tma) {
      if (tid == 0 && it < n_st) {
        const uint32_t bar = bars + 8 * (it % kStages);
        mbar_arrive_tx(bar, raw + mp * kStageK);
        if (kDbb) {
          tma_load(smem_u32(sb), &maps.mask, bar, n0, st * kStageKb);
          tma_load(smem_u32(sb + tc8::kMaskBytes), &maps.w, bar, n0,
                   st * kStageKb * nnz);
        } else {
          tma_load(smem_u32(sb), &maps.w, bar, n0, st * kStageK);
        }
        tma_load(smem_u32(sb + raw), &maps.x, bar, st * kStageK, 0);
      }
      return;
    }
    if (it < n_st) {
      char* d = reinterpret_cast<char*>(sb);
      if (kDbb) {
        const int kb_total = K / kDbbBlock;
        sk::copy_tile(d, reinterpret_cast<const char*>(a.bitmask),
                      st * kStageKb, kStageKb, kb_total, n0, kCols, N, 4,
                      a.lv_mask);
        sk::copy_tile(d + tc8::kMaskBytes,
                      reinterpret_cast<const char*>(a.w),
                      st * kStageKb * nnz, kStageKb * nnz, kb_total * nnz,
                      n0, kCols, N, 1, a.lv_w);
      } else {
        sk::copy_tile(d, reinterpret_cast<const char*>(a.w), st * kStageK,
                      kStageK, K, n0, kCols, N, 1, a.lv_w);
      }
      copy_x(sb + raw, a.x, st * kStageK, M, K, mp, a.lv_x);
    }
    sk::cp_async_commit();
  };

  // mma: warp -> 16-column group cg, the stage's k32 step kq; fragment
  // coordinates g, t
  const int cg = warp % 4, kq = warp / 4, g = lane / 4, t = lane % 4;
  const int ntiles = mp / 8;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  // ldmatrix row of this lane in a W^T tile: column cg * 16 + (lane % 8)
  // (+ 8 for matrices 1, 3), 16-byte chunk 2 kq (+ 1 for matrices 2, 3)
  const int ar = cg * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
  const int ak = 2 * kq + lane / 16;
  const uint32_t a_off = ar * kStageK + ((ak ^ (ar & 7)) << 4);

  for (int s = 0; s < kAhead; ++s) issue(s);
  // iteration it converts stage it and multiplies stage it - 1
  for (int it = 0; it <= n_st; ++it) {
    if (it < n_st) {
      if (a.tma)
        mbar_wait(bars + 8 * (it % kStages), (it / kStages) & 1);
      else
        sk::cp_async_wait<kAhead - 1>();
    }
    __syncthreads();  // stage it landed; stage it - 2's slot and the W^T
                      // tile of stage it - 2 are free
    issue(it + kAhead);
    if (it < n_st && tid < kWorkers) {
      const uint8_t* sb = smem + (it % kStages) * slot;
      uint8_t* tile = wt + (it & 1) * kWtBytes;
      if constexpr (kDbb) {
        if (nnz <= 4)
          tc8::expand_stage<4>(sb, tile, table, nnz, tid);
        else
          tc8::expand_stage<8>(sb, tile, table, nnz, tid);
      } else {
        tc8::transpose_stage(sb, tile, tid);
      }
    }
    if (it > 0) {  // stage it - 1: its W^T tile and its x rows
      const uint8_t* xs = smem + ((it - 1) % kStages) * slot + raw;
      uint32_t af[4];
      sk::ldmatrix_x4(af, smem_u32(wt + ((it - 1) & 1) * kWtBytes + a_off));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= ntiles) break;
        const int r = nt * 8 + g;  // x row: K bytes 32 kq + 4 t (+ 16)
        const uint8_t* xr = xs + r * kStageK + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            xr + (((2 * kq) ^ (r & 7)) << 4));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            xr + (((2 * kq + 1) ^ (r & 7)) << 4));
        sk::mma_s8_16832(acc[nt], af, b0, b1);
      }
    }
  }
  sk::cp_async_wait<0>();
  // the slices' sum may be scheduled (it waits for this grid's stores)
  asm volatile("griddepcontrol.launch_dependents;");
  __syncthreads();

  // the block's partial [mp, 64] tile: the four k32 steps' sums (the ring
  // is free: every stage issued was consumed)
  int* part4 = reinterpret_cast<int*>(smem);  // [4][mp][64]
  int* part = part4 + 4 * mp * kCols;         // [mp][64]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (nt >= ntiles) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = nt * 8 + 2 * t + (i & 1);
      const int c = cg * 16 + g + 8 * (i >> 1);
      part4[(kq * mp + r) * kCols + c] = acc[nt][i];
    }
  }
  __syncthreads();
  const int tile = mp * kCols;
  for (int e = tid; e < tile; e += kThreads)
    part[e] = part4[e] + part4[tile + e] + part4[2 * tile + e] +
              part4[3 * tile + e];
  __syncthreads();
  for (int e = tid; e < M * kCols; e += kThreads) {
    const int m = e / kCols, n = n0 + e % kCols;
    if (n < N) a.work[((size_t)slice * M + m) * N + n] = part[e];
  }
}

// out = finish(the S slices' partial sums added)
template <typename TO>
__global__ void __launch_bounds__(256)
reduce_kernel(const int* __restrict__ work, int S, int M, int N,
              const float* __restrict__ scale, const float* __restrict__ bias,
              int act, TO* __restrict__ out) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  // launched early (programmatic dependent launch): wait until the body's
  // grid has finished and its workspace stores are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (i >= mn) return;
  int sum = work[i];
  for (int s = 1; s < S; ++s) sum += work[s * mn + i];
  out[i] = finish<TO>(sum, (int)(i % N), scale, bias, act);
}

// log2 of the widest copy of a row of `row_bytes` (the wrappers give
// 16-byte aligned bases): 16 bytes, 4 or 1
inline int copy_lv(size_t row_bytes) {
  return row_bytes % 16 == 0 ? 4 : row_bytes % 4 == 0 ? 2 : 0;
}

// The two launches: the body on grid (column tiles, S), then the slices'
// sum. a.x, a.w (and a.bitmask for DBB), a.work (splits(K, N) * M * N
// int32), M, K, N, nnz, act and the epilogue operands set by the caller.
template <typename TO, bool kDbb>
int launch(Args a, cudaStream_t s) {
  if (a.N == 0) return (int)cudaSuccess;  // no output
  const int mp = (a.M + 7) / 8 * 8;
  const int S = splits(a.K, a.N);
  a.lv_x = copy_lv((size_t)a.K);
  a.lv_w = copy_lv((size_t)a.N);
  a.lv_mask = copy_lv((size_t)a.N * 4);
  Maps maps{};
  a.tma = a.K > 0 && a.lv_x == 4 && a.lv_w == 4;
  if (a.tma) {
    const int kb = a.K / kDbbBlock;
    const bool ok =
        make_map_2d(&maps.x, a.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.M, a.K,
                    mp, kStageK, true) &&
        (kDbb ? make_map_2d(&maps.mask, a.bitmask,
                            CU_TENSOR_MAP_DATA_TYPE_INT32, 4, kb, a.N,
                            kStageKb, kCols, false) &&
                    make_map_2d(&maps.w, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                1, kb * a.nnz, a.N, kStageKb * a.nnz, kCols,
                                false)
              : make_map_2d(&maps.w, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                            a.K, a.N, kStageK, kCols, false));
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const int smem = smem_bytes(kDbb, a.nnz, mp);
  auto* kernel = skinny_s8_kernel<TO, kDbb>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3((a.N + kCols - 1) / kCols, S), kThreads, smem, s>>>(a, maps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the slices' sum, as a programmatic dependent launch: its blocks may be
  // scheduled while the body's last blocks run, hiding its launch latency
  const size_t mn = (size_t)a.M * a.N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((mn + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, reduce_kernel<TO>,
                                 static_cast<const int*>(a.work), S, a.M,
                                 a.N, a.scale, a.bias, a.act,
                                 static_cast<TO*>(a.out));
}

}  // namespace splitk8
}  // namespace repro
