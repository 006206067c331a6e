// DBB structured-sparse GEMM, M-tiled: out = act(scale * (x @ W) + bias)
// with W[K, N] given as the DBB planes values and bitmask[K/8, N] (int32).
// Three value planes, one body (common.cuh): f32 values[K/8 * nnz, N]
// (dbb_gemm_launch), int8 values[K/8 * nnz, N] whose per-channel scale
// rides the epilogue (dbb_gemm_i8_launch), and the w4 nibble plane
// values[K/8 * nnz / 2, N] int8 with groupwise scales gscale[K/G, N]
// (dbb_gemm_w4_launch), all for float x; and int8 x on the int8 plane
// (dbb_gemm_s8_launch), the paper's INT8 x INT8 -> INT32 operator: exact
// int32 sums, output int32, f32 or int8 requantized.
//
// Replaces: src/repro/kernels/dbb_gemm/kernel.py, dbb_gemm_pallas (float
// activations: the f32 / int8 values plane and the bits=4 branch with
// _expand_nibbles / _dequant_tile; and its int8-activation branch with
// the int32 accumulator) — the prefill projections of the serving path
// (M = batch * prompt).
//
// What bounds it on the H100: at the prefill shapes (M = 512, K and N of
// 2048-8192) the work is 2·M·K·N operations on 0.8-2.5 bytes of stored
// planes per dense weight, far above the card's ~295 operations per byte,
// so it is bound by arithmetic, which only the tensor cores reach.
//
// Four bodies, chosen by the activation dtype, K and N, never by M
// (dbb_gemm_tc_body, dbb_gemm_narrow_body and dbb_gemm_s8_tc_body export
// the rules; the wrapper's tc_body, narrow_body and s8_tc_body mirror
// them):
//   - bf16 x (K % 8 == 0, which every DBB operand has, is all TMA needs of
//     x's rows) runs on the tensor-core body (tc_gemm.cuh) on all three
//     value planes: x's tiles come by TMA, producer warps decompress the
//     planes by bitmask rank straight into the shared-memory B tiles in
//     bf16 (each plane's value rounded through bf16 first, as the
//     reference casts its tile), and wgmma multiplies with f32
//     accumulators. The dense weight never exists in device memory;
//   - f32 x at N <= 16 (the CNN's classifier, N 10) runs the narrow
//     split-K body (kNarrow* below). There the plain body's 128-column
//     tile leaves 2 blocks for the card and masks 118 of its columns, and
//     the call is bound by reading x once (4 MB at convnet's B256 K4096,
//     against 60 KB of planes). A block owns 4 rows, all 16 columns and one
//     of S <= 8 slices of K (S from K alone); the slices of a row tile form
//     one thread-block cluster, so B256 runs 512 blocks. The block walks
//     its slice in chunks of 64 DBB blocks: each chunk's 1024 (block,
//     column) pairs are decompressed, four a thread, into a shared-memory
//     weight tile (their plane words loaded a chunk ahead into registers,
//     with the next chunk's activations), and each thread multiplies one
//     row's 8 activations of one DBB block by it in f32 FMA (no TF32).
//     The 64 block lanes of a row meet by a warp reduce-scatter and one
//     shared-memory add, the S slices over distributed shared memory in
//     rank order (split_k.cuh); no atomics, so two calls give equal bits,
//     and a row's bits do not depend on M. Measured (PERF.md) it runs at
//     ~17x its byte bound: a block's latency chain (plane loads,
//     decompression, the reductions, two cluster barriers) sets the time,
//     one block an SM at its 120-148 registers;
//   - int8 x with K and N multiples of 16 (x's rows and the planes' rows
//     16-byte multiples, which TMA copies) runs on the int8 tensor-core
//     body (tc_gemm_s8.cuh): the paper's INT8 x INT8 -> INT32 operator,
//     which the IMAD body below left 5-6x behind torch._int_mm at M512
//     (bound by operations against the 1979 TOP/s INT8 rate, which only
//     the tensor cores reach). A worker warpgroup decompresses each
//     stage's TMA'd plane boxes by bitmask rank into a K-major int8 B tile
//     (s8 wgmma takes no other layout) by byte permutes, exact, and wgmma
//     sums in int32: every output equals the IMAD body's. convnet's INT8
//     classifier (N 10: 10-byte plane rows) stays on the IMAD body;
//   - other f32 x and the other int8 x run the plain body below: one
//     256-thread block owns a 128 x 128 output tile and loops over K in
//     steps of 16 (two DBB blocks). Each step every thread loads one (DBB
//     block, column) pair's slots through the plane's loader (the w4
//     loader sign-extends nibbles and multiplies by the block's group
//     scale) and decompresses them from the bitmask rank straight into
//     the shared-memory weight tile, and loads eight activations into the
//     transposed shared-memory activation tile. Each thread then
//     accumulates an 8 x 8 register tile in f32 (int32 on the int8
//     branch: the tiles hold sign-extended int8 and the slots come from
//     I8Plane's integer loader, so the same body and K order serve it;
//     bound by operations against the 1979 TOP/s INT8 rate, far above
//     it); the epilogue runs on those registers before the one store of
//     the output. No state crosses blocks.
#include "common.cuh"
#include "split_k.cuh"
#include "tc_gemm.cuh"
#include "tc_gemm_s8.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kBlocksPerStep = BK / repro::kDbbBlock;

template <typename T, typename TO, typename Plane>
__global__ void __launch_bounds__(kThreads)
dbb_gemm_kernel(const T* __restrict__ x, const Plane plane,
                const int32_t* __restrict__ bitmask,
                const float* __restrict__ scale,
                const float* __restrict__ bias, TO* __restrict__ out, int M,
                int K, int N, int nnz, int act) {
  using Acc = repro::acc_t<T>;
  __shared__ Acc xs[BK][BM + 4];  // activations, transposed
  __shared__ Acc ws[BK][BN];      // decompressed weight tile

  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = t % (BN / TN), ty = t / (BN / TN);
  const int kb_total = K / repro::kDbbBlock;

  // loader roles: activations (row, 8-wide K group), weights (block, col)
  const int xr = t / (BK / 8), xk = (t % (BK / 8)) * 8;
  const int wkb = t / BN, wn = t % BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // activation tile: 128 rows x 16 K, eight per thread
      Acc v[8];
      const int m = m0 + xr, k = k0 + xk;
      if (m < M && k < K) {
        repro::load8(x + (size_t)m * K + k, v);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = Acc(0);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[xk + i][xr] = v[i];
    }
    {  // weight tile: decompress one (DBB block, column) pair per thread
      const int kb = k0 / repro::kDbbBlock + wkb, n = n0 + wn;
      uint32_t mask = 0;
      Acc slot[repro::kNnzMax];
#pragma unroll
      for (int s = 0; s < repro::kNnzMax; ++s) slot[s] = Acc(0);
      if (kb < kb_total && n < N) {
        mask = (uint32_t)bitmask[(size_t)kb * N + n];
        plane.load(kb, n, N, nnz, slot);
      }
      Acc w[repro::kDbbBlock];
      repro::decompress_block<T>(mask, slot, nnz, w);
#pragma unroll
      for (int p = 0; p < repro::kDbbBlock; ++p)
        ws[wkb * repro::kDbbBlock + p][wn] = w[p];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = repro::mac(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * (BN / TN);
      if (n < N)
        out[(size_t)m * N + n] =
            repro::finish<TO>(acc[i][j], n, scale, bias, act);
    }
  }
}

static_assert(kBlocksPerStep * BN == kThreads, "one (block, col) per thread");
static_assert(BM * (BK / 8) == kThreads, "one 8-wide load per thread");

template <typename T, typename TO, typename Plane>
void launch_t(const void* x, const Plane plane, const void* bitmask,
              const void* scale, const void* bias, void* out, int M, int K,
              int N, int nnz, int act, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dbb_gemm_kernel<T, TO, Plane><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), plane, static_cast<const int32_t*>(bitmask),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), M, K, N, nnz, act);
}

// ---------------------------------------------------------------------------
// The narrow split-K body (f32 x, N <= 16)
// ---------------------------------------------------------------------------

namespace sk = repro::splitk;

constexpr int kNarrowCols = 16;    // narrow_body's N bound: one column tile
constexpr int kNarrowRows = 4;     // rows per block
constexpr int kChunkKb = 64;       // DBB blocks per chunk: one per lane
constexpr int kNarrowThreads = kNarrowRows * kChunkKb;  // 256
constexpr int kWRow = kNarrowCols * repro::kDbbBlock + 4;  // floats a block
constexpr int kPairs = kChunkKb * kNarrowCols / kNarrowThreads;  // 4

// The K slices of a call: one per chunk of 64 DBB blocks, at most the
// portable cluster size. A rule on K alone.
int narrow_splits(int K) {
  const int chunks = (K / repro::kDbbBlock + kChunkKb - 1) / kChunkKb;
  return chunks < 1 ? 1 : chunks < sk::kMaxSplit ? chunks : sk::kMaxSplit;
}

// one reduce-scatter level over lanes `lane ^ O`: v[0 .. O) keep the half
// of v[0 .. 2 O) this lane's bit O selects, plus the partner's same half
template <int O>
__device__ __forceinline__ void reduce_scatter(float (&v)[kNarrowCols],
                                               int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <typename Plane>
__global__ void __launch_bounds__(kNarrowThreads)
dbb_gemm_narrow_kernel(const float* __restrict__ x, const Plane plane,
                       const int32_t* __restrict__ bitmask,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int M, int K, int N, int nnz, int act, int slice_kb) {
  __shared__ __align__(16) float ws[kChunkKb * kWRow];  // a chunk's weights
  __shared__ float half[kNarrowRows][kNarrowCols];
  __shared__ float part[kNarrowRows * kNarrowCols];
  const int tid = threadIdx.x, lane = tid % 32;
  const int kl = tid % kChunkKb, rr = tid / kChunkKb;  // block lane, row
  const int m = blockIdx.x * kNarrowRows + rr;
  const int rank = sk::cluster_rank(), S = gridDim.y;
  const int kb_total = K / repro::kDbbBlock;
  const int kb_begin = rank * slice_kb;
  const int kb_end = min(kb_total, kb_begin + slice_kb);
  const int chunks =
      kb_end > kb_begin ? (kb_end - kb_begin + kChunkKb - 1) / kChunkKb : 0;

  // a chunk's loads: this thread's kPairs (block, column) pairs i = tid +
  // 256 j (block i / 16, column i % 16) as stored, and its row's 8
  // activations of block kl
  repro::tc::StageSlots<Plane> pr[kPairs];
  float4 xa, xb;
  auto fetch = [&](int kb0) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = tid + kNarrowThreads * j;
      const int kb = kb0 + i / kNarrowCols, n = i % kNarrowCols;
      const bool live = kb < kb_end && n < N;
      pr[j].mask = live ? (uint32_t)bitmask[(size_t)kb * N + n] : 0u;
      repro::tc::PlaneStage<Plane>::load(plane, live ? kb : 0, live ? n : 0,
                                         N, live ? nnz : 0, pr[j].raw);
    }
    const int kb = kb0 + kl;
    if (m < M && kb < kb_end) {
      const float4* p = reinterpret_cast<const float4*>(
          x + (size_t)m * K + (size_t)kb * repro::kDbbBlock);
      xa = p[0];
      xb = p[1];
    } else {
      xa = xb = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[kNarrowCols];
#pragma unroll
  for (int c = 0; c < kNarrowCols; ++c) acc[c] = 0.f;
  if (chunks > 0) fetch(kb_begin);
  for (int ch = 0; ch < chunks; ++ch) {
    const int kb0 = kb_begin + ch * kChunkKb;
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = tid + kNarrowThreads * j;
      const int l = i / kNarrowCols, c = i % kNarrowCols;
      float slot[repro::kNnzMax], w[repro::kDbbBlock];
      repro::tc::PlaneStage<Plane>::slots(pr[j].raw, kb0 + l, nnz, slot);
      repro::decompress_block<float>(pr[j].mask, slot, nnz, w);
      float4* d = reinterpret_cast<float4*>(ws + l * kWRow + c * 8);
      d[0] = make_float4(w[0], w[1], w[2], w[3]);
      d[1] = make_float4(w[4], w[5], w[6], w[7]);
    }
    const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    __syncthreads();
    if (ch + 1 < chunks) fetch(kb0 + kChunkKb);
    const float* wr = ws + kl * kWRow;
#pragma unroll
    for (int c = 0; c < kNarrowCols; ++c) {
      const float4 w0 = *reinterpret_cast<const float4*>(wr + c * 8);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + c * 8 + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int p = 0; p < repro::kDbbBlock; ++p)
        acc[c] = fmaf(xv[p], wv[p], acc[c]);
    }
    __syncthreads();
  }

  // the 64 block lanes of a row: the warp's 32 by a reduce-scatter (lane
  // l ends with column l % 16 over its half-warp) and a butterfly step,
  // then the row's two warps in shared memory
  reduce_scatter<8>(acc, lane);
  reduce_scatter<4>(acc, lane);
  reduce_scatter<2>(acc, lane);
  reduce_scatter<1>(acc, lane);
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 16);
  const bool second = (tid / 32) % 2;  // the row's upper 32 block lanes
  if (second && lane < kNarrowCols) half[rr][lane] = acc[0];
  __syncthreads();
  if (!second && lane < kNarrowCols)
    part[rr * kNarrowCols + lane] = acc[0] + half[rr][lane];

  // the cluster's S slices in rank order; epilogue; store
  sk::cluster_sync();
  for (int e = rank * kNarrowThreads + tid; e < kNarrowRows * kNarrowCols;
       e += S * kNarrowThreads) {
    const int row = blockIdx.x * kNarrowRows + e / kNarrowCols;
    const int n = e % kNarrowCols;
    if (row < M && n < N)
      out[(size_t)row * N + n] = repro::finish<float>(
          sk::cluster_sum(part, e, S), n, scale, bias, act);
  }
  sk::cluster_sync();
}

template <typename Plane>
int launch_narrow(const void* x, const Plane plane, const void* bitmask,
                  const void* scale, const void* bias, void* out, int M,
                  int K, int N, int nnz, int act, cudaStream_t s) {
  const int S = narrow_splits(K);
  const int kb_total = K / repro::kDbbBlock;
  const int per = (kb_total + S - 1) / S;
  const int slice_kb = (per + kChunkKb - 1) / kChunkKb * kChunkKb;
  return (int)sk::launch(
      dbb_gemm_narrow_kernel<Plane>, (M + kNarrowRows - 1) / kNarrowRows, S,
      kNarrowThreads, 0, s, static_cast<const float*>(x), plane,
      static_cast<const int32_t*>(bitmask), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), M, K, N, nnz,
      act, slice_kb);
}

bool dims_ok(int K, int nnz) {
  return nnz >= 1 && nnz <= repro::kNnzMax && K % repro::kDbbBlock == 0;
}

bool tc_body(int dtype) { return dtype == repro::DT_BF16; }

bool narrow_body(int dtype, int N) {
  return dtype == repro::DT_F32 && N <= 16;
}

// the int8-activation launcher's rule (int8 x only reaches it)
bool s8_tc_body(int K, int N) { return K % 16 == 0 && N % 16 == 0; }

// float x: out in x's dtype (dtype)
template <typename Plane>
int launch(const void* x, const Plane plane, const void* bitmask,
           const void* scale, const void* bias, void* out, int M, int K,
           int N, int nnz, int act, int dtype, void* stream) {
  if (!dims_ok(K, nnz)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_body(dtype))
    return repro::tc::launch_dbb<__nv_bfloat16>(x, plane, bitmask, nnz, scale,
                                                bias, out, M, K, N, act, s);
  if (narrow_body(dtype, N)) {
    if (M == 0) return (int)cudaSuccess;
    const int rc = launch_narrow(x, plane, bitmask, scale, bias, out, M, K,
                                 N, nnz, act, s);
    return rc != 0 ? rc : (int)cudaGetLastError();
  }
  launch_t<float, float>(x, plane, bitmask, scale, bias, out, M, K, N, nnz,
                         act, s);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 where the float launchers run the tensor-core body for x of this dtype
extern "C" int dbb_gemm_tc_body(int dtype) {
  return tc_body(dtype) ? 1 : 0;
}

// 1 where the float launchers run the narrow split-K body (x dtype, N)
extern "C" int dbb_gemm_narrow_body(int dtype, int N) {
  return narrow_body(dtype, N) ? 1 : 0;
}

// 1 where dbb_gemm_s8_launch runs the int8 tensor-core body for this K, N
extern "C" int dbb_gemm_s8_tc_body(int K, int N) {
  return s8_tc_body(K, N) ? 1 : 0;
}

extern "C" int dbb_gemm_launch(const void* x, const void* values,
                               const void* bitmask, const void* scale,
                               const void* bias, void* out, int M, int K,
                               int N, int nnz, int act, int dtype,
                               void* stream) {
  return launch(x, repro::F32Plane{static_cast<const float*>(values)},
                bitmask, scale, bias, out, M, K, N, nnz, act, dtype, stream);
}

extern "C" int dbb_gemm_i8_launch(const void* x, const void* values,
                                  const void* bitmask, const void* scale,
                                  const void* bias, void* out, int M, int K,
                                  int N, int nnz, int act, int dtype,
                                  void* stream) {
  return launch(x, repro::I8Plane{static_cast<const int8_t*>(values)},
                bitmask, scale, bias, out, M, K, N, nnz, act, dtype, stream);
}

extern "C" int dbb_gemm_w4_launch(const void* x, const void* values,
                                  const void* bitmask, const void* gscale,
                                  int group, const void* scale,
                                  const void* bias, void* out, int M, int K,
                                  int N, int nnz, int act, int dtype,
                                  void* stream) {
  if (!repro::w4_dims_ok(K, nnz, group)) return (int)cudaErrorInvalidValue;
  return launch(x,
                repro::W4Plane{static_cast<const int8_t*>(values),
                               static_cast<const float*>(gscale), group},
                bitmask, scale, bias, out, M, K, N, nnz, act, dtype, stream);
}

// int8 x on the int8 values plane: out_dtype DT_I32, DT_F32 or DT_I8
extern "C" int dbb_gemm_s8_launch(const void* x, const void* values,
                                  const void* bitmask, const void* scale,
                                  const void* bias, void* out, int M, int K,
                                  int N, int nnz, int act, int out_dtype,
                                  void* stream) {
  if (!dims_ok(K, nnz)) return (int)cudaErrorInvalidValue;
  const repro::I8Plane plane{static_cast<const int8_t*>(values)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  const int last = repro::with_s8_out(out_dtype, [&](auto o) {
    using TO = decltype(o);
    if (s8_tc_body(K, N))
      rc = repro::tc8::launch_dbb<TO>(x, values, bitmask, nnz, scale, bias,
                                      out, M, K, N, act, s);
    else
      launch_t<int8_t, TO>(x, plane, bitmask, scale, bias, out, M, K, N, nnz,
                           act, s);
  });
  return rc != 0 ? rc : last;
}
