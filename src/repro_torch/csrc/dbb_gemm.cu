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
// Two bodies, chosen by the activation dtype alone, never by M or the
// shapes (dbb_gemm_tc_body exports the rule; the wrapper's tc_body
// mirrors it):
//   - bf16 x (K % 8 == 0, which every DBB operand has, is all TMA needs of
//     x's rows) runs on the tensor-core body (tc_gemm.cuh) on all three
//     value planes: x's tiles come by TMA, producer warps decompress the
//     planes by bitmask rank straight into the shared-memory B tiles in
//     bf16 (each plane's value rounded through bf16 first, as the
//     reference casts its tile), and wgmma multiplies with f32
//     accumulators. The dense weight never exists in device memory;
//   - f32 x (the CNN: tensor cores have no f32-exact path) and the int8
//     branch run the plain body below: one 256-thread block owns a 128 x
//     128 output tile and loops over K in steps of 16 (two DBB blocks).
//     Each step every thread loads one (DBB block, column) pair's slots
//     through the plane's loader (the w4 loader sign-extends nibbles and
//     multiplies by the block's group scale) and decompresses them from
//     the bitmask rank straight into the shared-memory weight tile, and
//     loads eight activations into the transposed shared-memory activation
//     tile. Each thread then accumulates an 8 x 8 register tile in f32
//     (int32 on the int8 branch: the tiles hold sign-extended int8 and the
//     slots come from I8Plane's integer loader, so the same body and K
//     order serve it; bound by operations against the 1979 TOP/s INT8
//     rate, far above it); the epilogue runs on those registers before the
//     one store of the output. No state crosses blocks.
#include "common.cuh"
#include "tc_gemm.cuh"

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

bool dims_ok(int K, int nnz) {
  return nnz >= 1 && nnz <= repro::kNnzMax && K % repro::kDbbBlock == 0;
}

bool tc_body(int dtype) { return dtype == repro::DT_BF16; }

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
  launch_t<float, float>(x, plane, bitmask, scale, bias, out, M, K, N, nnz,
                         act, s);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 where the float launchers run the tensor-core body for x of this dtype
extern "C" int dbb_gemm_tc_body(int dtype) {
  return tc_body(dtype) ? 1 : 0;
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
  return repro::with_s8_out(out_dtype, [&](auto o) {
    launch_t<int8_t, decltype(o)>(x, plane, bitmask, scale, bias, out, M, K,
                                  N, nnz, act, s);
  });
}
