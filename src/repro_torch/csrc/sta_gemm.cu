// Dense GEMM, M-tiled: out = act(scale * (x @ w) + bias) for x[M, K] and
// w[K, N] in one dtype: f32 or bf16 with f32 accumulation, output in f32
// or bf16 (sta_gemm_launch); or int8, the paper's INT8 x INT8 -> INT32
// datapath, output int32, f32 or int8 requantized (sta_gemm_s8_launch).
//
// Replaces: src/repro/kernels/sta_gemm/kernel.py, sta_gemm_pallas — the
// MLP GEMMs of dense-weight prefill (M = batch * prompt, K and N of
// 2048-8192), any dense M-tiled GEMM under gemm_impl="pallas", and the
// int8 operator at those shapes (its int32 accumulator branch).
//
// What bounds it on the H100: at the prefill shapes the work is 2·M·K·N
// operations on (M·K + K·N + M·N) elements, hundreds of operations per
// byte, far above the card's ~295 bf16 operations per byte: bound by
// arithmetic, which only the tensor cores reach.
//
// Three bodies, chosen by rules on (dtype, K, N) alone, never on M:
//   - bf16 operands with K and N multiples of 8 (the 16-byte row strides
//     TMA needs for x and w) run on the tensor-core body
//     (tc_gemm.cuh: TMA-fed stages, wgmma with f32 accumulators);
//   - int8 operands with K and N multiples of 16 (the same 16-byte row
//     strides in int8) run on the int8 tensor-core body (tc_gemm_s8.cuh);
//   - everything else — f32 operands (the tensor cores have no f32-exact
//     path), bf16 with a ragged K or N, int8 with K or N off 16 — runs the
//     output-stationary 128 x 128 plain-FMA body of gemm_tile.cuh (int32
//     multiply-adds for int8), ragged M, N and K masked in its loaders.
// sta_gemm_tc_body and sta_gemm_s8_tc_body export the rules; the wrapper's
// tc_body and s8_tc_body mirror them.
//
// The int8 branch (sta_gemm_s8_launch) replaces sta_gemm_pallas's int8
// branch (its int32 accumulator, _sta_gemm_kernel). It is 2·M·K·N integer
// operations on one byte per operand, bound by operations against the
// card's 1979 TOP/s dense INT8 tensor rate, which the IMAD body it ran on
// before missed by far (5-6x behind torch._int_mm at M512). Its
// tensor-core body runs s8 wgmma with int32 accumulators; wgmma takes int8
// B only K-major, so w's tiles are TMA'd as stored and made K-major in
// shared memory by a transposer warpgroup, and w keeps its row-major
// layout. Integer sums are exact in any order: both bodies give the same
// bits.
#include "gemm_tile.cuh"
#include "tc_gemm.cuh"
#include "tc_gemm_s8.cuh"

namespace {

using namespace repro::gemm;

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
sta_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, TO* __restrict__ out, int M,
                int K, int N, int act) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const RowLoader<T> a(x, m0 + act_row(), M, K);
  const DenseWeights<T> wl{w, K, N};
  gemm_tile<TO>(a, wl, M, N, K, m0, n0, scale, bias, act, out);
}

template <typename T, typename TO>
void launch(const void* x, const void* w, const float* sc, const float* bi,
            void* out, int M, int K, int N, int act, cudaStream_t s) {
  sta_gemm_kernel<T, TO><<<grid_for(M, N), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), sc, bi,
      static_cast<TO*>(out), M, K, N, act);
}

bool tc_body(int dtype, int K, int N) {
  return dtype == repro::DT_BF16 && K % 8 == 0 && N % 8 == 0;
}

// the int8 launcher's rule (int8 operands only reach it)
bool s8_tc_body(int K, int N) { return K % 16 == 0 && N % 16 == 0; }

}  // namespace

// 1 where sta_gemm_launch runs the tensor-core body for these operands
extern "C" int sta_gemm_tc_body(int dtype, int K, int N) {
  return tc_body(dtype, K, N) ? 1 : 0;
}

// 1 where sta_gemm_s8_launch runs the int8 tensor-core body for this K, N
extern "C" int sta_gemm_s8_tc_body(int K, int N) {
  return s8_tc_body(K, N) ? 1 : 0;
}

extern "C" int sta_gemm_launch(const void* x, const void* w,
                               const void* scale, const void* bias, void* out,
                               int M, int K, int N, int act, int dtype,
                               int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const bool bf = dtype == repro::DT_BF16, obf = out_dtype == repro::DT_BF16;
  if (tc_body(dtype, K, N))
    return obf ? repro::tc::launch_dense<__nv_bfloat16>(x, w, scale, bias,
                                                        out, M, K, N, act, s)
               : repro::tc::launch_dense<float>(x, w, scale, bias, out, M,
                                                K, N, act, s);
  if (bf && obf) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, sc, bi, out, M, K, N, act, s);
  } else if (bf) {
    launch<__nv_bfloat16, float>(x, w, sc, bi, out, M, K, N, act, s);
  } else if (obf) {
    launch<float, __nv_bfloat16>(x, w, sc, bi, out, M, K, N, act, s);
  } else {
    launch<float, float>(x, w, sc, bi, out, M, K, N, act, s);
  }
  return (int)cudaGetLastError();
}

// int8 operands: out_dtype DT_I32 (the raw sum, or the epilogue truncated),
// DT_F32 (dequantized by the scale) or DT_I8 (requantized)
extern "C" int sta_gemm_s8_launch(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int M, int K, int N, int act,
                                  int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  int rc = 0;
  const int last = repro::with_s8_out(out_dtype, [&](auto o) {
    using TO = decltype(o);
    if (s8_tc_body(K, N))
      rc = repro::tc8::launch_dense<TO>(x, w, scale, bias, out, M, K, N, act,
                                        s);
    else
      launch<int8_t, TO>(x, w, sc, bi, out, M, K, N, act, s);
  });
  return rc != 0 ? rc : last;
}
