// Implicit-GEMM NHWC convolution against a DBB-compressed weight: the
// function of conv_gemm.cu with w[kh*kw*C, N] given as the DBB planes
// values[K/8 * nnz, N] and bitmask[K/8, N] (int32): f32 values for a float
// image (conv_gemm_dbb_launch); int8 values (pack_tree(quantize=True),
// the per-channel scale in the epilogue) for an int8 image
// (conv_gemm_dbb_s8_launch: exact int32 sums, output int32, f32 or int8).
//
// Replaces: src/repro/kernels/conv_gemm/kernel.py, conv_gemm_dbb_pallas —
// the CNN's packed conv layers under matmul="dbb" (convnet's conv1 and
// conv2).
//
// What bounds it on the H100: at convnet's conv1-2 (K = 576-1152, N =
// 128-256) the live work, 2·M·N·(live weights per column), is well above
// the f32 ridge: bound by operations. The weight stream is the smallest
// operand either way. This first version runs the dense FMAs of every
// decompressed tile, zeros included, so it does the dense work, not the
// live work; skipping the zeros is later work.
//
// The int8 branch does the same dense work in int32 multiply-adds, bound
// by operations against the 1979 TOP/s INT8 tensor rate.
//
// Design: conv_gemm.cu's block body (gemm_tile.cuh) with the DBB loader
// of dbb_gemm.cu: each K step of 16 covers two DBB blocks, and each
// thread decompresses one (block, column) pair by bitmask rank in
// registers into the shared-memory tile, so the dense weight never
// exists in device memory. DBB blocks of 8 run along the reference's K
// order (i*kw + j)*C + c; the dispatch takes this route only where
// kw*C % 8 == 0, so one kernel row covers whole blocks, as in the
// reference.
#include "gemm_tile.cuh"

namespace {

using namespace repro::gemm;

template <typename T, typename V = float, typename TO = T>
__global__ void __launch_bounds__(kThreads)
conv_gemm_dbb_kernel(const T* __restrict__ x, const V* __restrict__ values,
                     const int32_t* __restrict__ bitmask,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, TO* __restrict__ out,
                     ConvGeom g, int N, int nnz, int act) {
  const int M = g.B * g.Ho * g.Wo, K = g.kh * g.kw * g.C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const ConvGather<T> a(x, m0 + act_row(), g);
  const DbbWeights<T, V> wl{values, bitmask, K, N, nnz};
  gemm_tile<TO>(a, wl, M, N, K, m0, n0, scale, bias, act, out);
}

}  // namespace

extern "C" int conv_gemm_dbb_launch(const void* x, const void* values,
                                    const void* bitmask, const void* scale,
                                    const void* bias, void* out, int B, int H,
                                    int W, int C, int Ho, int Wo, int kh,
                                    int kw, int stride, int pad_top,
                                    int pad_left, int N, int nnz, int act,
                                    int dtype, void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  const dim3 grid = grid_for(B * Ho * Wo, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const int32_t* mk = static_cast<const int32_t*>(bitmask);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == repro::DT_BF16) {
    conv_gemm_dbb_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), v, mk, sc, bi,
        static_cast<__nv_bfloat16*>(out), g, N, nnz, act);
  } else {
    conv_gemm_dbb_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), v, mk, sc, bi, static_cast<float*>(out),
        g, N, nnz, act);
  }
  return (int)cudaGetLastError();
}

// int8 image, int8 values: out_dtype DT_I32, DT_F32 or DT_I8
extern "C" int conv_gemm_dbb_s8_launch(const void* x, const void* values,
                                       const void* bitmask, const void* scale,
                                       const void* bias, void* out, int B,
                                       int H, int W, int C, int Ho, int Wo,
                                       int kh, int kw, int stride,
                                       int pad_top, int pad_left, int N,
                                       int nnz, int act, int out_dtype,
                                       void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::with_s8_out(out_dtype, [&](auto o) {
    using TO = decltype(o);
    conv_gemm_dbb_kernel<int8_t, int8_t, TO>
        <<<grid_for(B * Ho * Wo, N), kThreads, 0, s>>>(
            static_cast<const int8_t*>(x), static_cast<const int8_t*>(values),
            static_cast<const int32_t*>(bitmask),
            static_cast<const float*>(scale), static_cast<const float*>(bias),
            static_cast<TO*>(out), g, N, nnz, act);
  });
}
