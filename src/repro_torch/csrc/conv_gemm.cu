// Implicit-GEMM NHWC convolution with a dense weight:
// out[b, oh, ow, n] = act(scale[n] * sum_{i,j,c} x[b, oh*s + i - pt,
// ow*s + j - pl, c] * w[(i*kw + j)*C + c, n] + bias[n]), zero outside
// the image; x [B, H, W, C], w [kh*kw*C, N], out [B, Ho, Wo, N]. Float
// operands (conv_gemm_launch) accumulate in f32 and store x's dtype; an
// int8 image and weight (conv_gemm_s8_launch, the paper's INT8 datapath)
// sum exactly in int32 and store int32, f32 or int8 requantized.
//
// Replaces: src/repro/kernels/conv_gemm/kernel.py, conv_gemm_pallas — the
// CNN's dense conv layers (convnet's conv0, every conv under
// matmul="sta", lenet's conv1).
//
// What bounds it on the H100: 2·M·K·N operations (M = B·Ho·Wo, K =
// kh·kw·C) on the image, the weight and the output read or written once.
// With C = 3 (convnet's conv0, K = 27, N = 64) that is ~27 operations
// per byte, near the f32 ridge of ~20: bytes and operations about level;
// the later layers (K = 576-1152) are bound by operations.
//
// The int8 branch has the same shape of work on one byte per operand:
// bound by operations against the 1979 TOP/s INT8 tensor rate from the
// later layers on; it sums with plain int32 multiply-adds.
//
// Design: the block body of gemm_tile.cuh (128 output pixels x 128
// output channels, plain f32 FMA or int32 IMAD, fused epilogue) with the
// im2col gather as its activation loader (an integer 0 outside the
// image for int8). The Pallas kernel keeps the whole
// padded image resident in VMEM and gathers patch tiles from it; here
// each K step gathers its [128, 16] patch tile straight from device
// memory (L2 serves the kh·kw reuse), so shared memory stays 16.6 KB at
// any image size, there is no padded copy of the image (outside reads
// zero) and no im2col tensor. K runs in the reference's order, so the
// weight matrix is the explicit lowering's.
#include "gemm_tile.cuh"

namespace {

using namespace repro::gemm;

template <typename T, typename TO = T>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, TO* __restrict__ out,
                 ConvGeom g, int N, int act) {
  const int M = g.B * g.Ho * g.Wo, K = g.kh * g.kw * g.C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const ConvGather<T> a(x, m0 + act_row(), g);
  const DenseWeights<T> wl{w, K, N};
  gemm_tile<TO>(a, wl, M, N, K, m0, n0, scale, bias, act, out);
}

}  // namespace

extern "C" int conv_gemm_launch(const void* x, const void* w,
                                const void* scale, const void* bias,
                                void* out, int B, int H, int W, int C, int Ho,
                                int Wo, int kh, int kw, int stride,
                                int pad_top, int pad_left, int N, int act,
                                int dtype, void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  const dim3 grid = grid_for(B * Ho * Wo, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == repro::DT_BF16) {
    conv_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), sc, bi,
        static_cast<__nv_bfloat16*>(out), g, N, act);
  } else {
    conv_gemm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, bi,
        static_cast<float*>(out), g, N, act);
  }
  return (int)cudaGetLastError();
}

// int8 image and weight: out_dtype DT_I32, DT_F32 or DT_I8
extern "C" int conv_gemm_s8_launch(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int B, int H, int W, int C,
                                   int Ho, int Wo, int kh, int kw, int stride,
                                   int pad_top, int pad_left, int N, int act,
                                   int out_dtype, void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::with_s8_out(out_dtype, [&](auto o) {
    using TO = decltype(o);
    conv_gemm_kernel<int8_t, TO><<<grid_for(B * Ho * Wo, N), kThreads, 0,
                                   s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<TO*>(out), g, N, act);
  });
}
