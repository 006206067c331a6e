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
// operand either way. The int8 branch's dense int8 work is far below the
// 1979 TOP/s INT8 tensor rate: bound by its bytes (the image in, the
// output out).
//
// Two bodies, picked by a rule on dtype, C, kh, kw, stride and N alone
// (tc_body; never B, H or W, so a pixel's bits do not depend on the batch
// or the image size):
//   - the tensor-core body (conv_tc.cuh: TMA in im2col mode for the image,
//     the DBB planes decompressed into K-major shared-memory tiles by a
//     worker warpgroup, wgmma; 3xTF32 for f32 images, s8 for int8 ones) for
//     f32 images with C % 16 == 0 and N % 4 == 0 and int8 images with C %
//     64 == 0 and N % 16 == 0 (whole 64-byte pieces of channels; 16-byte
//     rows of x and of the planes for TMA), kh, kw <= 32, stride <= 8:
//     convnet's conv1 and conv2 in both branches;
//   - the FMA body, for everything else (bf16 images, which no path
//     launches, and C or N off the rule): conv_gemm.cu's block body
//     (gemm_tile.cuh) with the DBB loader of dbb_gemm.cu: each K step of
//     16 covers two DBB blocks, and each thread decompresses one (block,
//     column) pair by bitmask rank in registers into the shared-memory
//     tile, so the dense weight never exists in device memory. It runs the
//     dense FMAs (int8: IMAD) of every decompressed tile, zeros included.
// If the tensor-core body cannot be set up or launched, the call returns
// the error; it never falls back to the FMA body. conv_gemm_dbb_tc_body
// exports the rule; the wrapper's tc_body mirrors it and counts
// conv_gemm_dbb_tc / conv_gemm_dbb_s8_tc launches.
//
// DBB blocks of 8 run along the reference's K order (i*kw + j)*C + c; the
// dispatch takes this route only where kw*C % 8 == 0, so one kernel row
// covers whole blocks, as in the reference.
#include "conv_tc.cuh"
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

// The tensor-core body's rule: dtype (the image's code), C, kh, kw,
// stride and N only.
bool tc_body(int dtype, int C, int kh, int kw, int stride, int N) {
  return ((dtype == repro::DT_F32 && C % 16 == 0 && N % 4 == 0) ||
          (dtype == repro::DT_I8 && C % 64 == 0 && N % 16 == 0)) &&
         kh <= 32 && kw <= 32 && stride <= 8;
}

}  // namespace

extern "C" int conv_gemm_dbb_tc_body(int dtype, int C, int kh, int kw,
                                     int stride, int N) {
  return tc_body(dtype, C, kh, kw, stride, N) ? 1 : 0;
}

extern "C" int conv_gemm_dbb_launch(const void* x, const void* values,
                                    const void* bitmask, const void* scale,
                                    const void* bias, void* out, int B, int H,
                                    int W, int C, int Ho, int Wo, int kh,
                                    int kw, int stride, int pad_top,
                                    int pad_left, int N, int nnz, int act,
                                    int dtype, void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_body(dtype, C, kh, kw, stride, N))
    return repro::convtc::launch<float, float>(x, values, bitmask, scale,
                                               bias, out, g, N, nnz, act,
                                               repro::convtc::kAll, s);
  const dim3 grid = grid_for(B * Ho * Wo, N);
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
  if (tc_body(repro::DT_I8, C, kh, kw, stride, N)) {
    int rc = 0;
    const int last = repro::with_s8_out(out_dtype, [&](auto o) {
      rc = repro::convtc::launch<int8_t, decltype(o)>(
          x, values, bitmask, scale, bias, out, g, N, nnz, act,
          repro::convtc::kAll, s);
    });
    return rc != 0 ? rc : last;
  }
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

// The tensor-core body alone, one phase set at a time (conv_tc.cuh, Phase:
// 1 the producers and waits, 2 the fragment loads and wgmma, 3 both; 8 and
// 16 the diagnoses), its ring `stages` deep (0: as deep as fits), f32
// output; for scripts/torch_conv_probe.py's phase split and depth sweep.
// dtype: the image's code (DT_F32 or DT_I8); a shape off the rule launches
// nothing.
extern "C" int conv_gemm_dbb_tc_phase_launch(
    const void* x, const void* values, const void* bitmask,
    const void* scale, const void* bias, void* out, int B, int H, int W,
    int C, int Ho, int Wo, int kh, int kw, int stride, int pad_top,
    int pad_left, int N, int nnz, int act, int dtype, int phase, int stages,
    void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tc_body(dtype, C, kh, kw, stride, N))
    return (int)cudaErrorInvalidValue;
  return dtype == repro::DT_F32
             ? repro::convtc::launch<float, float>(x, values, bitmask, scale,
                                                   bias, out, g, N, nnz, act,
                                                   phase, s, stages)
             : repro::convtc::launch<int8_t, float>(x, values, bitmask,
                                                    scale, bias, out, g, N,
                                                    nnz, act, phase, s,
                                                    stages);
}
