// Dense weight-streaming GEMM for skinny M (M <= 32):
// out = act(scale * (x @ w) + bias), x[M, K], w[K, N] of one dtype: f32 or
// bf16, output in that dtype (sta_gemm_skinny_launch); or int8, the
// INT8 x INT8 -> INT32 datapath, output int32, f32 or int8 requantized
// (sta_gemm_skinny_s8_launch).
//
// Replaces: src/repro/kernels/skinny/kernel.py, sta_gemm_skinny_pallas —
// on the serving path the tied-embedding head, x[8, 2048] f32 times
// w[2048, 50304] f32, whose argmax is the greedy token.
//
// What bounds it on the H100: bytes. The head's 412 MB f32 weight is read
// once per step for 2 * 8 operations per 4-byte weight, far below the
// card's operations-per-byte balance, so the time is the weight stream
// over the 3.35 TB/s memory rate. The arithmetic is full f32 FMA — no
// TF32, as the reference computes the head in f32. The int8 branch
// streams one byte per weight, still bound by bytes at M <= 32.
//
// Design (skinny_tile.cuh, the body head_sample_fused.cu shares): a block
// owns 32 output columns (one per lane) and one chunk of up to 8 rows; its
// 16 warps split K in interleaved groups of 8 rows. The row chunks of a
// column range run back to back, so the weight streams from memory about
// once at any M <= 32. The warps' partial sums meet in shared memory, where
// the epilogue runs before the one store.
#include "skinny_tile.cuh"

namespace {

using repro::kSkinnyRows;
using repro::kSkinnyWarps;

template <typename T, typename TO>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
sta_gemm_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, TO* __restrict__ out,
                       int M, int K, int N, int act) {
  __shared__ repro::acc_t<T> part[kSkinnyWarps][kSkinnyRows][32];
  const int r0 = blockIdx.x * kSkinnyRows;
  const int m = min(kSkinnyRows, M - r0);
  repro::skinny_pass<T>(x + (size_t)r0 * K, w,
                        blockIdx.y * 32 + threadIdx.x % 32, m, K, N, part);
  __syncthreads();
  for (int i = threadIdx.x; i < kSkinnyRows * 32; i += kSkinnyWarps * 32) {
    const int r = i / 32, c = i % 32, col = blockIdx.y * 32 + c;
    if (r >= m || col >= N) continue;
    out[(size_t)(r0 + r) * N + col] = repro::finish<TO>(
        repro::skinny_sum(part, r, c), col, scale, bias, act);
  }
}

template <typename T, typename TO = T>
void launch(const void* x, const void* w, const void* scale, const void* bias,
            void* out, int M, int K, int N, int act, cudaStream_t s) {
  const dim3 grid((M + kSkinnyRows - 1) / kSkinnyRows, (N + 31) / 32);
  sta_gemm_skinny_kernel<T, TO><<<grid, kSkinnyWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), M, K, N, act);
}

}  // namespace

extern "C" int sta_gemm_skinny_launch(const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      void* out, int M, int K, int N, int act,
                                      int dtype, void* stream) {
  if (M < 1 || M > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DT_BF16)
    launch<__nv_bfloat16>(x, w, scale, bias, out, M, K, N, act, s);
  else
    launch<float>(x, w, scale, bias, out, M, K, N, act, s);
  return (int)cudaGetLastError();
}

// int8 operands: out_dtype DT_I32, DT_F32 or DT_I8
extern "C" int sta_gemm_skinny_s8_launch(const void* x, const void* w,
                                         const void* scale, const void* bias,
                                         void* out, int M, int K, int N,
                                         int act, int out_dtype,
                                         void* stream) {
  if (M < 1 || M > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::with_s8_out(out_dtype, [&](auto o) {
    launch<int8_t, decltype(o)>(x, w, scale, bias, out, M, K, N, act, s);
  });
}
