// Dense weight-streaming GEMM for skinny M (M <= 32):
// out = act(scale * (x @ w) + bias), x[M, K], w[K, N] of one dtype.
//
// Replaces: src/repro/kernels/skinny/kernel.py, sta_gemm_skinny_pallas —
// on the serving path the tied-embedding head, x[8, 2048] f32 times
// w[2048, 50304] f32, whose argmax is the greedy token.
//
// What bounds it on the H100: bytes. The head's 412 MB f32 weight is read
// once per step for 2 * 8 operations per 4-byte weight, far below the
// card's operations-per-byte balance, so the time is the weight stream
// over the 3.35 TB/s memory rate. The arithmetic is full f32 FMA — no
// TF32, as the reference computes the head in f32.
//
// Design: the weight is streamed once, coalesced: a block owns 32 output
// columns (one per lane) and its warps split K in interleaved groups of 8
// rows. Per group a thread reads its column's 8 weights, loads each row's
// 8 activations with one vector load (a warp-wide broadcast) and keeps MT
// f32 sums; the warps' partial sums meet in shared memory, where the
// epilogue runs before the one store.
#include "common.cuh"

namespace {

template <typename T, int MT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
sta_gemm_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int M, int K, int N, int act) {
  __shared__ float part[WARPS][MT][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const int groups = K / 8;

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;

  if (n < N) {
    for (int g = warp; g < groups; g += WARPS) {
      const size_t k = (size_t)g * 8;
      float wv[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) wv[p] = repro::to_f32(w[(k + p) * N + n]);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (r >= M) break;
        float xv[8];
        repro::load8(x + (size_t)r * K + k, xv);
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[r] = fmaf(xv[p], wv[p], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * 32; i += WARPS * 32) {
    const int r = i / 32, c = i % 32, col = blockIdx.x * 32 + c;
    if (r >= M || col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) sum += part[v][r][c];
    out[(size_t)r * N + col] =
        repro::from_f32<T>(repro::epilogue(sum, col, scale, bias, act));
  }
}

template <typename T, int MT>
void launch(const void* x, const void* w, const void* scale, const void* bias,
            void* out, int M, int K, int N, int act, cudaStream_t s) {
  constexpr int WARPS = MT <= 16 ? 16 : 8;
  const dim3 grid((N + 31) / 32);
  sta_gemm_skinny_kernel<T, MT, WARPS><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), M, K, N, act);
}

template <typename T>
void dispatch_m(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int M, int K, int N, int act,
                cudaStream_t s) {
  if (M <= 8)
    launch<T, 8>(x, w, scale, bias, out, M, K, N, act, s);
  else if (M <= 16)
    launch<T, 16>(x, w, scale, bias, out, M, K, N, act, s);
  else
    launch<T, 32>(x, w, scale, bias, out, M, K, N, act, s);
}

}  // namespace

extern "C" int sta_gemm_skinny_launch(const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      void* out, int M, int K, int N, int act,
                                      int dtype, void* stream) {
  if (M < 1 || M > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DT_BF16)
    dispatch_m<__nv_bfloat16>(x, w, scale, bias, out, M, K, N, act, s);
  else
    dispatch_m<float>(x, w, scale, bias, out, M, K, N, act, s);
  return (int)cudaGetLastError();
}
