// The skinny dense GEMV body of head_sample_fused.cu (the sampling head).
// Its K order is the one that sta_gemm_skinny.cu's float body (the greedy
// head) keeps with another tiling: sharing it is what makes
// temperature-0 sampling pick greedy's token bit for bit.
//
// A block takes one chunk of up to kSkinnyRows = 8 rows (blockIdx.x: M > 8
// runs ceil(M / 8) chunks) and 32 columns per pass. Its kSkinnyWarps warps
// split K in interleaved 8-row groups: warp v takes groups v, v + 16, ...
// A thread reads its column's 8 weights (coalesced across the warp), loads
// each row's 8 activations with one vector load (a warp-wide broadcast)
// and keeps 8 f32 FMA sums, which it leaves in part[warp][r][lane]. After
// a __syncthreads the caller adds the warps' partials in warp order
// (skinny_sum) and runs its epilogue. The order depends on neither M nor
// the chunk, so a row's sums are the same bits in any batch. The row
// chunks of one column range are neighbours in the launch order
// (blockIdx.x varies fastest), so the chunks after the first find that
// weight slab in L2: the weight streams from memory about once, and a
// block reads only its own 8 activation rows.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSkinnyRows = 8;    // rows per block (one row chunk)
constexpr int kSkinnyWarps = 16;  // warps per block, splitting K

template <typename T>
__device__ __forceinline__ void skinny_pass(
    const T* __restrict__ x, const T* __restrict__ w, int n, int m, int K,
    int N, float (&part)[kSkinnyWarps][kSkinnyRows][32]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float acc[kSkinnyRows];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r) acc[r] = 0.f;
  if (n < N) {
    for (int g = warp; g < K / 8; g += kSkinnyWarps) {
      const size_t k = (size_t)g * 8;
      float wv[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) wv[p] = to_acc(w[(k + p) * N + n]);
#pragma unroll
      for (int r = 0; r < kSkinnyRows; ++r) {
        if (r >= m) break;
        float xv[8];
        load8(x + (size_t)r * K + k, xv);
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[r] = mac(xv[p], wv[p], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r) part[warp][r][lane] = acc[r];
}

// row r of the chunk, pass column c: the warps' partials in warp order
__device__ __forceinline__ float skinny_sum(
    const float (&part)[kSkinnyWarps][kSkinnyRows][32], int r, int c) {
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < kSkinnyWarps; ++v) sum += part[v][r][c];
  return sum;
}

}  // namespace repro
