// Fused sampling head: one sampled token per hidden row, without the
// [M, N] logits ever reaching device memory.
//   logit[r, c] = x[r, :] . w[:, c]              (f32 FMA, no TF32)
//   pen   = penalties(logit, counts[r, c], rep, pres, freq)
//   score = temp > 0 ? pen * (1 / temp) + gumbel(seed, step, base + c) : pen
//   out   = (max_c score, first c attaining it)
//
// Replaces: src/repro/kernels/sample/kernel.py, head_sample_fused_pallas —
// on the sampled serving path the head at x[8, 2048] f32 (decode; up to 8
// rows per packed prefill call) against the tied w[2048, 50304] f32.
//
// What bounds it on the H100: bytes. The 412 MB f32 weight (plus the
// [M, N] i32 counts) is read once for 2 * M operations per weight, far
// below the card's operations-per-byte balance: the weight stream over the
// 3.35 TB/s memory rate sets the pace, as for the greedy head.
//
// Design. The TPU kernel walks N tiles in order and carries a running
// (best, index) across them; here blocks run in parallel, so the work is
// two launches:
// 1. head_sample_tile_kernel: one block per (chunk of up to 8 rows,
//    128-column tile), the tile walked as four 32-column passes. Each pass
//    is sta_gemm_skinny.cu's body, shared through skinny_tile.cuh — one
//    column per lane, 16 warps splitting K in interleaved groups of 8 rows,
//    the warps' partial sums added in warp order in shared memory — so
//    every logit is bit-equal to sta_gemm_skinny's (temperature-0 sampling
//    with default penalties picks greedy's token exactly). The epilogue runs per logit
//    in registers: penalties from the counts tile, 1/T, and the murmur3
//    counter hash in native uint32 for the Gumbel noise; a warp argmax
//    (ties to the lower column) and a running best over the passes leave
//    one (best, index) partial per row and tile.
// 2. head_sample_reduce_kernel: one block per row combines the tiles'
//    partials: the larger score wins, the lower index on ties — so the
//    result is jnp.argmax's first maximum, independent of block order.
// Arithmetic follows the reference op by op: no FMA contraction in the
// epilogue (__fmul_rn / __fsub_rn / __fadd_rn), IEEE division, logf built
// without --use_fast_math (it may differ from the host's log by an ulp).
#include <limits.h>
#include <math.h>

#include "skinny_tile.cuh"

namespace {

constexpr int kTile = 128;       // columns per block: kPasses x 32
constexpr int kPasses = kTile / 32;
constexpr uint32_t kSaltToken = 0x9E3779B9u;  // (0x9E3779B9 * (0 + 1)) mod 2^32

__device__ __forceinline__ uint32_t mix(uint32_t h) {  // murmur3 finalizer
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// -log(-log(u)), u = ((h >> 9) + 0.5) * 2^-23 strictly inside (0, 1)
__device__ __forceinline__ float gumbel(uint32_t h) {
  const float u = __fmul_rn(__fadd_rn((float)(h >> 9), 0.5f),
                            1.1920928955078125e-07f);
  return -logf(-logf(u));
}

// the reference's sample_scores for one logit; hrow = the row's hash of
// (seed, step), col = the global vocab id
__device__ __forceinline__ float sample_score(float logit, int cnt, float temp,
                                              float inv_t, float rep,
                                              float pres, float freq,
                                              uint32_t hrow, int col) {
  const bool seen = cnt > 0;
  const float scaled = logit > 0.f ? logit / rep : __fmul_rn(logit, rep);
  float pen = seen ? scaled : logit;
  pen = __fsub_rn(pen, __fmul_rn((float)cnt, freq));
  pen = __fsub_rn(pen, seen ? pres : 0.f);
  if (!(temp > 0.f)) return pen;
  const float g = gumbel(mix(hrow ^ (uint32_t)col));
  return __fadd_rn(__fmul_rn(pen, inv_t), g);
}

// (s, i) beats (bs, bi): larger score, or equal score at a lower index
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

using repro::kSkinnyRows;
using repro::kSkinnyWarps;

__global__ void __launch_bounds__(kSkinnyWarps * 32)
head_sample_tile_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const int* __restrict__ counts,
                        const float* __restrict__ temp,
                        const float* __restrict__ rep,
                        const float* __restrict__ pres,
                        const float* __restrict__ freq,
                        const int* __restrict__ seed,
                        const int* __restrict__ step, int base,
                        float* __restrict__ part_score,
                        int* __restrict__ part_idx, int M, int K, int N) {
  __shared__ float part[kSkinnyWarps][kSkinnyRows][32];
  __shared__ float best[kSkinnyRows];
  __shared__ int best_idx[kSkinnyRows];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * kSkinnyRows;  // this block's row chunk
  const int m = min(kSkinnyRows, M - r0);
  const int tile = blockIdx.y, tiles = gridDim.y;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int n = tile * kTile + pass * 32 + lane;  // N % 128 == 0: inside
    repro::skinny_pass<float>(x + (size_t)r0 * K, w, n, m, K, N, part);
    __syncthreads();
    // epilogue: warp v takes chunk row v (m <= 8 < 16 warps); lane = column
    for (int rl = warp; rl < m; rl += kSkinnyWarps) {
      const int r = r0 + rl;
      const float sum = repro::skinny_sum(part, rl, lane);
      const float t = temp[r];
      const float inv_t = t > 0.f ? 1.f / t : 1.f;
      const uint32_t hrow =
          mix(mix((uint32_t)seed[r] + kSaltToken) ^ (uint32_t)step[r]);
      float s = sample_score(sum, counts[(size_t)r * N + n], t, inv_t, rep[r],
                             pres[r], freq[r], hrow, base + n);
      int i = n;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, s, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (beats(os, oi, s, i)) {
          s = os;
          i = oi;
        }
      }
      // passes run in ascending column order: strict > keeps the earlier
      if (lane == 0 && (pass == 0 || s > best[rl])) {
        best[rl] = s;
        best_idx[rl] = i;
      }
    }
    __syncthreads();  // part[] is rewritten by the next pass
  }
  for (int rl = threadIdx.x; rl < m; rl += blockDim.x) {
    part_score[(size_t)(r0 + rl) * tiles + tile] = best[rl];
    part_idx[(size_t)(r0 + rl) * tiles + tile] = best_idx[rl];
  }
}

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
head_sample_reduce_kernel(const float* __restrict__ part_score,
                          const int* __restrict__ part_idx, int tiles,
                          float* __restrict__ out_score,
                          int* __restrict__ out_idx) {
  __shared__ float ws[kReduceThreads / 32];
  __shared__ int wi[kReduceThreads / 32];
  const int r = blockIdx.x;
  float s = -INFINITY;
  int i = INT_MAX;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const float v = part_score[(size_t)r * tiles + t];
    const int j = part_idx[(size_t)r * tiles + t];
    if (beats(v, j, s, i)) {
      s = v;
      i = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    ws[warp] = s;
    wi[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < kReduceThreads / 32; ++v)
      if (beats(ws[v], wi[v], s, i)) {
        s = ws[v];
        i = wi[v];
      }
    out_score[r] = s;
    out_idx[r] = i;
  }
}

}  // namespace

extern "C" int head_sample_fused_launch(
    const void* x, const void* w, const void* counts, const void* temp,
    const void* rep, const void* pres, const void* freq, const void* seed,
    const void* step, int base, void* part_score, void* part_idx,
    void* out_score, void* out_idx, int M, int K, int N, void* stream) {
  if (M < 1 || M > 32 || K < kTile || K % kTile || N < kTile || N % kTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* cn = static_cast<const int*>(counts);
  const auto* tf = static_cast<const float*>(temp);
  const auto* rp = static_cast<const float*>(rep);
  const auto* pr = static_cast<const float*>(pres);
  const auto* fr = static_cast<const float*>(freq);
  const auto* sd = static_cast<const int*>(seed);
  const auto* st = static_cast<const int*>(step);
  auto* ps = static_cast<float*>(part_score);
  auto* pi = static_cast<int*>(part_idx);
  // row chunks vary fastest: the chunks of one tile share its weight slab
  const dim3 grid((M + kSkinnyRows - 1) / kSkinnyRows, N / kTile);
  head_sample_tile_kernel<<<grid, kSkinnyWarps * 32, 0, s>>>(
      xf, wf, cn, tf, rp, pr, fr, sd, st, base, ps, pi, M, K, N);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  head_sample_reduce_kernel<<<M, kReduceThreads, 0, s>>>(
      ps, pi, N / kTile, static_cast<float*>(out_score),
      static_cast<int*>(out_idx));
  return (int)cudaGetLastError();
}
