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
// 1. the persistent float body of skinny_float.cuh — the greedy head's
//    (sta_gemm_skinny.cu): 64-column tiles with all M <= 32 rows, one block
//    a SM walking tiles blockIdx.x, + gridDim.x through one TMA weight ring
//    — with the sampling epilogue SampleEpi in place of the store. The
//    logits are that body's sums, so every logit is bit-equal to
//    sta_gemm_skinny's (temperature-0 sampling with default penalties picks
//    greedy's token exactly) at any M. Per logit, in registers: penalties
//    from counts[r, col] (coalesced over a warp's 32 columns), 1/T, and the
//    murmur3 counter hash in native uint32 for the Gumbel noise; a warp's
//    argmax by `beats` (ties to the lower column), folded into a running
//    best per (row, half tile) that the block keeps in shared memory across
//    its tiles. At the end the block merges the two halves of each row and
//    leaves one (best, index) partial per row: [M, blocks], blocks from K
//    and N alone (head_sample_fused_partials).
// 2. head_sample_reduce_kernel: one block per row merges the blocks'
//    partials by `beats`: the larger score wins, the lower index on ties —
//    so the result is jnp.argmax's first maximum, independent of block
//    order or grid. It is a programmatic dependent launch (its launch
//    overlaps the body's last blocks; it waits for their stores).
// Arithmetic follows the reference op by op: no FMA contraction in the
// epilogue (__fmul_rn / __fsub_rn / __fadd_rn), IEEE division, logf built
// without --use_fast_math (it may differ from the host's log by an ulp).
#include <limits.h>
#include <math.h>

#include "skinny_float.cuh"

namespace {

// K and N multiples of kTile: the routes' rule (the reference's tile), so
// no vocabulary padding can win the argmax
constexpr int kTile = 128;
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

namespace skf = repro::skinny;

// The sampling epilogue of the float body (skinny_float.cuh's policy).
struct SampleEpi {
  const int* counts;
  const float* temp;
  const float* rep;
  const float* pres;
  const float* freq;
  const int* seed;
  const int* step;
  int base;
  float* part_score;  // [M, gridDim.x]
  int* part_idx;
  // M <= 32 rows. Shared stays small: at M 32 the body's ring leaves
  // under 1 KB of the 227 KB for it.
  static constexpr int kRows = 32;
  struct Shared {
    float inv_t[kRows];
    uint32_t hrow[kRows];  // the row's hash of (seed, step)
    float best[kRows][2];  // the running best of (row, half tile)
    int best_idx[kRows][2];
  };

  __device__ __forceinline__ void begin(Shared& sh, int M) const {
    for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
      if (r < M) {
        const float t = temp[r];
        sh.inv_t[r] = t > 0.f ? 1.f / t : 1.f;
        sh.hrow[r] =
            mix(mix((uint32_t)seed[r] + kSaltToken) ^ (uint32_t)step[r]);
      }
      for (int h = 0; h < 2; ++h) {
        sh.best[r][h] = -INFINITY;
        sh.best_idx[r][h] = INT_MAX;
      }
    }
  }

  // a warp holds row r's 32 adjacent columns (half h of the 64-column
  // tile): its scores' argmax, folded into the row's running best
  __device__ __forceinline__ void chunk(Shared& sh, float sum, int r, int col,
                                        bool live, int N) const {
    float s = -INFINITY;
    int i = INT_MAX;
    if (live) {
      s = sample_score(sum, counts[(size_t)r * N + col], temp[r], sh.inv_t[r],
                       rep[r], pres[r], freq[r], sh.hrow[r], base + col);
      i = col;
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
    const int h = (threadIdx.x / 32) & 1;
    if (threadIdx.x % 32 == 0 &&
        beats(s, i, sh.best[r][h], sh.best_idx[r][h])) {
      sh.best[r][h] = s;
      sh.best_idx[r][h] = i;
    }
  }

  // rank 0 of the cluster (the only one with chunks) leaves the block's
  // partial of each row
  __device__ __forceinline__ void end(Shared& sh, int M) const {
    // the merge may be scheduled (it waits for this grid's stores)
    asm volatile("griddepcontrol.launch_dependents;");
    if (blockIdx.y != 0) return;
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      float s = sh.best[r][0];
      int i = sh.best_idx[r][0];
      if (beats(sh.best[r][1], sh.best_idx[r][1], s, i)) {
        s = sh.best[r][1];
        i = sh.best_idx[r][1];
      }
      part_score[(size_t)r * gridDim.x + blockIdx.x] = s;
      part_idx[(size_t)r * gridDim.x + blockIdx.x] = i;
    }
  }
};

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
head_sample_reduce_kernel(const float* __restrict__ part_score,
                          const int* __restrict__ part_idx, int parts,
                          float* __restrict__ out_score,
                          int* __restrict__ out_idx) {
  __shared__ float ws[kReduceThreads / 32];
  __shared__ int wi[kReduceThreads / 32];
  const int r = blockIdx.x;
  float s = -INFINITY;
  int i = INT_MAX;
  // launched early (programmatic dependent launch): wait until the body's
  // grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int t = threadIdx.x; t < parts; t += blockDim.x) {
    const float v = part_score[(size_t)r * parts + t];
    const int j = part_idx[(size_t)r * parts + t];
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

// The partials a row leaves (the float body's blocks): the wrapper's
// workspace is [M, head_sample_fused_partials(K, N)], a function of K and N
// alone.
extern "C" int head_sample_fused_partials(int K, int N) {
  return skf::blocks(K, N);
}

extern "C" int head_sample_fused_launch(
    const void* x, const void* w, const void* counts, const void* temp,
    const void* rep, const void* pres, const void* freq, const void* seed,
    const void* step, int base, void* part_score, void* part_idx,
    void* out_score, void* out_idx, int M, int K, int N, void* stream) {
  if (M < 1 || M > 32 || K < kTile || K % kTile || N < kTile || N % kTile)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ps = static_cast<float*>(part_score);
  auto* pi = static_cast<int*>(part_idx);
  const skf::FloatArgs a{x, w, M, K, N, 0, 0, skf::row_lv((size_t)N * 4),
                         skf::row_lv((size_t)K * 4)};
  const SampleEpi e{static_cast<const int*>(counts),
                    static_cast<const float*>(temp),
                    static_cast<const float*>(rep),
                    static_cast<const float*>(pres),
                    static_cast<const float*>(freq),
                    static_cast<const int*>(seed),
                    static_cast<const int*>(step),
                    base, ps, pi};
  const cudaError_t err = skf::launch_float<float>(a, e, s);
  if (err != cudaSuccess) return (int)err;
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // the merge, as a programmatic dependent launch: its blocks may be
  // scheduled while the body's last blocks run, hiding its launch latency
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M);
  cfg.blockDim = dim3(kReduceThreads);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, head_sample_reduce_kernel,
                                 static_cast<const float*>(ps),
                                 static_cast<const int*>(pi),
                                 skf::blocks(K, N),
                                 static_cast<float*>(out_score),
                                 static_cast<int*>(out_idx));
}
