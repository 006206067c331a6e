// One-token decode attention over a paged KV cache:
//   o[b, h, g] = softmax_k(q[b, h, g] . K[b, k, h] * sm_scale) V[b, k, h]
// with the keys of row b gathered page by page through block_table[b, :],
// valid iff start[b] <= k <= lengths[b] (and k > lengths[b] - window).
//
// Replaces: src/repro/kernels/attn/kernel.py, paged_decode_pallas — decode
// attention of the serving path; the contiguous cache [B, S, Hkv, D] runs
// it as the pool [B * S/page, page, Hkv, D] under an identity table.
//
// What bounds it on the H100: bytes. Each (row, KV head) reads its live
// K/V pages once for ~4 operations per element, so the time is the KV
// bytes of the live pages over the memory rate (plus launch latency at
// short contexts).
//
// Design: one block per (row, KV head) walks the row's logical pages in
// order, skipping a page that holds no valid key (the reference's page
// skip), with an online softmax: the G query rows sit in shared memory as
// f32; warps score the page's keys (lanes across the head dim, a warp
// reduction per key), one warp per query row folds the page into the
// running max / sum, and threads across the head dim accumulate P·V in
// f32 with P rounded to V's dtype, as the reference casts it. Masked keys
// score -1e30; the result divides by max(l, 1e-30). Blocks share no state.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF sentinel
constexpr float kLEps = 1e-30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ start, T* __restrict__ out,
                    int Hkv, int G, int D, int page, int n_log,
                    float sm_scale, int window, float softcap) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [G, D]
  float* acc = q_s + G * D;       // [G, D]
  float* sc = acc + G * D;        // [G, page] scores, then probabilities
  float* m_s = sc + G * page;     // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* a_s = l_s + G;           // [G] this page's rescale factor

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int nwarps = kThreads / 32;
  const size_t slot_stride = (size_t)Hkv * D;

  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = repro::to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b], st = start[b];
  for (int j = 0; j < n_log; ++j) {
    // page skip: any valid slot <=> page start <= length, page end past
    // the row's left padding, and with a window, page end inside it
    bool run = j * page <= length && (j + 1) * page - 1 >= st;
    if (window > 0) run = run && (j + 1) * page - 1 > length - window;
    if (!run) continue;  // uniform across the block
    const size_t base = ((size_t)table[(size_t)b * n_log + j] * page) *
                            slot_stride + (size_t)h * D;
    const T* kp = k_pages + base;
    const T* vp = v_pages + base;

    for (int idx = warp; idx < G * page; idx += nwarps) {
      const int g = idx / page, slot = idx % page;
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(q_s[g * D + d], repro::to_f32(kp[slot * slot_stride + d]), s);
      s = warp_sum(s);
      if (lane == 0) {
        s *= sm_scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int kk = j * page + slot;
        bool valid = kk <= length && kk >= st;
        if (window > 0) valid = valid && kk > length - window;
        sc[idx] = valid ? s : kNegInf;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float mx = kNegInf;
      for (int slot = lane; slot < page; slot += 32)
        mx = fmaxf(mx, sc[g * page + slot]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int slot = lane; slot < page; slot += 32) {
        const float p = expf(sc[g * page + slot] - m_cur);
        sc[g * page + slot] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        m_s[g] = m_cur;
        l_s[g] = l_s[g] * alpha + psum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int d = tid; d < D; d += kThreads) {
      for (int g = 0; g < G; ++g) {
        float a = acc[g * D + d] * a_s[g];
        for (int slot = 0; slot < page; ++slot)
          a = fmaf(repro::round_to<T>(sc[g * page + slot]),
                   repro::to_f32(vp[slot * slot_stride + d]), a);
        acc[g * D + d] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    ob[i] = repro::from_f32<T>(acc[i] / fmaxf(l_s[i / D], kLEps));
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, const void* start,
           void* out, int B, int Hkv, int G, int D, int page, int n_log,
           float sm_scale, int window, float softcap, cudaStream_t s) {
  const size_t smem = sizeof(float) * (2 * (size_t)G * D + (size_t)G * page +
                                       3 * (size_t)G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(start), static_cast<T*>(out), Hkv, G, D,
      page, n_log, sm_scale, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, const void* start,
                                   void* out, int B, int Hkv, int G, int D,
                                   int page, int n_log, float sm_scale,
                                   int window, float softcap, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DT_BF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, start,
                                 out, B, Hkv, G, D, page, n_log, sm_scale,
                                 window, softcap, s);
  return launch<float>(q, k_pages, v_pages, table, lengths, start, out, B,
                       Hkv, G, D, page, n_log, sm_scale, window, softcap, s);
}
