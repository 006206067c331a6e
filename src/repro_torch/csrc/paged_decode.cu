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
// bytes of the live pages over the memory rate; at short contexts, the
// latency of a few dependent loads and of the two launches.
//
// Design: the TPU kernel walks a row's pages in order on one core; here a
// row's live pages are split across blocks and the splits meet in a second
// launch.
// 1. paged_decode_split_kernel, one 128-thread block per (split, KV head,
//    row). A row's live logical pages are j0 .. j1, those holding a valid
//    key (the reference's page skip); split i owns pages [j0 + i P,
//    j0 + i P + P), P = max(1, 64 / page). row_splits is that rule: it
//    reads the row's start, length and window and the page size, never
//    B, n_log, Hkv or a physical page id, so a row's bits are the same
//    alone or in a batch, in the contiguous cache or in the pool. A block
//    walks its split in chunks of up to 64 keys (one chunk where page <= 64;
//    a chunk with no valid key is skipped): it gathers the chunk's K and V
//    rows through the table into shared memory (16-byte cp.async copies,
//    the first chunk's in flight while q is staged; K rows padded by 32
//    bytes so that a quarter-warp's loads fall on distinct banks), scores
//    each key on two threads (half the head dim each, added in a fixed
//    order), folds the chunk into a running max / sum per query row (one
//    warp per row; masked keys score -1e30), and adds P·V: each warp takes
//    16 of the chunk's keys and each lane column pairs, P rounded to V's
//    dtype as the reference casts it, and the four warps' partial sums
//    are added in warp order. It leaves (m, l, acc[G, D]) in f32 in a
//    workspace [B, Hkv, NS, G, D + 2] (NS = ceil(n_log / P), allocated by
//    the wrapper).
// 2. paged_decode_combine_kernel, one block per (KV head, row), merges the
//    row's splits in ascending order (m = max, rescale both sides, add)
//    and divides by max(l, 1e-30). No atomics: two calls give equal bits.
#include "common.cuh"
#include "split_k.cuh"

namespace {

namespace sk = repro::splitk;
using repro::kSmemLimit;  // the H100's per-block shared memory

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;       // keys a block holds in shared memory
constexpr int kSplitKeys = 64;   // a split: max(1, kSplitKeys / page) pages
// the smallest page: a split's 64 keys then span at most 8 pages, 8 table
// lookups
constexpr int kPageMin = 8;
constexpr int kDMax = 256;       // D / 32 <= 8 accumulators a lane in P·V
constexpr int kDAlign = 8;       // D multiple of 8: whole 16-byte rows
constexpr int kKPad = 32;        // bytes after each staged K row
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

// pages of one split: a rule on the page size alone
__host__ __device__ inline int split_pages(int page) {
  return page >= kSplitKeys ? 1 : kSplitKeys / page;
}

// A row's splits: its live logical pages j0 .. j1 (each holds a valid key,
// start <= k <= length and, with a window, k > length - window), cut into
// *n splits of split_pages(page) pages from j0. No valid key: *n = 0.
__host__ __device__ inline void row_splits(int start, int length, int window,
                                           int page, int* j0, int* j1,
                                           int* n) {
  int lo = start;
  if (window > 0 && length - window + 1 > lo) lo = length - window + 1;
  if (lo < 0) lo = 0;
  *j0 = lo / page;
  *j1 = length / page;
  const int pages = lo <= length ? *j1 - *j0 + 1 : 0;
  const int p = split_pages(page);
  *n = (pages + p - 1) / p;
}

// the splits of any row of a table n_log pages wide: the workspace's NS
inline int max_splits(int n_log, int page) {
  const int p = split_pages(page);
  return (n_log + p - 1) / p;
}

// shared memory of a split block, in bytes: q, acc [G, D], the four warps'
// P·V partials [4, G, D], scores [G, 64], (m, l, alpha) and a spare [G]
// (which keeps the K rows on 16 bytes), all f32; the chunk's K rows
// (D * esz + 32 bytes each) and V rows (D * esz)
__host__ __device__ inline int smem_bytes(int G, int D, int esz) {
  return 4 * ((2 + kWarps) * G * D + kChunk * G + 4 * G) +
         kChunk * (2 * D * esz + kKPad);
}

struct DecodeArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int32_t* table;
  const int32_t* lengths;
  const int32_t* start;
  void* out;
  float* work;  // [B, Hkv, NS, G, D] acc, then [B, Hkv, NS, G] m and l
  int B, Hkv, G, D, page, n_log, ns_max, window;
  float sm_scale, softcap;
};

// 16 bytes of T as f32
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  repro::load8(p, v);
}

// two T values (4- or 8-byte aligned) as f32
__device__ __forceinline__ void load2(const float* p, float (&v)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x;
  v[1] = a.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&v)[2]) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = a.x;
  v[1] = a.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) char smem[];
  constexpr int esz = sizeof(T);
  constexpr int E = 16 / esz;  // elements of a 16-byte chunk
  const int G = a.G, D = a.D, page = a.page;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int length = a.lengths[b], st = a.start[b];
  int j0, j1, ns;
  row_splits(st, length, a.window, page, &j0, &j1, &ns);
  if (split >= ns) return;  // uniform: past the row's live pages

  float* q_s = reinterpret_cast<float*>(smem);  // [G, D]
  float* acc = q_s + G * D;                     // [G, D]
  float* pv = acc + G * D;                      // [kWarps, G, D]
  float* sc = pv + kWarps * G * D;              // [G, kChunk]
  float* m_s = sc + G * kChunk;                 // [G]
  float* l_s = m_s + G;                         // [G]
  float* a_s = l_s + G;                         // [G]
  char* k_t = reinterpret_cast<char*>(a_s + 2 * G);  // [kChunk][D esz + 32]
  const int k_row = D * esz + kKPad, v_row = D * esz;
  char* v_t = k_t + kChunk * k_row;             // [kChunk][D esz]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the valid keys [lo, length]; the split's pages [p0, p_end)
  int lo = st;
  if (a.window > 0 && length - a.window + 1 > lo) lo = length - a.window + 1;
  const int p0 = j0 + split * split_pages(page);
  // (pages past the table cannot hold a valid key; the clamp only keeps an
  // out-of-contract length inside the table)
  const int p_end = min(min(p0 + split_pages(page), j1 + 1), a.n_log);
  const int s_end = p_end * page;
  const size_t slot_stride = (size_t)a.Hkv * D * esz;  // bytes
  const char* kg = static_cast<const char*>(a.k_pages) + (size_t)h * D * esz;
  const char* vg = static_cast<const char*>(a.v_pages) + (size_t)h * D * esz;
  const int32_t* tab = a.table + (size_t)b * a.n_log;
  const int cpr = D * esz / 16;  // 16-byte chunks of a row

  // the first chunk at or after c holding a valid key (s_end: none)
  auto live = [&](int c) {
    while (c < s_end && (c > length || min(c + kChunk, s_end) - 1 < lo))
      c += kChunk;
    return c;
  };
  // gather chunk c0's K and V rows through the table (one commit group)
  auto gather = [&](int c0) {
    const int nk = min(kChunk, s_end - c0);
    for (int i = tid; i < nk * cpr; i += kThreads) {
      const int key = i / cpr, ch = i % cpr, slot = c0 + key;
      const size_t off =
          ((size_t)tab[slot / page] * page + slot % page) * slot_stride +
          ch * 16;
      sk::cp_async16(k_t + key * k_row + ch * 16, kg + off, true);
      sk::cp_async16(v_t + key * v_row + ch * 16, vg + off, true);
    }
    sk::cp_async_commit();
  };

  int c0 = live(p0 * page);
  if (c0 < s_end) gather(c0);  // in flight while q is staged
  const T* qb = static_cast<const T*>(a.q) + ((size_t)b * a.Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = repro::to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  while (c0 < s_end) {
    const int nk = min(kChunk, s_end - c0);
    sk::cp_async_wait<0>();
    __syncthreads();

    // scores: key tid / 2, half tid % 2 of the head dim (16-byte chunks
    // 2 it + half), the halves added in a fixed order
    {
      const int key = tid / 2, half = tid % 2;
      const int kk = c0 + key;
      bool valid = key < nk && kk <= length && kk >= st;
      if (a.window > 0) valid = valid && kk > length - a.window;
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        if (key < nk) {
          const T* kr = reinterpret_cast<const T*>(k_t + key * k_row);
          const float* qr = q_s + g * D;
          for (int ch = half; ch < cpr; ch += 2) {
            float kv[E];
            load16(kr + ch * E, kv);
#pragma unroll
            for (int e = 0; e < E; ++e) s = fmaf(qr[ch * E + e], kv[e], s);
          }
        }
        const float o = __shfl_xor_sync(0xffffffffu, s, 1);
        s = half == 0 ? s + o : o + s;
        if (half == 0 && key < nk) {
          s *= a.sm_scale;
          if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
          sc[g * kChunk + key] = valid ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // one warp per query row: fold the chunk into (m, l); P in V's dtype
    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * kChunk;
      const float v0 = lane < nk ? row[lane] : kNegInf;
      const float v1 = lane + 32 < nk ? row[lane + 32] : kNegInf;
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, warp_max(fmaxf(v0, v1)));
      const float e0 = expf(v0 - m_cur), e1 = expf(v1 - m_cur);
      const float psum = warp_sum(e0 + e1);
      row[lane] = repro::round_to<T>(e0);
      row[lane + 32] = repro::round_to<T>(e1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        m_s[g] = m_cur;
        l_s[g] = l_s[g] * alpha + psum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // P·V: warp w takes keys [16 w, 16 w + 16) of the chunk; lane the
    // column pairs 2 lane, 2 lane + 64, ...
    {
      const int k_lo = warp * (kChunk / kWarps);
      const int k_hi = min(k_lo + kChunk / kWarps, nk);
      for (int g = 0; g < G; ++g) {
        float part[kDMax / 32];
#pragma unroll
        for (int j = 0; j < kDMax / 32; ++j) part[j] = 0.f;
        for (int key = k_lo; key < k_hi; ++key) {
          const float p = sc[g * kChunk + key];
          const T* vr = reinterpret_cast<const T*>(v_t + key * v_row);
#pragma unroll
          for (int j = 0; j < kDMax / 64; ++j)
            if (2 * lane + 64 * j < D) {
              float v2[2];
              load2(vr + 2 * lane + 64 * j, v2);
              part[2 * j] = fmaf(p, v2[0], part[2 * j]);
              part[2 * j + 1] = fmaf(p, v2[1], part[2 * j + 1]);
            }
        }
#pragma unroll
        for (int j = 0; j < kDMax / 64; ++j)
          if (2 * lane + 64 * j < D) {
            float* o = pv + (warp * G + g) * D + 2 * lane + 64 * j;
            o[0] = part[2 * j];
            o[1] = part[2 * j + 1];
          }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      float sum = pv[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += pv[w * G * D + i];
      acc[i] = acc[i] * a_s[i / D] + sum;
    }
    c0 = live(c0 + kChunk);
    __syncthreads();  // every warp left the chunk's K and V rows
    if (c0 < s_end) gather(c0);
  }

  // this split's (m, l, acc)
  const size_t bs = ((size_t)b * a.Hkv + h) * a.ns_max + split;
  const size_t n_acc = (size_t)a.B * a.Hkv * a.ns_max * G * D;
  float* w_acc = a.work + bs * G * D;
  float* w_m = a.work + n_acc + bs * G;
  float* w_l = a.work + n_acc + (size_t)a.B * a.Hkv * a.ns_max * G + bs * G;
  for (int i = tid; i < G * D; i += kThreads) w_acc[i] = acc[i];
  for (int g = tid; g < G; g += kThreads) {
    w_m[g] = m_s[g];
    w_l[g] = l_s[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.G, D = a.D;
  int j0, j1, ns;
  row_splits(a.start[b], a.lengths[b], a.window, a.page, &j0, &j1, &ns);
  ns = min(ns, a.ns_max);  // (only an out-of-contract length exceeds it)
  const size_t bh = (size_t)b * a.Hkv + h;
  const size_t n_acc = (size_t)a.B * a.Hkv * a.ns_max * G * D;
  const float* w_acc = a.work + bh * a.ns_max * G * D;
  const float* w_m = a.work + n_acc + bh * a.ns_max * G;
  const float* w_l =
      a.work + n_acc + (size_t)a.B * a.Hkv * a.ns_max * G + bh * a.ns_max * G;
  T* ob = static_cast<T*>(a.out) + bh * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float m = kNegInf, l = 0.f, acc = 0.f;
    for (int s = 0; s < ns; ++s) {  // ascending split order
      const float ms = w_m[s * G + g];
      const float mn = fmaxf(m, ms);
      const float ea = expf(m - mn), eb = expf(ms - mn);
      l = l * ea + w_l[s * G + g] * eb;
      acc = acc * ea + w_acc[(size_t)s * G * D + i] * eb;
      m = mn;
    }
    ob[i] = repro::from_f32<T>(acc / fmaxf(l, kLEps));
  }
}

template <typename T>
int launch(const DecodeArgs& a, cudaStream_t s) {
  const int smem = smem_bytes(a.G, a.D, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.ns_max > 0)
    paged_decode_split_kernel<T>
        <<<dim3(a.ns_max, a.Hkv, a.B), kThreads, smem, s>>>(a);
  paged_decode_combine_kernel<T><<<dim3(a.Hkv, a.B), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, const void* start,
                                   void* out, void* work, int B, int Hkv,
                                   int G, int D, int page, int n_log,
                                   float sm_scale, int window, float softcap,
                                   int dtype, void* stream) {
  const int esz = dtype == repro::DT_BF16 ? 2 : 4;
  if (page < kPageMin || D < 1 || D % kDAlign || D > kDMax ||
      smem_bytes(G, D, esz) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  // the pools' rows are whole 16-byte copies (D % 8 == 0) from 16-byte
  // aligned bases
  if ((reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || Hkv == 0 || G == 0) return 0;
  DecodeArgs a{q, k_pages, v_pages, static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(lengths),
               static_cast<const int32_t*>(start), out,
               static_cast<float*>(work), B, Hkv, G, D, page, n_log,
               max_splits(n_log, page), window, sm_scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DT_BF16) return launch<__nv_bfloat16>(a, s);
  return launch<float>(a, s);
}

// The card's opt-in per-block shared memory (the limit every body's
// dynamic and static shared memory must fit, beside kSmemLimit), or
// -cudaError on failure: read by repro_torch.analysis.smem.
extern "C" int paged_decode_smem_optin(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -(int)e;
}
