// Causal flash attention over a full (or continued) sequence:
//   o[b, t, h] = softmax_kj(q[b, t, h] . k[b, kj, h / g] * sm_scale) v[b, kj, h / g]
// with key kj valid for query row t iff start[b] <= kj <= qi, qi = t +
// q_offset[b] (and kj > qi - window when a window is set).
//
// Replaces: src/repro/kernels/attn/kernel.py, flash_prefill_pallas — the
// prefill attention of generate, of serve's padded admissions and of its
// chunked-prefill continuations (T chunk rows at q_offset against S cache
// slots).
//
// What bounds it on the H100: bytes at the path's lengths (q, k, v and o
// read or written once outweigh 4 D flops per visible query-key pair at the
// bf16 tensor-core rate up to T = S of about 1200); this FMA kernel runs
// far above either bound.
//
// Design: one block per (tile of 64 query rows, query head, row) walks the
// KV tiles in ascending order (flash_tile.cuh) — the loop replaces the
// Pallas grid's sequential KV axis, so the first tile computed always holds
// key `start`, valid for every real row. Tiles above the diagonal, wholly
// left of `start` or wholly outside the window are skipped, as the Pallas
// kernel skips them, and never read; the ragged T and S edges are masked
// instead of padded. q/k/v/o are read in the model layout [B, T, H, D]
// through strides: no transposed copy. GQA maps query head h to KV head
// h / g.
#include "flash_tile.cuh"

namespace {

using namespace repro::flash;

struct CausalPolicy {
  static constexpr bool kProbMask = false;
  int qi0, qi_last, start, window, n_kv;

  __device__ int first_tile() const { return start / kBKV; }
  __device__ int last_tile() const {
    return min((n_kv - 1) / kBKV, qi_last / kBKV);
  }
  __device__ bool runs(int kj0) const {
    bool run = kj0 <= qi_last && kj0 + kBKV - 1 >= start;
    if (window > 0) run = run && kj0 + kBKV - 1 > qi0 - window;
    return run;
  }
  __device__ bool valid(int row, int kj) const {
    const int qi = qi0 + row;
    bool ok = kj <= qi && kj >= start;
    if (window > 0) ok = ok && kj > qi - window;
    return ok;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ q_offset, T* __restrict__ out,
                     int T_len, int S, int Hq, int Hkv, int D, float sm_scale,
                     int window, float softcap) {
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D, kv_stride = (long)Hkv * D;
  const long q_base = ((long)b * T_len + i0) * q_stride + (long)h * D;
  const long kv_base = (long)b * S * kv_stride + (long)hk * D;
  const int n_q = min(kBQ, T_len - i0);
  const int qi0 = q_offset[b] + i0;
  const CausalPolicy pol{qi0, qi0 + n_q - 1, start[b], window, S};
  flash_block<T>(q + q_base, k + kv_base, v + kv_base, out + q_base, n_q,
                 q_stride, S, kv_stride, D, sm_scale, softcap, pol);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* start,
           const void* q_offset, void* out, int B, int T_len, int S, int Hq,
           int Hkv, int D, float sm_scale, int window, float softcap,
           cudaStream_t s) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  const cudaError_t e = allow_smem(flash_prefill_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(q_offset), static_cast<T*>(out), T_len, S,
      Hq, Hkv, D, sm_scale, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* start,
                                    const void* q_offset, void* out, int B,
                                    int T_len, int S, int Hq, int Hkv, int D,
                                    float sm_scale, int window, float softcap,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, start, q_offset, out, B, T_len, S,
                                 Hq, Hkv, D, sm_scale, window, softcap, s);
  return launch<float>(q, k, v, start, q_offset, out, B, T_len, S, Hq, Hkv,
                       D, sm_scale, window, softcap, s);
}
