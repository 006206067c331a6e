// Block-diagonal causal flash attention over a packed ragged batch:
//   o[t, h] = softmax_kj(q[t, h] . k[kj, h / g] * sm_scale) v[kj, h / g]
// over the keys kj <= t with seg[kj] == seg[t] (and kj > t - window), where
// seg (non-decreasing) names the request owning each packed position.
//
// Replaces: src/repro/kernels/attn/kernel.py, flash_prefill_packed_pallas
// — serve's default packed prefill, every admitted prompt concatenated on
// one token axis with no pad row inside a request.
//
// What bounds it on the H100: bytes at the path's lengths (q, k, v and o
// read or written once outweigh 4 D flops per visible pair, about the sum
// over segments of len^2 / 2, at the bf16 tensor-core rate).
//
// Two bodies, by flash_prefill.cu's rule on (dtype, D) alone, never on T or
// the segments: bf16 with D 64, 128 or 256 runs on the tensor-core body
// (flash_tc.cuh), everything else on the plain-FMA body (flash_tile.cuh). flash_prefill_packed_tc_body exports the rule; the
// wrapper's tc_body mirrors it.
//
// Design: either block body over one packed axis — one block per (tile of
// 64 query rows, query head). A KV tile is skipped when it is
// above the diagonal or when its last key's segment precedes the block's
// first query's (segments are non-decreasing, so the extremes decide), as
// the Pallas kernel skips it. A tile can still hold no key of some real
// row's segment; the explicit probability mask (kProbMask) keeps such a
// row from counting its masked keys while its running max is still -1e30.
// Rows with no valid key at all (the bucket's pad tokens share a segment
// and see each other; a row past T does not exist) stay finite and are
// never read. The ragged T edge is masked, not padded.
#include "flash_tc.cuh"
#include "flash_tile.cuh"

namespace {

using namespace repro::flash;

struct PackedPolicy {
  static constexpr bool kProbMask = true;
  const int32_t* seg;
  int qi0, qi_last, window, T_len, seg_first;

  __device__ int first_tile() const { return 0; }
  __device__ int last_tile() const {
    return min((T_len - 1) / kBKV, qi_last / kBKV);
  }
  __device__ bool runs(int kj0) const {
    const int kj_last = min(kj0 + kBKV, T_len) - 1;
    bool run = kj0 <= qi_last && seg[kj_last] >= seg_first;
    if (window > 0) run = run && kj0 + kBKV - 1 > qi0 - window;
    return run;
  }
  __device__ bool valid(int row, int kj) const {
    const int qi = qi0 + row;
    bool ok = (kj <= qi) & (seg[kj] == seg[qi]);  // both loads, no branch
    if (window > 0) ok = ok && kj > qi - window;
    return ok;
  }
};

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
flash_prefill_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ seg,
                            T* __restrict__ out, int T_len, int Hq, int Hkv,
                            int D, float sm_scale, int window,
                            float softcap) {
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D, kv_stride = (long)Hkv * D;
  const long q_base = (long)i0 * q_stride + (long)h * D;
  const int n_q = min(kBQ, T_len - i0);
  const PackedPolicy pol{seg, i0, i0 + n_q - 1, window, T_len, seg[i0]};
  flash_block<kCols, T>(q + q_base, k + (long)hk * D, v + (long)hk * D,
                 out + q_base, n_q, q_stride, T_len, kv_stride, D, sm_scale,
                 softcap, pol);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* seg,
           void* out, int T_len, int Hq, int Hkv, int D, float sm_scale,
           int window, float softcap, cudaStream_t s) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  // the columns a thread owns by D (cols_for): D <= 128 keeps its 16
  const auto kernel =
      D > 128 ? flash_prefill_packed_kernel<T, cols_for(256)> : flash_prefill_packed_kernel<T, cols_for(128)>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + kBQ - 1) / kBQ, Hq);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(seg),
      static_cast<T*>(out), T_len, Hq, Hkv, D, sm_scale, window, softcap);
  return (int)cudaGetLastError();
}

// The tensor-core body: one block per (query head, tile of 64 rows), the
// last tiles first (the rows deepest into their segments come late).
template <int D>
__global__ void __launch_bounds__(repro::flash_tc::threads<D>())
flash_prefill_packed_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const int32_t* __restrict__ seg,
                               __nv_bfloat16* __restrict__ out, int T_len,
                               int Hq, int Hkv, float sm_scale, int window,
                               float softcap) {
  const int h = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int hk = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D;
  const int n_q = min(kBQ, T_len - i0);
  const PackedPolicy pol{seg, i0, i0 + n_q - 1, window, T_len, seg[i0]};
  repro::flash_tc::flash_block<D>(&qmap, &kmap, &vmap, h * D, hk * D, i0, 0,
                                  out + (long)i0 * q_stride + (long)h * D,
                                  q_stride, n_q, T_len, sm_scale, softcap,
                                  pol);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* seg,
              void* out, int T_len, int Hq, int Hkv, float sm_scale,
              int window, float softcap, cudaStream_t s) {
  namespace ft = repro::flash_tc;
  if (Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  CUtensorMap qm{}, km{}, vm{};
  if (!ft::make_maps<D>(&qm, &km, &vm, q, k, v, 1, T_len, T_len, Hq, Hkv))
    return cudaErrorInvalidValue;
  const auto kernel = flash_prefill_packed_tc_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ft::smem_bytes<D>());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, (T_len + kBQ - 1) / kBQ);
  kernel<<<grid, ft::threads<D>(), ft::smem_bytes<D>(), s>>>(
      qm, km, vm, static_cast<const int32_t*>(seg),
      static_cast<__nv_bfloat16*>(out), T_len, Hq, Hkv, sm_scale, window,
      softcap);
  return (int)cudaGetLastError();
}

bool tc_body(int dtype, int D) {
  return dtype == repro::DT_BF16 && (D == 64 || D == 128 || D == 256);
}

}  // namespace

// 1 where flash_prefill_packed_launch runs the tensor-core body
extern "C" int flash_prefill_packed_tc_body(int dtype, int D) {
  return tc_body(dtype, D) ? 1 : 0;
}

extern "C" int flash_prefill_packed_launch(const void* q, const void* k,
                                           const void* v, const void* seg,
                                           void* out, int T_len, int Hq,
                                           int Hkv, int D, float sm_scale,
                                           int window, float softcap,
                                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_body(dtype, D)) {
    const auto tc = D == 64 ? launch_tc<64>
                    : D == 128 ? launch_tc<128> : launch_tc<256>;
    return tc(q, k, v, seg, out, T_len, Hq, Hkv, sm_scale, window, softcap,
              s);
  }
  if (dtype == repro::DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, seg, out, T_len, Hq, Hkv, D,
                                 sm_scale, window, softcap, s);
  return launch<float>(q, k, v, seg, out, T_len, Hq, Hkv, D, sm_scale,
                       window, softcap, s);
}
