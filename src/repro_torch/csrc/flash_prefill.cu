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
// bf16 tensor-core rate up to T = S of about 1200).
//
// Two bodies, chosen by a rule on (dtype, D) alone, never on B, T, S:
//   - bf16 with D 64, 128 or 256 (olmo-1b's D 128, paligemma's 256) runs
//     on the tensor-core body (flash_tc.cuh: TMA-fed K/V stages, wgmma for
//     both products, the softmax on the accumulator fragment; D 256 on two
//     consumer warpgroups);
//   - everything else (f32, bf16 at other D up to 256) runs the plain-FMA
//     body (flash_tile.cuh).
// flash_prefill_tc_body exports the rule; the wrapper's tc_body mirrors it.
//
// Design: one block per (tile of 64 query rows, query head, row) walks the
// KV tiles in ascending order (either body) — the loop replaces the
// Pallas grid's sequential KV axis, so the first tile computed always holds
// key `start`, valid for every real row. Tiles above the diagonal, wholly
// left of `start` or wholly outside the window are skipped, as the Pallas
// kernel skips them, and never read; the ragged T and S edges are masked
// instead of padded. q/k/v/o are read in the model layout [B, T, H, D]
// through strides: no transposed copy. GQA maps query head h to KV head
// h / g.
#include "flash_tc.cuh"
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

template <typename T, int kCols>
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
  flash_block<kCols, T>(q + q_base, k + kv_base, v + kv_base, out + q_base, n_q,
                 q_stride, S, kv_stride, D, sm_scale, softcap, pol);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* start,
           const void* q_offset, void* out, int B, int T_len, int S, int Hq,
           int Hkv, int D, float sm_scale, int window, float softcap,
           cudaStream_t s) {
  if (D < 1 || D > kDMax || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  // the columns a thread owns by D (cols_for): D <= 128 keeps its 16
  const auto kernel =
      D > 128 ? flash_prefill_kernel<T, cols_for(256)> : flash_prefill_kernel<T, cols_for(128)>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T_len + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(q_offset), static_cast<T*>(out), T_len, S,
      Hq, Hkv, D, sm_scale, window, softcap);
  return (int)cudaGetLastError();
}

// The tensor-core body: one block per (query head, tile of 64 rows, row),
// the tiles of the diagonal's end first (they walk the most keys).
template <int D>
__global__ void __launch_bounds__(repro::flash_tc::threads<D>())
flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const int32_t* __restrict__ start,
                        const int32_t* __restrict__ q_offset,
                        __nv_bfloat16* __restrict__ out, int T_len, int S,
                        int Hq, int Hkv, float sm_scale, int window,
                        float softcap) {
  const int h = blockIdx.x, b = blockIdx.z;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int hk = h / (Hq / Hkv);
  const long q_stride = (long)Hq * D;
  const int n_q = min(kBQ, T_len - i0);
  const int qi0 = q_offset[b] + i0;
  const CausalPolicy pol{qi0, qi0 + n_q - 1, start[b], window, S};
  repro::flash_tc::flash_block<D>(
      &qmap, &kmap, &vmap, h * D, hk * D, i0, b,
      out + ((long)b * T_len + i0) * q_stride + (long)h * D, q_stride, n_q, S,
      sm_scale, softcap, pol);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* start,
              const void* q_offset, void* out, int B, int T_len, int S,
              int Hq, int Hkv, float sm_scale, int window, float softcap,
              cudaStream_t s) {
  namespace ft = repro::flash_tc;
  if (Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  CUtensorMap qm{}, km{}, vm{};
  if (!ft::make_maps<D>(&qm, &km, &vm, q, k, v, B, T_len, S, Hq, Hkv))
    return cudaErrorInvalidValue;
  const auto kernel = flash_prefill_tc_kernel<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ft::smem_bytes<D>());
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, (T_len + kBQ - 1) / kBQ, B);
  kernel<<<grid, ft::threads<D>(), ft::smem_bytes<D>(), s>>>(
      qm, km, vm, static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(q_offset), static_cast<__nv_bfloat16*>(out),
      T_len, S, Hq, Hkv, sm_scale, window, softcap);
  return (int)cudaGetLastError();
}

bool tc_body(int dtype, int D) {
  return dtype == repro::DT_BF16 && (D == 64 || D == 128 || D == 256);
}

}  // namespace

// 1 where flash_prefill_launch runs the tensor-core body for these operands
extern "C" int flash_prefill_tc_body(int dtype, int D) {
  return tc_body(dtype, D) ? 1 : 0;
}

extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* start,
                                    const void* q_offset, void* out, int B,
                                    int T_len, int S, int Hq, int Hkv, int D,
                                    float sm_scale, int window, float softcap,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc_body(dtype, D)) {
    const auto tc = D == 64 ? launch_tc<64>
                    : D == 128 ? launch_tc<128> : launch_tc<256>;
    return tc(q, k, v, start, q_offset, out, B, T_len, S, Hq, Hkv, sm_scale,
              window, softcap, s);
  }
  if (dtype == repro::DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, start, q_offset, out, B, T_len, S,
                                 Hq, Hkv, D, sm_scale, window, softcap, s);
  return launch<float>(q, k, v, start, q_offset, out, B, T_len, S, Hq, Hkv,
                       D, sm_scale, window, softcap, s);
}
