// Dense weight-streaming GEMM for skinny M (M <= 32):
// out = act(scale * (x @ w) + bias), x[M, K], w[K, N] of one dtype: f32 or
// bf16, output in that dtype (sta_gemm_skinny_launch); or int8, the
// INT8 x INT8 -> INT32 datapath, output int32, f32 or int8 requantized
// (sta_gemm_skinny_s8_launch, on the int8 split-K body of split_k_s8.cuh,
// shared with dbb_gemm_skinny.cu: 64 columns and all M <= 32 rows a
// block, K split over <= 8 blocks in 128-deep stages, s8 mma.sync, the
// slices added by a second launch from a workspace the wrapper allocates;
// bound by the weight stream, see that header).
//
// Replaces: src/repro/kernels/skinny/kernel.py, sta_gemm_skinny_pallas —
// on the serving path the tied-embedding head, x[8, 2048] f32 times
// w[2048, 50304] f32, whose argmax is the greedy token (x[24, 2048] in the
// speculative verify), and the dense decode layers at bf16.
//
// The float branch runs the persistent float body of skinny_float.cuh
// (what bounds it, its K order and its design are there) with its store
// epilogue (StoreEpi: scale -> bias -> act, one store of x's dtype). The
// sampling head (head_sample_fused.cu) runs the same body with its own
// epilogue, so the two heads' logits are the same bits.
#include "skinny_float.cuh"
#include "split_k_s8.cuh"

namespace skf = repro::skinny;

extern "C" int sta_gemm_skinny_launch(const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      void* out, int M, int K, int N, int act,
                                      int dtype, void* stream) {
  if (M < 1 || M > 32 || K % skf::kGroupK) return (int)cudaErrorInvalidValue;
  // x's rows are whole 16-byte copies (K % 8 == 0) from 16-byte aligned
  // bases, as are w's where N allows
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esz = dtype == repro::DT_BF16 ? 2 : 4;
  const skf::FloatArgs a{x, w, M, K, N, 0, 0, skf::row_lv(N * esz),
                        skf::row_lv(K * esz)};
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const cudaError_t e =
      dtype == repro::DT_BF16
          ? skf::launch_float<__nv_bfloat16>(
                a,
                skf::StoreEpi<__nv_bfloat16>{
                    sc, bi, static_cast<__nv_bfloat16*>(out), act},
                s)
          : skf::launch_float<float>(
                a, skf::StoreEpi<float>{sc, bi, static_cast<float*>(out), act},
                s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// int8 operands (split_k_s8.cuh): out_dtype DT_I32, DT_F32 or DT_I8;
// work: sta_gemm_skinny_s8_splits(K, N) * M * N int32
extern "C" int sta_gemm_skinny_s8_launch(const void* x, const void* w,
                                         const void* scale, const void* bias,
                                         void* out, void* work, int M, int K,
                                         int N, int act, int out_dtype,
                                         void* stream) {
  if (M < 1 || M > 32 || K % skf::kGroupK || work == nullptr)
    return (int)cudaErrorInvalidValue;
  namespace s8 = repro::splitk8;
  const s8::Args a{static_cast<const int8_t*>(x),
                   static_cast<const int8_t*>(w),
                   nullptr,
                   static_cast<const float*>(scale),
                   static_cast<const float*>(bias),
                   out, static_cast<int*>(work), M, K, N, 1, act};
  int rc = 0;
  const int e = repro::with_s8_out(out_dtype, [&](auto o) {
    rc = s8::launch<decltype(o), false>(a, static_cast<cudaStream_t>(stream));
  });
  return rc != 0 ? rc : e;
}

// the int8 body's K slices at (K, N): its workspace holds
// sta_gemm_skinny_s8_splits(K, N) * M * N int32
extern "C" int sta_gemm_skinny_s8_splits(int K, int N) {
  return repro::splitk8::splits(K, N);
}
