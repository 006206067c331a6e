// DBB structured-sparse GEMM for skinny M (decode, M <= 32):
// out = act(scale * (x @ W) + bias), W given as the DBB planes values and
// bitmask[K/8, N] (int32). Three value planes, one body (common.cuh): f32
// values[K/8 * nnz, N] (dbb_gemm_skinny_launch), int8 values whose
// per-channel scale rides the epilogue (dbb_gemm_skinny_i8_launch), and
// the w4 nibble plane values[K/8 * nnz / 2, N] with groupwise scales
// gscale[K/G, N] (dbb_gemm_skinny_w4_launch), all for float x; and int8 x
// on the int8 plane (dbb_gemm_skinny_s8_launch: INT8 x INT8 -> INT32,
// output int32, f32 or int8 requantized).
//
// Replaces: src/repro/kernels/skinny/kernel.py, dbb_gemm_skinny_pallas
// (float activations, its bits=8 and bits=4 branches, and its int8
// activations with the int32 accumulator) — every decode and
// speculative-verify projection of the serving path (M = batch, 3·batch).
//
// What bounds it on the H100: bytes. At M = 8 each weight byte feeds a
// few operations, so the time is the stored weight stream (values +
// bitmask, + the group scales at w4: 2.5 / 1.0 / 0.78 bytes per dense
// weight for the f32 / int8 / w4 planes at k = 4) over the 3.35 TB/s
// memory rate; the activations are a few KB and stay in L1/L2. The w4
// plane's nibble loads are 1-2 bytes a thread (16 bytes of a values row
// per half-warp): poorly coalesced, left for a later PR.
//
// Design: the weight stream is never expanded in device memory. A block
// owns 16 output columns, so even N = 2048 gives 128 column ranges, and
// one chunk of up to 8 rows (M > 8 runs ceil(M / 8) chunks, which vary
// fastest in the launch order, so the chunks after the first find the
// range's weights in L2 and the stream is read from memory about once);
// each half-warp covers the 16 columns (a 64-byte coalesced read of a
// values or bitmask row) and the block's half-warps split the K/8 DBB
// blocks between them, interleaved. Per DBB block a thread loads its
// column's mask and nnz slots through the plane's loader, decompresses
// the 8 dense weights in registers from the bitmask rank (rounded
// through the activation dtype, as the reference casts the tile), loads
// each row's 8 activations with one vector load (broadcast across the
// half-warp) and accumulates 8 f32 sums (int32 on the int8 branch, from
// I8Plane's integer slots and sign-extended 8-byte activation loads). The
// partial sums meet in shared memory (int32 on the int8 branch, so the
// cross-slice reduction stays exact), the epilogue runs on the total and
// the block stores its columns once.
#include "common.cuh"

namespace {

constexpr int kCols = 16;                  // output columns per block
constexpr int kSplit = 32 / kCols;         // K slices per warp
constexpr int kRows = 8;                   // rows per block (one chunk)
constexpr int kWarps = 16;

template <typename T, typename TO, typename Plane>
__global__ void __launch_bounds__(kWarps * 32)
dbb_gemm_skinny_kernel(const T* __restrict__ x, const Plane plane,
                       const int32_t* __restrict__ bitmask,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, TO* __restrict__ out,
                       int M, int K, int N, int nnz, int act) {
  using Acc = repro::acc_t<T>;
  constexpr int kSlices = kWarps * kSplit;
  __shared__ Acc part[kSlices][kRows][kCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = lane % kCols, slice = warp * kSplit + lane / kCols;
  const int n = blockIdx.y * kCols + col;
  const int kb_total = K / repro::kDbbBlock;
  const int r0 = blockIdx.x * kRows;       // this block's row chunk
  const int m = min(kRows, M - r0);
  x += (size_t)r0 * K;
  out += (size_t)r0 * N;

  Acc acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = Acc(0);

  if (n < N) {
    for (int kb = slice; kb < kb_total; kb += kSlices) {
      const uint32_t mask = (uint32_t)bitmask[(size_t)kb * N + n];
      Acc slot[repro::kNnzMax];
      plane.load(kb, n, N, nnz, slot);
      Acc w[repro::kDbbBlock];
      repro::decompress_block<T>(mask, slot, nnz, w);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= m) break;
        Acc xv[8];
        repro::load8(x + (size_t)r * K + (size_t)kb * repro::kDbbBlock, xv);
#pragma unroll
        for (int p = 0; p < repro::kDbbBlock; ++p)
          acc[r] = repro::mac(xv[p], w[p], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) part[slice][r][col] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kWarps * 32) {
    const int r = i / kCols, c = i % kCols, cn = blockIdx.y * kCols + c;
    if (r >= m || cn >= N) continue;
    Acc sum = 0;
#pragma unroll
    for (int v = 0; v < kSlices; ++v) sum += part[v][r][c];
    out[(size_t)r * N + cn] = repro::finish<TO>(sum, cn, scale, bias, act);
  }
}

template <typename T, typename TO, typename Plane>
void launch_t(const void* x, const Plane plane, const void* bitmask,
              const void* scale, const void* bias, void* out, int M, int K,
              int N, int nnz, int act, cudaStream_t s) {
  const dim3 grid((M + kRows - 1) / kRows, (N + kCols - 1) / kCols);
  dbb_gemm_skinny_kernel<T, TO, Plane><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), plane, static_cast<const int32_t*>(bitmask),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), M, K, N, nnz, act);
}

bool dims_ok(int M, int K, int nnz) {
  return M >= 1 && M <= 32 && nnz >= 1 && nnz <= repro::kNnzMax &&
         K % repro::kDbbBlock == 0;
}

// float x: out in x's dtype (dtype)
template <typename Plane>
int launch(const void* x, const Plane plane, const void* bitmask,
           const void* scale, const void* bias, void* out, int M, int K,
           int N, int nnz, int act, int dtype, void* stream) {
  if (!dims_ok(M, K, nnz)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DT_BF16)
    launch_t<__nv_bfloat16, __nv_bfloat16>(x, plane, bitmask, scale, bias,
                                           out, M, K, N, nnz, act, s);
  else
    launch_t<float, float>(x, plane, bitmask, scale, bias, out, M, K, N, nnz,
                           act, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dbb_gemm_skinny_launch(const void* x, const void* values,
                                      const void* bitmask, const void* scale,
                                      const void* bias, void* out, int M,
                                      int K, int N, int nnz, int act,
                                      int dtype, void* stream) {
  return launch(x, repro::F32Plane{static_cast<const float*>(values)},
                bitmask, scale, bias, out, M, K, N, nnz, act, dtype, stream);
}

extern "C" int dbb_gemm_skinny_i8_launch(const void* x, const void* values,
                                         const void* bitmask,
                                         const void* scale, const void* bias,
                                         void* out, int M, int K, int N,
                                         int nnz, int act, int dtype,
                                         void* stream) {
  return launch(x, repro::I8Plane{static_cast<const int8_t*>(values)},
                bitmask, scale, bias, out, M, K, N, nnz, act, dtype, stream);
}

extern "C" int dbb_gemm_skinny_w4_launch(const void* x, const void* values,
                                         const void* bitmask,
                                         const void* gscale, int group,
                                         const void* scale, const void* bias,
                                         void* out, int M, int K, int N,
                                         int nnz, int act, int dtype,
                                         void* stream) {
  if (!repro::w4_dims_ok(K, nnz, group)) return (int)cudaErrorInvalidValue;
  return launch(x,
                repro::W4Plane{static_cast<const int8_t*>(values),
                               static_cast<const float*>(gscale), group},
                bitmask, scale, bias, out, M, K, N, nnz, act, dtype, stream);
}

// int8 x on the int8 values plane: out_dtype DT_I32, DT_F32 or DT_I8
extern "C" int dbb_gemm_skinny_s8_launch(const void* x, const void* values,
                                         const void* bitmask, const void* scale,
                                         const void* bias, void* out, int M, int K,
                                         int N, int nnz, int act, int out_dtype,
                                         void* stream) {
  if (!dims_ok(M, K, nnz)) return (int)cudaErrorInvalidValue;
  const repro::I8Plane plane{static_cast<const int8_t*>(values)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::with_s8_out(out_dtype, [&](auto o) {
    launch_t<int8_t, decltype(o)>(x, plane, bitmask, scale, bias, out, M, K,
                                  N, nnz, act, s);
  });
}
