// One block body for the port's M-tiled GEMMs whose operand tiles come
// from loaders: sta_gemm.cu (rows of x, a dense weight), conv_gemm.cu
// (implicit im2col gather, a dense weight) and conv_gemm_dbb.cu (the same
// gather, the DBB planes decompressed in registers). The kernels differ
// only in the loaders they hand to `gemm_tile`.
//
// A 256-thread block owns a 128 x 128 output tile and loops over K in
// steps of 16. Each step every thread fetches one 8-wide K group of one
// activation row into the transposed shared-memory tile `xs` and one
// 8-wide group of the weight tile into `ws`; then each thread accumulates
// an 8 x 8 register tile with f32 FMAs (a bf16 product is exact in f32,
// so this computes what a bf16 tensor-core product with f32 accumulation
// computes). The epilogue (scale -> bias -> act) runs on those registers
// before the one store of the output. Ragged M, N and K edges are masked
// in the loaders and the store: nothing is padded or copied. Shared
// memory is a fixed 16.6 KB whatever the shapes; no state crosses blocks.
//
// int8 operands (the paper's datapath) run the same body on their
// accumulator type acc_t<int8_t> = int: the loaders sign-extend int8 into
// int32 tiles of the same 16.6 KB, each thread keeps an 8 x 8 int32
// register tile summed with exact integer multiply-adds (IMAD), and the
// store runs the int32 epilogue (common.cuh, int_epilogue). Integer sums
// are exact in any order, so the int32 result is the reference's bit for
// bit at any K.
#pragma once

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int BM = 128, BN = 128, BK = 16, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
static_assert(BM * (BK / 8) == kThreads, "one activation group per thread");
static_assert(BK * (BN / 8) == kThreads, "one weight group per thread");
static_assert((BK / kDbbBlock) * BN == kThreads, "one DBB pair per thread");

// This thread's activation row in the tile, and its 8-wide K offset.
__device__ __forceinline__ int act_row() { return threadIdx.x / (BK / 8); }
__device__ __forceinline__ int act_k() { return (threadIdx.x % (BK / 8)) * 8; }

template <typename A>
__device__ __forceinline__ void zero8(A v[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = A(0);
}

// eight accumulator-type values into a 16-byte aligned shared-memory row
__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(int* dst, const int v[8]) {
  int4* d = reinterpret_cast<int4*>(dst);
  d[0] = make_int4(v[0], v[1], v[2], v[3]);
  d[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// Activations: the rows of a row-major x[M, K].
template <typename T>
struct RowLoader {
  using Acc = acc_t<T>;
  const T* row;  // this thread's row, or nullptr past M
  int K;

  __device__ RowLoader(const T* x, int m, int M, int K_)
      : row(m < M ? x + (size_t)m * K_ : nullptr), K(K_) {}

  // v[e] = x[m, k + e]; zero past K and past M
  __device__ __forceinline__ void load(int k, Acc v[8]) const {
    if (row == nullptr || k >= K) {
      zero8(v);
    } else if (K % 8 == 0) {  // k is a multiple of 8: 8 elements aligned
      load8(row + k, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = k + e < K ? to_acc(row[k + e]) : Acc(0);
    }
  }
};

// Geometry of an NHWC convolution lowered to GEMM: M = B * Ho * Wo output
// pixels, K = kh * kw * C in the reference's order (i * kw + j) * C + c.
struct ConvGeom {
  int B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left;
};

// Activations: the implicit im2col row of one output pixel, gathered
// from the NHWC image in device memory (L2 holds the kh * kw reuse).
// Positions outside the image read zero: SAME padding without a padded
// copy.
template <typename T>
struct ConvGather {
  using Acc = acc_t<T>;
  const T* x;
  ConvGeom g;
  int K;
  int b, ih0, iw0;  // the pixel's image and its window's top-left corner
  bool live;        // false past M

  __device__ ConvGather(const T* x_, int m, const ConvGeom& g_)
      : x(x_), g(g_), K(g_.kh * g_.kw * g_.C) {
    const int M = g.B * g.Ho * g.Wo;
    live = m < M;
    const int mm = live ? m : 0;
    const int ow = mm % g.Wo, r = mm / g.Wo;
    const int oh = r % g.Ho;
    b = r / g.Ho;
    ih0 = oh * g.stride - g.pad_top;
    iw0 = ow * g.stride - g.pad_left;
  }

  __device__ __forceinline__ bool inside(int ih, int iw) const {
    return ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
  }

  __device__ __forceinline__ const T* pixel(int ih, int iw) const {
    return x + (((size_t)b * g.H + ih) * g.W + iw) * g.C;
  }

  // v[e] = patch[m, k + e]
  __device__ __forceinline__ void load(int k, Acc v[8]) const {
    if (!live || k >= K) {
      zero8(v);
      return;
    }
    const int r = k / g.C;
    int c = k - r * g.C;
    int i = r / g.kw, j = r - i * g.kw;
    if (g.C % 8 == 0) {  // the 8 positions share one (i, j): one 16-byte load
      const int ih = ih0 + i, iw = iw0 + j;
      if (inside(ih, iw)) {
        load8(pixel(ih, iw) + c, v);
      } else {
        zero8(v);
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ih = ih0 + i, iw = iw0 + j;
      v[e] = (k + e < K && inside(ih, iw)) ? to_acc(pixel(ih, iw)[c]) : Acc(0);
      if (++c == g.C) {
        c = 0;
        if (++j == g.kw) {
          j = 0;
          ++i;
        }
      }
    }
  }
};

// Weights: a dense row-major w[K, N] in the activation dtype; each thread
// brings 8 consecutive columns of one K row.
template <typename T>
struct DenseWeights {
  using Acc = acc_t<T>;
  const T* w;
  int K, N;

  __device__ __forceinline__ void load(int k0, int n0, Acc (*ws)[BN]) const {
    const int r = threadIdx.x / (BN / 8), c = (threadIdx.x % (BN / 8)) * 8;
    const int k = k0 + r, n = n0 + c;
    Acc v[8];
    if (k >= K || n >= N) {
      zero8(v);
    } else if (N % 8 == 0) {  // n is a multiple of 8: 8 elements aligned
      load8(w + (size_t)k * N + n, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = n + e < N ? to_acc(w[(size_t)k * N + n + e]) : Acc(0);
    }
    store8(&ws[r][c], v);
  }
};

// Weights: the DBB planes values[K/8 * nnz, N] (f32 for float operands,
// int8 for int8 ones) and bitmask[K/8, N] (int32). Each thread
// decompresses one (DBB block, column) pair by bitmask rank straight into
// the tile: the dense weight never exists in device memory. Float values
// are rounded through the activation dtype T, as the reference casts the
// decompressed tile; int8 values are exact. Needs K % 8 == 0.
template <typename T, typename V = float>
struct DbbWeights {
  using Acc = acc_t<T>;
  const V* values;
  const int32_t* bitmask;
  int K, N, nnz;

  __device__ __forceinline__ void load(int k0, int n0, Acc (*ws)[BN]) const {
    const int kbl = threadIdx.x / BN, col = threadIdx.x % BN;
    const int kb = k0 / kDbbBlock + kbl, n = n0 + col;
    uint32_t mask = 0;
    Acc slot[kNnzMax];
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) slot[s] = Acc(0);
    if (kb < K / kDbbBlock && n < N) {
      mask = (uint32_t)bitmask[(size_t)kb * N + n];
#pragma unroll
      for (int s = 0; s < kNnzMax; ++s)
        if (s < nnz) slot[s] = to_acc(values[((size_t)kb * nnz + s) * N + n]);
    }
    Acc w[kDbbBlock];
    decompress_block<T>(mask, slot, nnz, w);
#pragma unroll
    for (int p = 0; p < kDbbBlock; ++p) ws[kbl * kDbbBlock + p][col] = w[p];
  }
};

// The block body: out[m0:m0+BM, n0:n0+BN] of act(scale * (A @ W) + bias)
// for out[M, N] row-major. `a` was built for this thread's row
// m0 + act_row(); both loaders yield the accumulator type Acc (f32, or
// int32 for int8 operands).
template <typename TO, typename ALoad, typename WLoad>
__device__ __forceinline__ void gemm_tile(const ALoad& a, const WLoad& w,
                                          int M, int N, int K, int m0, int n0,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias,
                                          int act, TO* __restrict__ out) {
  using Acc = typename ALoad::Acc;
  __shared__ Acc xs[BK][BM + 4];            // activations, transposed
  __shared__ __align__(16) Acc ws[BK][BN];  // weight tile

  const int t = threadIdx.x;
  const int tx = t % (BN / TN), ty = t / (BN / TN);
  const int xr = act_row(), xk = act_k();

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    Acc v[8];
    a.load(k0 + xk, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[xk + i][xr] = v[i];
    w.load(k0, n0, ws);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * (BN / TN);
      if (n < N)
        out[(size_t)m * N + n] = finish<TO>(acc[i][j], n, scale, bias, act);
    }
  }
}

inline dim3 grid_for(int M, int N) {
  return dim3((M + BM - 1) / BM, (N + BN - 1) / BN);
}

}  // namespace gemm
}  // namespace repro
