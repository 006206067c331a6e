// The block body shared by the two flash prefill kernels (flash_prefill.cu,
// flash_prefill_packed.cu): one thread block owns kBQ query rows of one
// query head and walks the key/value tiles of its KV head in ascending
// order with an online softmax, so no score tensor ever reaches device
// memory. The kernels differ only in their mask and tile-skip rule, which
// come in as a `Policy`.
//
// Numerics follow the Pallas kernels (src/repro/kernels/attn/kernel.py):
// S = Q.K^T accumulates in f32 from the storage dtype and is multiplied by
// sm_scale; the softcap applies before the mask; masked scores become
// -1e30; the running (m, l, acc) are f32; l sums the unrounded
// probabilities while P.V takes them rounded to V's dtype; the result
// divides by max(l, 1e-30). A policy with kProbMask also zeroes masked
// probabilities (the packed kernel's explicit probability mask).
//
// Layout: 128 threads; thread (r, c) = (tid / 8, tid % 8) owns query rows
// r + 16 i (i < 4), keys c + 8 j (j < 8) of each tile, and output columns
// c + 8 j (j < kCols: 16 where D <= 128, 32 where D <= 256; the launchers
// pick by D, so a D <= 128 call keeps its 16-column registers). Q and K
// sit transposed in shared memory as f32 with one float of padding per
// row, so the eight threads of a row group read neighbouring banks; P (rounded to V's dtype) reuses K's space
// once the scores are in registers. Row statistics reduce over the eight
// lanes of a group with shuffles. Plain FMA, no tensor cores: the first
// port is the simple one.
#pragma once

#include "common.cuh"

namespace repro {
namespace flash {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBKV = 64;      // keys per tile
constexpr int kThreads = 128;
constexpr int kDMax = 256;    // largest head dim: 32 output columns a thread

// output columns a thread owns at head dim D (the flash_block template)
__host__ __device__ constexpr int cols_for(int D) { return D > 128 ? 32 : 16; }
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF sentinel
constexpr float kLEps = 1e-30f;

// dynamic shared memory of one block (must match _flash_smem_bytes in
// repro_torch/kernels/attn/ops.py)
inline size_t smem_bytes(int D) {
  const size_t kt_rows = D > kBQ ? D : kBQ;  // K^T, later P [kBQ][kBKV+1]
  return sizeof(float) * ((size_t)D * (kBQ + 1) + kt_rows * (kBKV + 1) +
                          (size_t)kBKV * D);
}

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q: row 0 of this block (row i at q + i * q_stride); k, v: key 0 of this
// KV head (key j at k + j * kv_stride); o like q. n_q: rows of this block
// that exist; n_kv: keys that exist.
//
// Policy:
//   first_tile(), last_tile()  tile index range to walk (inclusive)
//   runs(kj0)                  whether tile kj0.. holds a valid key for
//                              some row (block-uniform)
//   valid(i, kj)               whether row i (block-local) sees key kj
//   kProbMask                  zero masked probabilities
template <int kCols, typename T, typename Policy>
__device__ __forceinline__ void flash_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int n_q, long q_stride,
    int n_kv, long kv_stride, int D, float sm_scale, float softcap,
    const Policy& pol) {
  extern __shared__ float smem[];
  float* qt = smem;                                  // [D][kBQ + 1]
  float* kt = qt + D * (kBQ + 1);                    // [D][kBKV + 1]
  float* p_s = kt;                                   // [kBQ][kBKV + 1]
  float* v_s = kt + (D > kBQ ? D : kBQ) * (kBKV + 1);  // [kBKV][D]

  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int i = idx / D, d = idx - i * D;
    qt[d * (kBQ + 1) + i] = i < n_q ? to_f32(q[i * q_stride + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int t_hi = pol.last_tile();
  for (int jt = pol.first_tile(); jt <= t_hi; ++jt) {
    const int kj0 = jt * kBKV;
    if (!pol.runs(kj0)) continue;  // uniform across the block
    const int n_k = min(kBKV, n_kv - kj0);
    __syncthreads();  // the previous tile's P.V is done with p_s and v_s
    for (int idx = tid; idx < kBKV * D; idx += kThreads) {
      const int j = idx / D, d = idx - j * D;
      const bool in = j < n_k;
      kt[d * (kBKV + 1) + j] =
          in ? to_f32(k[(long)(kj0 + j) * kv_stride + d]) : 0.f;
      v_s[j * D + d] = in ? to_f32(v[(long)(kj0 + j) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[d * (kBQ + 1) + r + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kt[d * (kBKV + 1) + c + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 16 * i;
      bool ok[8];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = kj0 + c + 8 * j;
        float x = s[i][j] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ok[j] = kj < n_kv && row < n_q && pol.valid(row, kj);
        x = ok[j] ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group8_max(mx);
      const float m_cur = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_cur);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p = expf(s[i][j] - m_cur);
        if (Policy::kProbMask && !ok[j]) p = 0.f;
        s[i][j] = p;
        ps += p;
      }
      ps = group8_sum(ps);
      l[i] = l[i] * alpha[i] + ps;
      m[i] = m_cur;
    }
    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p_s[(r + 16 * i) * (kBKV + 1) + c + 8 * j] = round_to<T>(s[i][j]);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha[i];
    for (int j = 0; j < n_k; ++j) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(r + 16 * i) * (kBKV + 1) + j];
#pragma unroll
      for (int jd = 0; jd < kCols; ++jd) {
        const int d = c + 8 * jd;
        vv[jd] = d < D ? v_s[j * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < kCols; ++jd)
          acc[i][jd] = fmaf(pv[i], vv[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r + 16 * i;
    if (row >= n_q) continue;
    const float lsum = fmaxf(l[i], kLEps);
#pragma unroll
    for (int jd = 0; jd < kCols; ++jd) {
      const int d = c + 8 * jd;
      if (d < D) o[row * q_stride + d] = from_f32<T>(acc[i][jd] / lsum);
    }
  }
}

// Set the block's dynamic shared memory limit above the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
}  // namespace repro
