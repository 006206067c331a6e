// Shared device helpers for the port's hand-written Hopper kernels:
// dtype conversion, the fused epilogue, 8-wide activation loads and the
// in-register DBB block decompression.
//
// Every kernel is bound through a plain C launcher (no PyTorch headers),
// compiled by nvcc into its own shared library and called with ctypes
// (repro_torch/kernels/build.py). A launcher enqueues on the stream it is
// given, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// activation codes: repro_torch.kernels.epilogue.ACT_CODES
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };
// dtype codes: repro_torch.kernels.build.DTYPE_CODES
enum DType { DT_F32 = 0, DT_BF16 = 1 };

// DBB block length the kernels are specialised for (B = 8: one block is
// one 8-wide activation load), and the largest density bound they take.
constexpr int kDbbBlock = 8;
constexpr int kNnzMax = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// an f32 value rounded through T: what `.astype(T)` does before a product
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.f);
    case ACT_GELU: {  // tanh approximation
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case ACT_SILU:
      return y / (1.f + expf(-y));
    default:
      return y;
  }
}

// fixed order: scale -> bias -> act (the store casts afterwards)
__device__ __forceinline__ float epilogue(float acc, int n, const float* scale,
                                          const float* bias, int act) {
  float y = acc;
  if (scale != nullptr) y *= scale[n];
  if (bias != nullptr) y += bias[n];
  return apply_act(y, act);
}

// eight consecutive elements at a 16-byte aligned address, as f32
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Value planes of the DBB kernels. Each loads the nnz stored values of one
// (DBB block kb, output column n) pair as f32 into slot[0 .. nnz-1] and
// zeroes the rest; compressed row r = kb * nnz + s holds slot s. The
// kernels' bodies are templated on the plane, so the three formats share
// one K order and one accumulation.
//
// F32Plane: values[K/8 * nnz, N] f32 (the bits=8 float format).
struct F32Plane {
  const float* v;
  __device__ __forceinline__ void load(int kb, int n, int N, int nnz,
                                       float slot[kNnzMax]) const {
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s)
      slot[s] = s < nnz ? v[((size_t)kb * nnz + s) * N + n] : 0.f;
  }
};

// I8Plane: values[K/8 * nnz, N] int8 (pack_tree(quantize=True)); the
// per-channel scale rides the epilogue. (float)q rounds through T exactly
// for |q| <= 127.
struct I8Plane {
  const int8_t* v;
  __device__ __forceinline__ void load(int kb, int n, int N, int nnz,
                                       float slot[kNnzMax]) const {
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s)
      slot[s] = s < nnz ? (float)v[((size_t)kb * nnz + s) * N + n] : 0.f;
  }
};

// W4Plane: values[K/8 * nnz / 2, N] nibble-packed int8 with the groupwise
// scale gscale[K/G, N] f32. Compressed row r lives in byte row r >> 1, in
// the low nibble when r is even, the high one when odd (an odd nnz starts
// a block mid-byte, so rows are addressed by r, never by kb * nnz / 2).
// G is a multiple of 8, so the block has one scale, row kb * 8 / G. Each
// slot is dequantized with one f32 product (__fmul_rn: no contraction into
// the accumulating FMA), as the reference multiplies the tile in f32
// before casting it; decompress_block then rounds it through T.
struct W4Plane {
  const int8_t* v;
  const float* gscale;
  int group;
  __device__ __forceinline__ void load(int kb, int n, int N, int nnz,
                                       float slot[kNnzMax]) const {
    const float g = gscale[(size_t)(kb * kDbbBlock / group) * N + n];
    int row = -1, byte = 0;
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) {
      float q = 0.f;
      if (s < nnz) {
        const int r = kb * nnz + s;
        if ((r >> 1) != row) {
          row = r >> 1;
          byte = (int)v[(size_t)row * N + n];  // sign-extended
        }
        q = (float)((r & 1) ? (byte >> 4)
                            : ((int)((unsigned)byte << 28) >> 28));
      }
      slot[s] = s < nnz ? __fmul_rn(q, g) : 0.f;
    }
  }
};

// What the w4 plane needs: G a positive multiple of the block dividing K,
// and an even compressed row count (whole bytes).
__host__ __device__ inline bool w4_dims_ok(int K, int nnz, int group) {
  return group > 0 && group % kDbbBlock == 0 && K % group == 0 &&
         (K / kDbbBlock * nnz) % 2 == 0;
}

// Decompress one DBB block of one output column: dense position `pos` is
// kept iff bit `pos` of the mask is set, and its value sits in slot
// rank(pos) = popcount(mask & ((1 << pos) - 1)), clamped to nnz - 1. The
// selected f32 value is rounded through the activation dtype T, as the
// reference casts the decompressed tile before the product. `slot` holds
// the block's nnz stored values (entries >= nnz are never selected).
template <typename T>
__device__ __forceinline__ void decompress_block(uint32_t mask,
                                                 const float slot[kNnzMax],
                                                 int nnz, float w[kDbbBlock]) {
#pragma unroll
  for (int pos = 0; pos < kDbbBlock; ++pos) {
    int rank = __popc(mask & ((1u << pos) - 1u));
    rank = rank < nnz - 1 ? rank : nnz - 1;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) v = (rank == s) ? slot[s] : v;
    w[pos] = ((mask >> pos) & 1u) ? round_to<T>(v) : 0.f;
  }
}

}  // namespace repro
