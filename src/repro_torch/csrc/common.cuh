// Shared device helpers for the port's hand-written Hopper kernels:
// dtype conversion, the accumulator of each operand type, the fused
// epilogues (f32 accumulator; the int8 datapath's int32 one), 8-wide
// activation loads and the in-register DBB block decompression.
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
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I32 = 3 };

// DBB block length the kernels are specialised for (B = 8: one block is
// one 8-wide activation load), and the largest density bound they take.
constexpr int kDbbBlock = 8;
constexpr int kNnzMax = 8;

// A block's dynamic shared memory on the H100: the opt-in per-block limit,
// 227 KB (repro_torch.kernels.common.SMEM_LIMIT). The one C spelling of it.
constexpr int kSmemLimit = 232448;

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
// the int8 datapath's values are exact: nothing to round
template <typename T> __device__ __forceinline__ int round_to(int v) {
  return v;
}

// The accumulator of an operand type: f32 for float operands (a bf16
// product is exact in f32), int32 for int8 ones — the paper's INT8 x
// INT8 -> INT32 datapath, exact to the last bit at any K.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };
template <typename T> using acc_t = typename AccOf<T>::type;

// one operand element in its accumulator type
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int to_acc(int8_t v) { return v; }

// acc + a * b: one f32 FMA, or an exact int32 multiply-add
__device__ __forceinline__ float mac(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ int mac(int a, int b, int acc) {
  return acc + a * b;
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

// The int8 datapath's epilogue on an int32 accumulator, as the
// reference's apply_epilogue: with no scale, no bias and act none or relu
// the sum stays exact in int32 (max(acc, 0)); otherwise it runs in f32,
// every step rounded on its own (__fmul_rn / __fadd_rn are never
// contracted into an FMA, so each step is torch's separate op bit for
// bit), in torch's order of the tanh-gelu and of silu = y * sigmoid(y).
__device__ __forceinline__ float act_rn(float y, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(y, 0.f);
    case ACT_GELU: {  // (0.5 y) (1 + tanh(c (y + 0.044715 y^3)))
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      const float y3 = __fmul_rn(__fmul_rn(y, y), y);
      const float t =
          tanhf(__fmul_rn(c, __fadd_rn(y, __fmul_rn(0.044715f, y3))));
      return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, t));
    }
    case ACT_SILU:
      return __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
    default:
      return y;
  }
}

__device__ __forceinline__ bool int_exact(const float* scale,
                                          const float* bias, int act) {
  return scale == nullptr && bias == nullptr &&
         (act == ACT_NONE || act == ACT_RELU);
}

__device__ __forceinline__ float int_epilogue_f32(int acc, int n,
                                                  const float* scale,
                                                  const float* bias,
                                                  int act) {
  float y = __int2float_rn(acc);
  if (scale != nullptr) y = __fmul_rn(y, scale[n]);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  return act_rn(y, act);
}

// the epilogue and the store's cast: int32 (the exact sum, or the f32
// result truncated toward zero, as XLA's astype), f32, or int8 (round
// half to even, clip to +-127)
template <typename TO>
__device__ __forceinline__ TO int_epilogue(int acc, int n, const float* scale,
                                           const float* bias, int act);
template <>
__device__ __forceinline__ int int_epilogue<int>(int acc, int n,
                                                 const float* scale,
                                                 const float* bias, int act) {
  if (int_exact(scale, bias, act)) return act == ACT_RELU ? max(acc, 0) : acc;
  return __float2int_rz(int_epilogue_f32(acc, n, scale, bias, act));
}
template <>
__device__ __forceinline__ float int_epilogue<float>(int acc, int n,
                                                     const float* scale,
                                                     const float* bias,
                                                     int act) {
  return int_epilogue_f32(acc, n, scale, bias, act);
}
template <>
__device__ __forceinline__ int8_t int_epilogue<int8_t>(int acc, int n,
                                                       const float* scale,
                                                       const float* bias,
                                                       int act) {
  const float y =
      int_exact(scale, bias, act)
          ? __int2float_rn(act == ACT_RELU ? max(acc, 0) : acc)
          : int_epilogue_f32(acc, n, scale, bias, act);
  return (int8_t)__float2int_rn(fminf(fmaxf(rintf(y), -127.f), 127.f));
}

// The fused epilogue and cast of the output store, for either
// accumulator: the f32 one (float operands, output T) or the int32 one.
template <typename TO>
__device__ __forceinline__ TO finish(float acc, int n, const float* scale,
                                     const float* bias, int act) {
  return from_f32<TO>(epilogue(acc, n, scale, bias, act));
}
template <typename TO>
__device__ __forceinline__ TO finish(int acc, int n, const float* scale,
                                     const float* bias, int act) {
  return int_epilogue<TO>(acc, n, scale, bias, act);
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

// The int8 branches' output type named by a launcher's out_dtype code:
// calls f(TO{}) with TO = int (DT_I32), float (DT_F32) or int8_t (DT_I8),
// then returns cudaGetLastError(); any other code launches nothing.
template <typename F>
inline int with_s8_out(int out_dtype, F&& f) {
  switch (out_dtype) {
    case DT_I32: f(int{}); break;
    case DT_F32: f(float{}); break;
    case DT_I8: f(int8_t{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// eight consecutive int8 values at an 8-byte aligned address, as int32
__device__ __forceinline__ void load8(const int8_t* p, int out[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = (int)(u.x << (24 - 8 * i)) >> 24;  // sign-extend byte i
    out[4 + i] = (int)(u.y << (24 - 8 * i)) >> 24;
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
// for |q| <= 127. The int slot loader is the int8-activation branch's:
// the exact integers, for the int32 accumulator.
struct I8Plane {
  const int8_t* v;
  __device__ __forceinline__ void load(int kb, int n, int N, int nnz,
                                       float slot[kNnzMax]) const {
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s)
      slot[s] = s < nnz ? (float)v[((size_t)kb * nnz + s) * N + n] : 0.f;
  }
  __device__ __forceinline__ void load(int kb, int n, int N, int nnz,
                                       int slot[kNnzMax]) const {
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s)
      slot[s] = s < nnz ? (int)v[((size_t)kb * nnz + s) * N + n] : 0;
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
  // compressed row r's value from its (sign-extended) byte and the group
  // scale: the nibble, sign-extended, times g in one rounded f32 product
  __device__ __forceinline__ static float dequant(int byte, int r, float g) {
    const int q = (r & 1) ? (byte >> 4) : ((int)((unsigned)byte << 28) >> 28);
    return __fmul_rn((float)q, g);
  }
  __device__ __forceinline__ void load(int kb, int n, int N, int nnz,
                                       float slot[kNnzMax]) const {
    const float g = gscale[(size_t)(kb * kDbbBlock / group) * N + n];
    int row = -1, byte = 0;
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) {
      slot[s] = 0.f;
      if (s < nnz) {
        const int r = kb * nnz + s;
        if ((r >> 1) != row) {
          row = r >> 1;
          byte = (int)v[(size_t)row * N + n];  // sign-extended
        }
        slot[s] = dequant(byte, r, g);
      }
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
// reference casts the decompressed tile before the product (A = int: the
// int8 datapath's exact values). `slot` holds the block's nnz stored
// values (entries >= nnz are never selected).
template <typename T, typename A>
__device__ __forceinline__ void decompress_block(uint32_t mask,
                                                 const A slot[kNnzMax],
                                                 int nnz, A w[kDbbBlock]) {
#pragma unroll
  for (int pos = 0; pos < kDbbBlock; ++pos) {
    int rank = __popc(mask & ((1u << pos) - 1u));
    rank = rank < nnz - 1 ? rank : nnz - 1;
    A v = 0;
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) v = (rank == s) ? slot[s] : v;
    w[pos] = ((mask >> pos) & 1u) ? round_to<T>(v) : A(0);
  }
}

}  // namespace repro
