// The tensor-core block body of the two flash prefill kernels' bf16
// branch (flash_prefill.cu, flash_prefill_packed.cu; head dim D of 64,
// 128 or 256): one thread block owns kBQ = 64 query rows of one query head and
// walks the key/value tiles of its KV head in ascending order with an
// online softmax, as flash_tile.cuh's FMA body does for every other call.
// The kernels differ only in their mask and tile-skip rule, the same
// `Policy` both bodies take.
//
// Numerics follow the Pallas kernels (src/repro/kernels/attn/kernel.py,
// _online_update): S = Q.K^T is accumulated in f32 from bf16 by wgmma and
// multiplied by sm_scale; the softcap applies before the mask; masked
// scores become -1e30; the running (m, l, acc) are f32; l sums the
// unrounded probabilities while P.V takes them rounded to bf16; the result
// is acc / max(l, 1e-30), taken as one reciprocal a row and products
// (within an f32 ulp of the quotient, before the bf16 rounding). A policy
// with kProbMask also zeroes masked probabilities (the packed kernel's
// explicit probability mask).
//
// Why this shape. At the path's lengths (T, S of 64-2048) the work is
// 4 D flops per visible query-key pair on q, k, v and o read or written
// once: near the card's byte bound, far under the f32 FMA rate the first
// body runs at. Only the tensor cores, fed without the loads in their way,
// get near it.
//
// Design. 160 threads: one consumer warpgroup (warps 0-3, 16 query rows a
// warp) and one producer warp; at D 256, 288 threads: two consumer
// warpgroups, each owning 128 of O's columns (see "D 256" below).
//   - The producer's first thread copies Q once and K, V per tile with TMA
//     through 3-D tensor maps (H * D inner, then T or S, then B), so a box
//     past a row's own T or S reads zeros, never the next batch row's
//     tokens. Tiles are 128-byte swizzled; a D = 128 row is two 64-wide
//     boxes. K and V sit in a ring of kStages = 2 stages with a `full`
//     mbarrier each (K's and V's apart, so Q.K^T starts before V lands) and
//     one `empty` mbarrier, and run kStages tiles ahead of the consumers.
//   - The consumers run S = Q.K^T as D / 16 wgmma.m64n64k16 with both
//     operands K-major in shared memory (K's row-major [kBKV, D] tile is
//     the K-major B), then the softmax in registers on the accumulator
//     fragment: warp w holds rows 16 w + lane / 4 (+ 8), keys 8 j +
//     2 (lane % 4) (+ 1); row max and sum reduce over the 4 lanes of a
//     quad; each element's (row, key) goes through the policy's mask,
//     branch-free on clamped in-range arguments so that the packed
//     policy's segment-id loads issue together. Then
//     O += P.V as kBKV / 16 wgmma.m64n{D}k16 with A from registers (the
//     S accumulator rounded pairwise to bf16 is the A fragment of each k16
//     slice) and V's row-major [kBKV, D] tile as an MN-major B through the
//     descriptor's transpose bit. The stage is released on `empty` (one
//     arrival a warp) once P.V is done.
//   - The epilogue scales by 1 / max(l, 1e-30), rounds to bf16 and stores
//     each row's pairs, masked past n_q.
// Blocks are 64 rows (not 128 on two warpgroups) so that the path's calls
// fill the card: B1 T 512 x 16 heads is 128 blocks on 132 SMs, the T256
// chunk 64, generate's B8 T 64 128, the packed buckets 16 per 64 tokens;
// two blocks fit an SM's shared memory (D 128: 83,000 bytes a block).
//
// D 256 (paligemma's head dim). The tiles still fit, one block an SM: Q,
// two stages of K and V, 164,920 bytes (a third stage would be 230,480 of
// the 232,448). Registers do not: O [64 x 256] in f32 is 128 accumulator
// registers a thread of one warpgroup, beside S's 32 and P's 16. So O's
// columns split over two consumer warpgroups, 128 each (wgmma m64n128 for
// P.V on its half of V's boxes). Both warpgroups compute the whole S =
// Q.K^T and the softmax from the same shared tiles: the same wgmma sums
// in the same order, so their (m, l, P) agree bit for bit and no P crosses
// shared memory. That doubles the Q.K^T work (2 D flops a pair of the
// tile's 4 D): simple and right first; handing P over is later work.
// Each consumer warp arrives on `empty`, so a stage frees once both
// warpgroups' P.V are done.
//
// Invariants (those of flash_tile.cuh): the tiles walked are the policy's,
// in ascending order — the causal kernel's first tile holds key `start`,
// so it needs no probability mask; tiles wholly above the diagonal, left
// of `start`, outside the window or before the block's first segment are
// never read. A tile that holds no key of some row leaves that row's
// (m, l, acc) bit for bit (alpha is exactly 1, its probabilities 0), and
// tiles are aligned to absolute key positions, so a row's keys are summed
// in one order whatever T, S or its place in the block.
//
// What bounds it at the path's shapes (an H100 SXM at 700 W): latency, not
// bytes or the tensor cores. A block runs its tiles one after another on
// one warpgroup, and the softmax on the fragment takes most of a tile; the
// longest walk of the call (8 tiles at T = S = 512) sets its time. Issuing
// the next tile's Q.K^T and this tile's P.V around the softmax (the same
// sums, bit for bit) was tried and was slower.
//
// What the caller guarantees (the launchers' tc_body rule): bf16 q, k, v,
// D of 64, 128 or 256 (16-byte row strides), 16-byte aligned data (the wrappers
// check).
#pragma once

#include "flash_tile.cuh"
#include "hopper.cuh"

namespace repro {
namespace flash_tc {

using namespace sm90;
using flash::kBKV;
using flash::kBQ;
using flash::kLEps;
using flash::kNegInf;

constexpr int kStages = 2;
constexpr int kBarriers = 1 + 3 * kStages;  // q_full; k_full, v_full, empty
static_assert(kBQ == 64 && kBKV == 64,
              "one m64 warpgroup; S = Q.K^T is one m64n64 accumulator");

// consumer warpgroups of a block (each computes all kBQ = 64 rows of S and
// owns D / groups of O's columns), their threads, and the block's threads
// (+ one producer warp)
template <int D>
__host__ __device__ constexpr int groups() {
  return D > 128 ? 2 : 1;
}
template <int D>
__host__ __device__ constexpr int consumers() {
  return 128 * groups<D>();
}
template <int D>
__host__ __device__ constexpr int threads() {
  return consumers<D>() + 32;
}

// one [rows x D] bf16 tile: D / 64 boxes of rows x 128 bytes
template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

// dynamic shared memory of one block (must match _flash_smem_bytes in
// repro_torch/kernels/attn/ops.py): Q, kStages K and V tiles, the
// barriers, and the slack that aligns the tiles to 1024 bytes
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<D>(kBQ) + 2 * kStages * tile_bytes<D>(kBKV) +
         8 * kBarriers + 1024;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The block's walk: each tile index the policy runs, in ascending order,
// with its ordinal n (stage n % kStages, round n / kStages). Producer and
// consumers take the same walk. A tile at or past n_kv holds no key.
template <typename Policy, typename F>
__device__ __forceinline__ void walk(const Policy& pol, int n_kv, F&& f) {
  const int t_hi = pol.last_tile();
  int n = 0;
  for (int jt = pol.first_tile(); jt <= t_hi; ++jt) {
    const int kj0 = jt * kBKV;
    if (kj0 >= n_kv || !pol.runs(kj0)) continue;  // uniform across the block
    f(n++, kj0);
  }
}

// qmap / kmap / vmap: 3-D maps {H * D, T or S, B} of q, k, v (boxes of 64
// values x kBQ or kBKV rows); q_col / kv_col: the head's first column
// (h * D, hk * D); i0: the block's first query row within its T; b: the
// batch row (the maps' outer coordinate); o: the block's row 0 of head h
// (row i at o + i * o_stride); n_q: rows of this block that exist; n_kv:
// keys that exist.
template <int D, typename Policy>
__device__ __forceinline__ void flash_block(
    const CUtensorMap* qmap, const CUtensorMap* kmap, const CUtensorMap* vmap,
    int q_col, int kv_col, int i0, int b, __nv_bfloat16* __restrict__ o,
    long o_stride, int n_q, int n_kv, float sm_scale, float softcap,
    const Policy& pol) {
  static_assert(D == 64 || D == 128 || D == 256,
                "the tensor-core body takes D 64, 128, 256");
  constexpr int kConsumers = consumers<D>();
  constexpr int kN = D / groups<D>();  // O's columns of one warpgroup
  constexpr int kQBytes = tile_bytes<D>(kBQ), kKVBytes = tile_bytes<D>(kBKV);
  extern __shared__ __align__(16) uint8_t flash_tc_smem[];
  // 128-byte swizzle atoms must sit on 1024-byte boundaries
  uint8_t* q_s = flash_tc_smem +
                 ((1024 - (smem_u32(flash_tc_smem) & 1023)) & 1023);
  uint8_t* k_s = q_s + kQBytes;                  // [kStages][D/64][kBKV][64]
  uint8_t* v_s = k_s + kStages * kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  const uint32_t q_full = smem_u32(bars), k_full = smem_u32(bars + 1),
                 v_full = smem_u32(bars + 1 + kStages),
                 empty = smem_u32(bars + 1 + 2 * kStages);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);  // one arrival per warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warp: its first thread issues every copy ----
    if (threadIdx.x == kConsumers) {
      mbar_arrive_tx(q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load(smem_u32(q_s + c * kBQ * kSwizzleRow), qmap, q_full,
                 q_col + 64 * c, i0, b);
      walk(pol, n_kv, [&](int n, int kj0) {
        const int s = n % kStages, round = n / kStages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_arrive_tx(k_full + 8 * s, kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load(smem_u32(k_s + s * kKVBytes + c * kBKV * kSwizzleRow),
                   kmap, k_full + 8 * s, kv_col + 64 * c, kj0, b);
        mbar_arrive_tx(v_full + 8 * s, kKVBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load(smem_u32(v_s + s * kKVBytes + c * kBKV * kSwizzleRow),
                   vmap, v_full + 8 * s, kv_col + 64 * c, kj0, b);
      });
    }
    return;
  }

  // ---- consumer warpgroups: rows r0 and r0 + 8 of each warp's 16 ----
  const int wg = threadIdx.x / 128;  // O's columns wg * kN .. + kN - 1
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, c0 = 2 * (lane % 4);
  float acc[kN / 2];  // O [64 x kN]: columns 8 j + c0 (+ 1) in acc[4 j ..]
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t q_base = smem_u32(q_s);
  mbar_wait(q_full, 0);

  walk(pol, n_kv, [&](int n, int kj0) {
    const int s = n % kStages;
    const uint32_t parity = (n / kStages) & 1;
    const uint32_t k_base = smem_u32(k_s + s * kKVBytes);
    const uint32_t v_base = smem_u32(v_s + s * kKVBytes);

    // S = Q.K^T: k16 slice kk is 32 bytes along each swizzled 128-byte row
    // of box kk / 4; 8-row groups 1024 bytes apart
    float sc[kBKV / 2];
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(
          sc,
          smem_desc(q_base + (kk / 4) * kBQ * kSwizzleRow + (kk % 4) * 32,
                    16, 1024),
          smem_desc(k_base + (kk / 4) * kBKV * kSwizzleRow + (kk % 4) * 32,
                    16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // the online softmax of rows r0 (hf 0) and r0 + 8 (hf 1)
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 8 * hf;
      bool ok[kBKV / 8][2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = kj0 + 8 * j + c0 + e;
          float x = sc[4 * j + 2 * hf + e] * sm_scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          // branch-free, on clamped in-range arguments: the policy's
          // loads (the packed segment ids) issue together, not one by one
          ok[j][e] = (kj < n_kv) & (row < n_q) &
                     pol.valid(min(row, n_q - 1), min(kj, n_kv - 1));
          x = ok[j][e] ? x : kNegInf;
          sc[4 * j + 2 * hf + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_cur = fmaxf(m[hf], quad_max(mx));
      alpha[hf] = expf(m[hf] - m_cur);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = expf(sc[4 * j + 2 * hf + e] - m_cur);
          if (Policy::kProbMask && !ok[j][e]) p = 0.f;
          sc[4 * j + 2 * hf + e] = p;
          ps += p;
        }
      l[hf] = l[hf] * alpha[hf] + quad_sum(ps);
      m[hf] = m_cur;
    }
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    // P rounded to bf16: the accumulator of keys 16 kk .. + 15 is the A
    // fragment of k16 slice kk
    uint32_t pa[kBKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16x2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

    // O += P.V: V's rows are K of this product, 16 rows (2048 bytes) a
    // slice; its column boxes kBKV * 128 bytes apart, this warpgroup's
    // kN / 64 of them from box wg * kN / 64
    mbar_wait(v_full + 8 * s, parity);
    const uint32_t v_cols = v_base + wg * (kN / 64) * kBKV * kSwizzleRow;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      wgmma_rs_m64k16_tb<kN>(
          acc, pa[kk],
          smem_desc(v_cols + kk * 16 * kSwizzleRow, kBKV * kSwizzleRow,
                    1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) fence_frag(pa[kk]);
    mbar_arrive_warp(empty + 8 * s);
  });

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    if (row >= n_q) continue;
    // one division a row, then products (within an ulp of dividing each)
    const float inv = 1.f / fmaxf(l[hf], kLEps);
    __nv_bfloat16* orow = o + row * o_stride + wg * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const __nv_bfloat162 two = __halves2bfloat162(
          __float2bfloat16(acc[4 * j + 2 * hf] * inv),
          __float2bfloat16(acc[4 * j + 2 * hf + 1] * inv));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) = two;
    }
  }
}

// The three tensor maps of a call: q [B, T, Hq, D], k and v [B, S, Hkv, D]
// as {H * D, T or S, B}. S == 0 reads no key tile: q's map stands in for
// k's and v's.
template <int D>
inline bool make_maps(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm,
                      const void* q, const void* k, const void* v, int B,
                      int T_len, int S, int Hq, int Hkv) {
  const cuuint64_t qd[3] = {(cuuint64_t)Hq * D, (cuuint64_t)T_len,
                            (cuuint64_t)B};
  const cuuint64_t qs[2] = {(cuuint64_t)Hq * D, (cuuint64_t)T_len * Hq * D};
  if (!make_map(qm, q, 3, qd, qs, kBQ)) return false;
  if (S == 0) {
    *km = *vm = *qm;
    return true;
  }
  const cuuint64_t kd[3] = {(cuuint64_t)Hkv * D, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t ks[2] = {(cuuint64_t)Hkv * D, (cuuint64_t)S * Hkv * D};
  return make_map(km, k, 3, kd, ks, kBKV) && make_map(vm, v, 3, kd, ks, kBKV);
}

}  // namespace flash_tc
}  // namespace repro
