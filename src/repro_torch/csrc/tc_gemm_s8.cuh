// The int8 tensor-core body of the port's M-tiled GEMMs: the paper's INT8 x
// INT8 -> INT32 operator on Hopper's integer tensor cores, for the int8
// branches of sta_gemm.cu (a dense w[K, N]) and dbb_gemm.cu (the INT8 DBB
// values plane, decompressed into shared memory). acc = sum_k x[m, k] W[k, n]
// in int32 by wgmma.m64n64k32.s32.s8.s8, then finish<TO> (common.cuh: int32
// raw or truncated, f32 after scale -> bias -> act, or int8 rounded half to
// even and clipped to +-127) and one masked store (tc_gemm.cuh's
// store_pair).
//
// Why this shape. At the M512 prefill shapes the work is 2·M·K·N integer
// operations, hundreds per stored byte: only the INT8 tensor cores (1979
// TOP/s) bound it. The IMAD body (gemm_tile.cuh) that ran these branches
// before sat 5-6x behind torch._int_mm. Integer sums are exact in any
// order, so every output equals the IMAD body's and the plain version's
// bit for bit. No .satfinite: the sum wraps as the IMAD body's does (at
// these K no sum comes near 2^31: 8192·127² ≈ 1.3e8).
//
// The operand layout. wgmma takes 8-bit A and B only K-major (the
// descriptor's transpose bit, which the bf16 body uses for w, exists for
// 16-bit types only). A stage is BK = 128 int8 values deep: one 128-byte
// swizzle row, as the bf16 body's 64-deep stage, so the swizzle, the
// descriptors and the 32-byte step per instruction carry over (four k32
// instructions a stage). Neither B source is K-major in device memory, so
// both go through a staging buffer:
//   - a TMA thread copies each stage's x tile (BM x 128, K-major, 128-byte
//     swizzled) to the stage's `full` barrier, and the stage's B data as
//     stored to its staging buffer (`raw` barrier);
//   - a worker warpgroup waits on `raw`, writes the swizzled K-major int8
//     B tile [64][128] (a column's 128 K values in one 128-byte row) and
//     arrives on `full`:
//       DenseS8 (sta_gemm): w[K, N] row-major is MN-major; its [128 x 64]
//       tile is transposed in 4 x 4 byte blocks (four words in, eight byte
//       permutes, four words out), w keeping its layout in device memory
//       (chosen over producers that load w's rows into registers and
//       transpose there: TMA keeps the loads off the producers' registers
//       and instructions);
//       DbbS8 (dbb_gemm): the INT8 plane's bitmask [16 blocks][64] and
//       values [16 nnz][64] boxes are decompressed by bitmask rank, a
//       column's 8 positions of a block by two byte permutes whose
//       selectors (a 256-entry table built per launch for its nnz) take
//       slot min(rank, nnz - 1) at a kept position and a zero slot byte at
//       a dropped one (nnz 8 has no zero slot: a mask of the kept bytes
//       instead). Exact int8, nothing through float; the dense weight
//       never exists in device memory. A stage holds 16 DBB blocks, twice
//       the bf16 body's 8;
//   - consumers: one warpgroup per 64 rows waits on `full`, issues four
//     wgmma.m64n64k32 a stage, keeps one stage in flight and releases the
//     one before on its `empty` barrier (which the TMA thread waits on
//     before it refills the stage); the epilogue maps the fragment to (m,
//     n) as tc_gemm.cuh's does, reading the block's scale and bias columns
//     from shared memory.
//
// Tiles, by a rule on N alone (never M): 64 columns; 128 rows with 6
// stages in flight below kTallN (M512 at N2048: 128 blocks for 132 SMs),
// 256 rows with 4 from it (a staged B tile feeds twice the rows). Chosen
// on the card over other stage counts, 128-column tiles and DBB producers
// that load the planes into registers (PERF.md).
//
// Edges. TMA zero-fills rows past M and K, columns past N, and DBB blocks
// past K / 8 (a zero mask: an empty block); the store is masked. K == 0
// runs no stage: the epilogue of zero sums. M == 0 or N == 0 launches
// nothing.
//
// What the caller guarantees (the launchers' rules): every TMA'd row is a
// 16-byte multiple (K % 16 == 0 for x, N % 16 == 0 for w and the DBB
// planes), the data 16-byte aligned (the wrappers check).
#pragma once

#include "tc_gemm.cuh"

namespace repro {
namespace tc8 {

using namespace sm90;
using tc::kTallN;
using tc::store_pair;

constexpr int BK = 128, BN = 64;  // BN: the wgmma width (m64n64k32)
constexpr int kBlocks = BK / kDbbBlock;      // DBB blocks a stage: 16
constexpr int kMaskBytes = kBlocks * BN * 4;  // a stage's bitmask box
constexpr int kWorkers = 128;                 // the converting warpgroup
static_assert(BK == kSwizzleRow, "a row of an int8 stage is one swizzle row");

// ---------------------------------------------------------------------------
// The B operand's sources
// ---------------------------------------------------------------------------

// a dense row-major w[K, N] int8: a stage stages its [BK x BN] tile
template <int BM_, int kStages_>
struct DenseS8 {
  static constexpr int kRows = BM_, kStages = kStages_;
  static constexpr bool kTable = false;
  static constexpr int kRawBytes = BK * BN;
};

// the INT8 DBB planes values[K/8 * nnz, N] int8 and bitmask[K/8, N] int32:
// a stage stages a bitmask box [16][64] and a values box [16 nnz][64]
template <int BM_, int kStages_>
struct DbbS8 {
  static constexpr int kRows = BM_, kStages = kStages_;
  static constexpr bool kTable = true;
  static constexpr int kRawBytes = kMaskBytes + kBlocks * kNnzMax * BN;
  int nnz;
};

template <typename BSrc>
__host__ __device__ constexpr int consumer_threads() {
  return BSrc::kRows / 64 * 128;
}
template <typename BSrc>
__host__ __device__ constexpr int block_threads() {
  return consumer_threads<BSrc>() + 32 + kWorkers;  // + TMA warp, workers
}
template <typename BSrc>
__host__ __device__ constexpr int stage_bytes() {
  return (BSrc::kRows + BN) * BK + BSrc::kRawBytes;
}
// dynamic shared memory: the stages (A, B, the staging tiles), the full /
// empty / raw barriers, the DBB expansion table, the block's scale and
// bias columns, and the slack that aligns the stages to 1024 bytes
template <typename BSrc>
__host__ __device__ constexpr int smem_bytes() {
  return BSrc::kStages * (stage_bytes<BSrc>() + 3 * 8) +
         (BSrc::kTable ? 256 * 4 : 0) + 2 * BN * 4 + 1024;
}

// ---------------------------------------------------------------------------
// Byte transposes and the DBB expansion
// ---------------------------------------------------------------------------

// The first-stage selectors of a 4 x 4 byte transpose whose output word i
// holds column (rot + i) % 4, from a word pair whose two rows are swapped
// when h: (row 0 col A, row 1 col A, row 0 col B, row 1 col B) with A, B =
// rot, rot + 1 (sa) or rot + 2, rot + 3 (sb), mod 4.
__device__ __forceinline__ void transpose_selectors(int rot, int h,
                                                    uint32_t& sa,
                                                    uint32_t& sb) {
  const uint32_t r0 = 4 * h, r1 = 4 - 4 * h;
  const uint32_t ca = rot, cb = (rot + 1) & 3, cc = (rot + 2) & 3,
                 cd = (rot + 3) & 3;
  sa = (ca + r0) | (ca + r1) << 4 | (cb + r0) << 8 | (cb + r1) << 12;
  sb = (cc + r0) | (cc + r1) << 4 | (cd + r0) << 8 | (cd + r1) << 12;
}

// Four words (byte c of word r: element (r, c)) transposed by eight
// permutes: o[i] byte r = element (r, (rot + i) % 4), rot and the row swap
// being in the selectors.
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t sa, uint32_t sb,
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, sa), t1 = __byte_perm(w0, w1, sb);
  const uint32_t t2 = __byte_perm(w2, w3, sa), t3 = __byte_perm(w2, w3, sb);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// the K-major B tile's 16-byte chunk c of column n (128-byte swizzle)
__device__ __forceinline__ uint4* tile_chunk(uint8_t* tile, int n, int c) {
  return reinterpret_cast<uint4*>(tile + n * kSwizzleRow +
                                  ((c ^ (n & 7)) << 4));
}

// The selectors of one 8-bit mask for this nnz: nibble p (0 .. 7) of the
// word picks output position p's byte of the slot words (lo: slots 0-3,
// hi: slots 4-7): slot min(rank, nnz - 1) where bit p is set, rank the set
// bits below p; else slot nnz, which holds 0 (nnz 8: any byte, masked off).
__device__ __forceinline__ uint32_t expand_selectors(int e, int nnz) {
  uint32_t sel = 0;
  int rank = 0;
  const int zero = nnz < kNnzMax ? nnz : 0;
#pragma unroll
  for (int p = 0; p < kDbbBlock; ++p) {
    const int bit = (e >> p) & 1;
    const int r = rank < nnz - 1 ? rank : nnz - 1;
    sel |= (uint32_t)(bit ? r : zero) << (4 * p);
    rank += bit;
  }
  return sel;
}

// 0xFF in byte i where bit i of the 4-bit `bits` is set
__device__ __forceinline__ uint32_t byte_keep(uint32_t bits) {
  return ((bits * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// One DBB block of one column as its 8 int8 values (position p in byte p
// % 4 of word p / 4), the values of decompress_block<int8_t>, from its
// 8-bit mask e and its slot bytes (lo: slots 0-3, hi: slots 4-7, zero
// past nnz).
__device__ __forceinline__ uint2 expand_words(uint32_t e, uint32_t lo,
                                              uint32_t hi, int nnz,
                                              const uint32_t* table) {
  const uint32_t sel = table[e];
  uint2 v =
      make_uint2(__byte_perm(lo, hi, sel), __byte_perm(lo, hi, sel >> 16));
  if (nnz == kNnzMax) {  // no zero slot: mask the dropped positions
    v.x &= byte_keep(e & 0xFu);
    v.y &= byte_keep(e >> 4);
  }
  return v;
}

// ---------------------------------------------------------------------------
// The workers: a stage's staging buffer into the K-major B tile
// ---------------------------------------------------------------------------

// Dense: the staging tile [BK][BN] as stored (row k: the BN bytes of
// columns n0 ...). Worker u's task: columns 4g .. 4g + 3 (g = u % 16) x K
// 16c .. 16c + 15 (c = u / 16): sixteen words in, four transposes, four
// 16-byte stores (chunk c of each column). Bank conflicts: a warp reads
// two staging rows 16 apart, which lanes with an odd c read in the order
// r ^ 1 so that the two lie in opposite bank halves; a lane stores its
// columns rotated by rot = (g / 2) % 4, so the 8 lanes of a store phase
// hit 8 distinct chunks. Both permutations live in the transpose's
// selectors: no extra instruction. (Shared with the skinny int8 body,
// split_k_s8.cuh.)
__device__ __forceinline__ void transpose_stage(const uint8_t* raw,
                                                uint8_t* tile, int u) {
  const int g = u % (BN / 4), c = u / (BN / 4);
  const int h = c & 1, rot = (g >> 1) & 3;
  uint32_t sa, sb;
  transpose_selectors(rot, h, sa, sb);
  const uint8_t* src = raw + 16 * c * BN + 4 * g;
  uint32_t w[16];
#pragma unroll
  for (int r = 0; r < 16; ++r)
    w[r] = *reinterpret_cast<const uint32_t*>(src + (r ^ h) * BN);
  uint32_t o[4][4];  // o[q][i]: column (rot + i) % 4, K 16c + 4q .. + 3
#pragma unroll
  for (int q = 0; q < 4; ++q)
    transpose4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3], sa, sb,
               o[q]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *tile_chunk(tile, 4 * g + ((rot + i) & 3), c) =
        make_uint4(o[0][i], o[1][i], o[2][i], o[3][i]);
}

template <int BM, int ST>
__device__ __forceinline__ void convert_stage(const DenseS8<BM, ST>&,
                                              const uint8_t* raw,
                                              uint8_t* tile, const uint32_t*,
                                              int u) {
  transpose_stage(raw, tile, u);
}

// DBB: the staged bitmask [16][64] int32 and values [16 nnz][64] int8.
// Worker u's task: columns 4g .. 4g + 3 (g = u % 16) x DBB blocks 2j, 2j
// + 1 (j = u / 16), whose 16 K bytes are chunk j of each column. A block's
// four masks are one 16-byte load and each slot one word (the four
// columns' bytes); a 4 x 4 byte transpose per 4 slots gives each column
// its slot words (S: 4 slots loaded for nnz <= 4, else 8). Columns are
// stored rotated by rot as above, the masks' low bytes rotated to match.
template <int S>
__device__ __forceinline__ void expand_stage(const uint8_t* raw,
                                             uint8_t* tile,
                                             const uint32_t* table, int nnz,
                                             int u) {
  const int g = u % 16, j = u / 16, rot = (g >> 1) & 3;
  uint32_t sa, sb;
  transpose_selectors(rot, 0, sa, sb);
  uint32_t lo[2][4], hi[2][4] = {}, masks[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kbl = 2 * j + h;
    const int4 m =
        *reinterpret_cast<const int4*>(raw + (kbl * BN + 4 * g) * 4);
    // the four masks' low bytes, rotated: byte i is column (rot + i) % 4's
    const uint32_t m4 = __byte_perm(__byte_perm(m.x, m.y, 0x0040),
                                    __byte_perm(m.z, m.w, 0x0040), 0x5410);
    masks[h] = __funnelshift_r(m4, m4, 8 * rot);
    const uint8_t* v = raw + kMaskBytes + kbl * nnz * BN + 4 * g;
    uint32_t w[S];
#pragma unroll
    for (int s = 0; s < S; ++s)
      w[s] = s < nnz ? *reinterpret_cast<const uint32_t*>(v + s * BN) : 0u;
    transpose4(w[0], w[1], w[2], w[3], sa, sb, lo[h]);
    if constexpr (S > 4) transpose4(w[4], w[5], w[6], w[7], sa, sb, hi[h]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint2 a = expand_words((masks[0] >> (8 * i)) & 0xFFu, lo[0][i],
                                 hi[0][i], nnz, table);
    const uint2 c = expand_words((masks[1] >> (8 * i)) & 0xFFu, lo[1][i],
                                 hi[1][i], nnz, table);
    *tile_chunk(tile, 4 * g + ((rot + i) & 3), j) =
        make_uint4(a.x, a.y, c.x, c.y);
  }
}

template <int BM, int ST>
__device__ __forceinline__ void convert_stage(const DbbS8<BM, ST>& b,
                                              const uint8_t* raw,
                                              uint8_t* tile,
                                              const uint32_t* table, int u) {
  if (b.nnz <= 4)
    expand_stage<4>(raw, tile, table, b.nnz, u);
  else
    expand_stage<8>(raw, tile, table, b.nnz, u);
}

// The TMA thread's copies of a stage's B data into its staging buffer,
// announced to the `raw` barrier: the dense w tile, or the two DBB plane
// boxes (bitmask in bmap, values in cmap).
template <int BM, int ST>
__device__ __forceinline__ void issue_raw(const DenseS8<BM, ST>&,
                                          const CUtensorMap* bmap,
                                          const CUtensorMap*, uint8_t* raw,
                                          uint32_t bar, int n0, int kt) {
  mbar_arrive_tx(bar, DenseS8<BM, ST>::kRawBytes);
  tma_load(smem_u32(raw), bmap, bar, n0, kt * BK);
}
template <int BM, int ST>
__device__ __forceinline__ void issue_raw(const DbbS8<BM, ST>& b,
                                          const CUtensorMap* bmap,
                                          const CUtensorMap* cmap,
                                          uint8_t* raw, uint32_t bar, int n0,
                                          int kt) {
  mbar_arrive_tx(bar, kMaskBytes + kBlocks * b.nnz * BN);
  tma_load(smem_u32(raw), bmap, bar, n0, kt * kBlocks);
  tma_load(smem_u32(raw + kMaskBytes), cmap, bar, n0, kt * kBlocks * b.nnz);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename TO, typename BSrc>
__global__ void __launch_bounds__(block_threads<BSrc>(), 1)
tc_gemm_s8_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const __grid_constant__ CUtensorMap cmap, const BSrc bsrc,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, TO* __restrict__ out,
                  int M, int K, int N, int act) {
  constexpr int BM = BSrc::kRows, kStages = BSrc::kStages;
  constexpr int kA = BM * BK, kB = BN * BK, kRaw = BSrc::kRawBytes;
  constexpr int kConsumerThreads = consumer_threads<BSrc>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // 128-byte swizzle atoms must sit on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_tiles = smem;
  uint8_t* b_tiles = a_tiles + kStages * kA;
  uint8_t* raw_tiles = b_tiles + kStages * kB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(raw_tiles + kStages * kRaw);
  const uint32_t full = smem_u32(bars), empty = full + 8 * kStages,
                 rawb = empty + 8 * kStages;
  uint32_t* table = reinterpret_cast<uint32_t*>(bars + 3 * kStages);
  // the scale and bias of the block's BN columns, staged in shared memory:
  // the epilogue's reads never wait behind its own global stores
  float* ep = reinterpret_cast<float*>(table + (BSrc::kTable ? 256 : 0));

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if constexpr (BSrc::kTable) {
    if (threadIdx.x < 256)
      table[threadIdx.x] = expand_selectors(threadIdx.x, bsrc.nnz);
  }
  if (threadIdx.x < BN) {
    const int n = n0 + threadIdx.x;
    ep[threadIdx.x] = scale != nullptr && n < N ? scale[n] : 0.f;
    ep[BN + threadIdx.x] = bias != nullptr && n < N ? bias[n] : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's expect_tx arrival + one per worker warp
      mbar_init(full + 8 * s, 1 + kWorkers / 32);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);  // one per warp
      mbar_init(rawb + 8 * s, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    const int t = threadIdx.x - kConsumerThreads;
    if (t == 0) {
      // the TMA thread: x's tile to `full`, the B data to `raw`
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_arrive_tx(full + 8 * s, kA);
        tma_load(smem_u32(a_tiles + s * kA), &amap, full + 8 * s, kt * BK,
                 m0);
        issue_raw(bsrc, &bmap, &cmap, raw_tiles + s * kRaw, rawb + 8 * s, n0,
                  kt);
      }
    } else if (t >= 32) {
      // the workers: staging buffer -> K-major B tile
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(rawb + 8 * s, (kt / kStages) & 1);
        convert_stage(bsrc, raw_tiles + s * kRaw, b_tiles + s * kB, table,
                      t - 32);
        fence_proxy_async();
        mbar_arrive_warp(full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows m0 + 64 * wg ... + 63 ----
  const int wg = threadIdx.x / 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  const uint32_t a_base = smem_u32(a_tiles) + wg * 64 * kSwizzleRow;
  const uint32_t b_base = smem_u32(b_tiles);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // A and B both K-major: 32 K bytes further along each swizzled row,
      // 8-row groups 1024 bytes apart
      wgmma_s8_m64n64k32(
          acc, smem_desc(a_base + s * kA + kk * 32, 16, 1024),
          smem_desc(b_base + s * kB + kk * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the stage before this one is read: release it
    if (kt > 0) mbar_arrive_warp(empty + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator fragment: warp w of the group holds rows 16 w + lane / 4
  // (+ 8), columns 8 j + 2 (lane % 4) (+ 1) in acc[4 j .. 4 j + 3]
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const float* sc = scale != nullptr ? ep : nullptr;
  const float* bi = bias != nullptr ? ep + BN : nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + (lane % 4) * 2;
    store_pair<TO>(out, r0, n, M, N, acc[4 * j], acc[4 * j + 1], sc, bi, act,
                   n0);
    store_pair<TO>(out, r0 + 8, n, M, N, acc[4 * j + 2], acc[4 * j + 3], sc,
                   bi, act, n0);
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

// bmap, cmap: the B source's TMA maps (dense: w in bmap; DBB: the bitmask
// in bmap, the values in cmap)
template <typename TO, typename BSrc>
int launch(const void* x, const CUtensorMap& bmap, const CUtensorMap& cmap,
           const BSrc& bsrc, const void* scale, const void* bias, void* out,
           int M, int K, int N, int act, cudaStream_t s) {
  constexpr int BM = BSrc::kRows;
  CUtensorMap amap{};
  if (K > 0 && !make_map_2d(&amap, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M,
                            K, BM, BK, true))
    return (int)cudaErrorInvalidValue;
  const auto kernel = tc_gemm_s8_kernel<TO, BSrc>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BSrc>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, block_threads<BSrc>(), smem_bytes<BSrc>(), s>>>(
      amap, bmap, cmap, bsrc, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, K, N, act);
  return (int)cudaGetLastError();
}

// the tile by N alone: 256 rows and 4 stages from kTallN, else 128 and 6
template <typename TO, template <int, int> class Src, typename... Fields>
int launch_by_n(const void* x, const CUtensorMap& bmap,
                const CUtensorMap& cmap, const void* scale, const void* bias,
                void* out, int M, int K, int N, int act, cudaStream_t s,
                Fields... fields) {
  if (N >= kTallN)
    return launch<TO>(x, bmap, cmap, Src<256, 4>{fields...}, scale, bias, out,
                      M, K, N, act, s);
  return launch<TO>(x, bmap, cmap, Src<128, 6>{fields...}, scale, bias, out,
                    M, K, N, act, s);
}

// x[M, K] . w[K, N], both int8 row-major (K % 16 == 0, N % 16 == 0)
template <typename TO>
int launch_dense(const void* x, const void* w, const void* scale,
                 const void* bias, void* out, int M, int K, int N, int act,
                 cudaStream_t s) {
  if (M == 0 || N == 0) return (int)cudaSuccess;  // no output
  CUtensorMap bmap{}, unused{};
  if (K > 0 && !make_map_2d(&bmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K,
                            N, BK, BN, false))
    return (int)cudaErrorInvalidValue;
  return launch_by_n<TO, DenseS8>(x, bmap, unused, scale, bias, out, M, K, N,
                                  act, s);
}

// x[M, K] int8 . the INT8 DBB planes (K % 16 == 0, N % 16 == 0)
template <typename TO>
int launch_dbb(const void* x, const void* values, const void* bitmask,
               int nnz, const void* scale, const void* bias, void* out,
               int M, int K, int N, int act, cudaStream_t s) {
  if (M == 0 || N == 0) return (int)cudaSuccess;  // no output
  CUtensorMap bmap{}, cmap{};
  if (K > 0 &&
      !(make_map_2d(&bmap, bitmask, CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                    K / kDbbBlock, N, kBlocks, BN, false) &&
        make_map_2d(&cmap, values, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                    K / kDbbBlock * nnz, N, kBlocks * nnz, BN, false)))
    return (int)cudaErrorInvalidValue;
  return launch_by_n<TO, DbbS8>(x, bmap, cmap, scale, bias, out, M, K, N, act,
                                s, nnz);
}

}  // namespace tc8
}  // namespace repro
