// The tensor-core block body of the port's M-tiled GEMMs on bf16 operands:
// sta_gemm.cu (a dense weight w[K, N]) and dbb_gemm.cu (the DBB planes,
// decompressed into shared memory). out = act(scale * (x @ W) + bias) for
// x[M, K] bf16, accumulated in f32 by wgmma, stored bf16 or f32.
//
// Why this shape. At the prefill shapes (M 512, K and N of 2048-8192) the
// work is hundreds of operations per byte, so only the tensor cores (989
// TFLOP/s bf16) bound it; the plain-FMA body (gemm_tile.cuh) tops out near
// half of the 67 TFLOP/s f32 rate. Each bf16 product is exact in f32, so a
// bf16 wgmma with an f32 accumulator computes what that body computes; only
// the order of the sum differs.
//
// Design. A block owns a BM x BN output tile, BN = 64, and walks K in
// stages of BK = 64. BM = 128 for a dense w (M512 at N2048: 128 blocks for
// 132 SMs); for DBB, 256 where N >= 4096 (each decompressed B tile feeds
// twice the rows) and 128 below (kTallN). In the block:
//   - producers keep a ring of kStages = 4 stages full. The first producer
//     thread copies each stage's A tile (BM x 64 of x) with TMA, 128-byte
//     swizzled, reporting to the stage's `full` mbarrier. B is a second
//     TMA copy of w (DenseB: one producer warpgroup), or (DbbB) 512
//     producer threads decompress the DBB planes into it by bitmask rank,
//     one (DBB block, column) pair a thread, rounding through bf16 as the
//     reference casts its tile. They write it K-major (a column's 64 K
//     values in one swizzled 128-byte row, as the A tiles), so a pair's 8
//     values are one 16-byte store: the dense weight never exists in
//     device memory. A pair's plane words are loaded kPrefetch stages
//     ahead, as stored, and converted only when its stage is written, so
//     the loads' latency overlaps the work of the stages before;
//   - one consumer warpgroup per 64 rows waits on `full`, issues four
//     wgmma.m64n64k16 per stage (A K-major; a TMA'd B MN-major through the
//     descriptor's transpose bit, so w keeps its row-major [K, N] layout),
//     keeps one stage's wgmma in flight and releases the stage before it
//     on its `empty` mbarrier (one arrival per warp);
//   - the epilogue maps the accumulator fragment to (m, n) and applies
//     finish<TO> (scale -> bias -> act, common.cuh) before one masked store.
// No setmaxnreg: a consumer holds 32 accumulators and needs no more
// registers than a producer (58-75 a thread on the card), so there is
// nothing to rebalance.
//
// What bounds it at the M512 prefill shapes (measured on an H100 SXM at
// 700 W): the dense body moves x from L2 once per 64 columns, ~6 TB/s of
// L2 reads at N8192. The DBB body is bound by its producers' per-stage
// work (the plane loads and the decompression), ~1 us a stage.
//
// Edges. TMA zero-fills rows past M and K and columns past N; the DBB
// producer writes zeros past K / 8 blocks and past N; the store is masked.
// K == 0 runs no stage: the epilogue of zero sums.
// Every row sums its K in one order (stage by stage, k16 by k16) whatever
// M or its place in the tile, so a row's bits do not depend on M.
//
// The int8 branches' body (s8 wgmma, int32 accumulators) is the sibling
// header tc_gemm_s8.cuh, on this one's epilogue mapping and store.
//
// What the caller guarantees (the launchers' rule on dtype, K and N): x and
// a TMA'd w have 16-byte row strides (K % 8 == 0, and N % 8 == 0 for w), and
// 16-byte aligned data (the wrappers check). The TMA descriptors are made on
// the host (make_map), and the PTX wrappers come from hopper.cuh.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace repro {
namespace tc {

using namespace sm90;

constexpr int BN = 64, BK = 64, kStages = 4;
constexpr int kBTileBytes = BK * BN * 2;           // 8 KB
constexpr int kBarrierBytes = 2 * kStages * 8;
static_assert(BK * 2 == kSwizzleRow, "an A row of a stage is one swizzle row");
static_assert(BN * 2 == kSwizzleRow && BK * 2 == kSwizzleRow,
              "a B row of a stage, K-major or MN-major, is one swizzle row");
static_assert(BK % kDbbBlock == 0, "a stage holds whole DBB blocks");

// ---------------------------------------------------------------------------
// The B operand's sources
// ---------------------------------------------------------------------------

// a dense row-major w[K, N] bf16, copied by TMA (the kernel's bmap): 128-row
// tiles (two consumer warpgroups of 64 rows), one producer warpgroup whose
// first thread issues the copies
struct DenseB {
  static constexpr int kRows = 128, kProducers = 128;
};

// the DBB planes of W[K, N]: values through the plane's slot loader
// (F32Plane, I8Plane, W4Plane) and bitmask[K/8, N] int32. kRows rows a
// block; kProducers threads decompress a stage's (BK / 8) x BN (block,
// column) pairs, one each (the producers' per-stage time bounds the body,
// and it grows with the pairs a thread has).
template <typename Plane, int kRows_>
struct DbbB {
  static constexpr int kRows = kRows_;
  static constexpr int kProducers = (BK / kDbbBlock) * BN;  // 512
  Plane plane;
  const int32_t* bitmask;
  int nnz;
};

template <typename T>
struct IsDbb : std::false_type {};
template <typename Plane, int kRows>
struct IsDbb<DbbB<Plane, kRows>> : std::true_type {};

// DBB weights with N >= kTallN take 256-row tiles: each decompressed B tile
// then feeds twice the rows (half the decompression, half the blocks),
// and N / 64 column tiles still fill the card at M 512. Below it (the N
// 2048 projections) 128-row tiles keep 128 blocks on the card at M 512.
// A rule on N alone: a row's tile height, and so its bits, never depends
// on M.
constexpr int kTallN = 4096;
constexpr int kPrefetch = 2;  // stages of plane loads in flight ahead

template <typename BSrc>
__host__ __device__ constexpr int tile_m() {
  return BSrc::kRows;
}
template <typename BSrc>
__host__ __device__ constexpr int a_tile_bytes() {
  return tile_m<BSrc>() * BK * 2;
}
template <typename BSrc>
__host__ __device__ constexpr int producer_threads() {
  return BSrc::kProducers;
}
// one consumer warpgroup per 64 rows of the tile
template <typename BSrc>
__host__ __device__ constexpr int consumer_threads() {
  return tile_m<BSrc>() / 64 * 128;
}
template <typename BSrc>
__host__ __device__ constexpr int block_threads() {
  return consumer_threads<BSrc>() + producer_threads<BSrc>();
}

// How the producers fetch one (DBB block kb, column n) pair's stored
// slots a stage ahead (`load`: the words as stored, nothing computed on
// them, so the loads stay in flight) and turn them into the plane's f32
// slot values when the stage is written (`slots`: what the plane's own
// loader in common.cuh computes, bit for bit).
template <typename Plane>
struct PlaneStage;

template <>
struct PlaneStage<F32Plane> {
  struct Raw {
    float v[kNnzMax];
  };
  __device__ static void load(const F32Plane& p, int kb, int n, int N,
                              int nnz, Raw& r) {
    const float* q = p.v + (size_t)kb * nnz * N + n;
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) r.v[s] = s < nnz ? q[(size_t)s * N] : 0.f;
  }
  __device__ static void slots(const Raw& r, int, int, float slot[kNnzMax]) {
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) slot[s] = r.v[s];
  }
};

template <>
struct PlaneStage<I8Plane> {
  struct Raw {
    int q[kNnzMax];  // sign-extended int8
  };
  __device__ static void load(const I8Plane& p, int kb, int n, int N,
                              int nnz, Raw& r) {
    const int8_t* q = p.v + (size_t)kb * nnz * N + n;
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) r.q[s] = s < nnz ? q[(size_t)s * N] : 0;
  }
  __device__ static void slots(const Raw& r, int, int, float slot[kNnzMax]) {
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s) slot[s] = (float)r.q[s];
  }
};

template <>
struct PlaneStage<W4Plane> {
  struct Raw {
    int byte[kNnzMax];  // the byte holding compressed row kb * nnz + s
    float g;            // the block's group scale
  };
  __device__ static void load(const W4Plane& p, int kb, int n, int N,
                              int nnz, Raw& r) {
    r.g = p.gscale[(size_t)(kb * kDbbBlock / p.group) * N + n];
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s)
      r.byte[s] = s < nnz ? (int)p.v[(size_t)((kb * nnz + s) >> 1) * N + n] : 0;
  }
  __device__ static void slots(const Raw& r, int kb, int nnz,
                               float slot[kNnzMax]) {
#pragma unroll
    for (int s = 0; s < kNnzMax; ++s)
      slot[s] = s < nnz ? W4Plane::dequant(r.byte[s], kb * nnz + s, r.g) : 0.f;
  }
};

// One producer thread's (DBB block, column) pair of one DBB stage, in
// registers: block kb0 + t / BN, column n0 + t % BN (consecutive threads
// on consecutive columns: coalesced plane loads).
template <typename Plane>
struct StageSlots {
  uint32_t mask;
  typename PlaneStage<Plane>::Raw raw;
};

// Issue every load of this thread's pair of the stage at block kb0 (a
// block past K / 8 or a column past N reads as an empty block); the words
// are first used kPrefetch stages later, so the loads overlap that work.
template <typename Plane, int kRows>
__device__ __forceinline__ void load_stage(const DbbB<Plane, kRows>& b,
                                           StageSlots<Plane>& r, int t,
                                           int kb0, int n0, int K, int N) {
  const int kb = kb0 + t / BN, n = n0 + t % BN;
  const bool live = kb < K / kDbbBlock && n < N;
  r.mask = live ? static_cast<uint32_t>(b.bitmask[(size_t)kb * N + n]) : 0u;
  PlaneStage<Plane>::load(b.plane, live ? kb : 0, live ? n : 0, N,
                          live ? b.nnz : 0, r.raw);
}

// The byte-permute table of the block expansion for nnz <= 4: for each
// 8-bit mask, output word w of the block (positions 2w, 2w + 1) is
// __byte_perm(u0, u1, sel[w]) & keep[w], with the four rounded slots
// packed in u0 (slots 0, 1) and u1 (slots 2, 3). Built per launch for its
// nnz, so the rank clamp min(rank, nnz - 1) is in the selectors.
struct ExpandTable {
  uint32_t sel[256][2];   // 16-bit selectors of words 0, 1 | 2, 3
  uint32_t keep[256][4];  // 0xFFFF on each kept position's half
};

// dynamic shared memory: the stages, the barriers, the DBB table, and the
// slack that aligns the stages to 1024 bytes
template <typename BSrc>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (a_tile_bytes<BSrc>() + kBTileBytes) + kBarrierBytes +
         (IsDbb<BSrc>::value ? (int)sizeof(ExpandTable) : 0) + 1024;
}

__device__ __forceinline__ void build_expand_entry(ExpandTable& tb, int e,
                                                   int nnz) {
  uint32_t sel[4] = {0, 0, 0, 0}, keep[4] = {0, 0, 0, 0};
  int rank = 0;
#pragma unroll
  for (int p = 0; p < kDbbBlock; ++p) {
    const int r = rank < nnz - 1 ? rank : nnz - 1;  // < 4
    const uint32_t bit = (e >> p) & 1u;
    // output bytes 2 (p % 2) and 2 (p % 2) + 1 take source bytes 2r, 2r + 1
    sel[p / 2] |= (uint32_t)((2 * r) | ((2 * r + 1) << 4)) << (8 * (p % 2));
    if (bit) keep[p / 2] |= 0xFFFFu << (16 * (p % 2));
    rank += bit;
  }
  tb.sel[e][0] = sel[0] | sel[1] << 16;
  tb.sel[e][1] = sel[2] | sel[3] << 16;
#pragma unroll
  for (int w = 0; w < 4; ++w) tb.keep[e][w] = keep[w];
}

// One DBB block of one column as eight bf16 values packed in a uint4 (its
// K order: position p in half p % 2 of word p / 2). The values are those
// of decompress_block<__nv_bfloat16>: position p is kept iff bit p of the
// mask is set and takes slot min(rank, nnz - 1), rank the set bits below
// p, rounded to bf16 (round to nearest even) as the reference casts its
// tile. The slots are rounded first, two per cvt; nnz <= 4 (the serving
// path's k) expands by the table, a permute and a mask per word; a larger
// nnz picks each position's slot by a running rank.
__device__ __forceinline__ uint4 expand_block_bf16(uint32_t mask,
                                                   const float slot[kNnzMax],
                                                   int nnz,
                                                   const ExpandTable& tb) {
  const uint32_t u0 = pack_bf16x2(slot[0], slot[1]);
  const uint32_t u1 = pack_bf16x2(slot[2], slot[3]);
  if (nnz <= 4) {
    const int e = mask & 0xFFu;
    const uint2 sel = *reinterpret_cast<const uint2*>(tb.sel[e]);
    const uint4 keep = *reinterpret_cast<const uint4*>(tb.keep[e]);
    return make_uint4(__byte_perm(u0, u1, sel.x) & keep.x,
                      __byte_perm(u0, u1, sel.x >> 16) & keep.y,
                      __byte_perm(u0, u1, sel.y) & keep.z,
                      __byte_perm(u0, u1, sel.y >> 16) & keep.w);
  }
  const uint32_t u[4] = {u0, u1, pack_bf16x2(slot[4], slot[5]),
                         pack_bf16x2(slot[6], slot[7])};
  uint32_t out[kDbbBlock / 2] = {0, 0, 0, 0};
  int rank = 0;
#pragma unroll
  for (int p = 0; p < kDbbBlock; ++p) {
    const int r = rank < nnz - 1 ? rank : nnz - 1;
    const int wi = r >> 1;  // slot r: half r % 2 of word r / 2
    const uint32_t word =
        wi < 2 ? (wi == 0 ? u[0] : u[1]) : (wi == 2 ? u[2] : u[3]);
    const uint32_t bit = (mask >> p) & 1u;
    const uint32_t half = bit ? ((r & 1) ? word >> 16 : word & 0xFFFFu) : 0u;
    out[p / 2] |= half << (16 * (p % 2));
    rank += bit;
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Decompress the pair into the 128-byte-swizzled K-major stage tile
// [BN][BK] at `tile` (the layout of the A tiles: a column's 64 K values
// fill one 128-byte row; the 16-byte chunk index is XORed by the row
// modulo 8): one 16-byte store.
template <typename Plane, int kRows>
__device__ __forceinline__ void write_stage(const DbbB<Plane, kRows>& b,
                                            const StageSlots<Plane>& r,
                                            int kb0, const ExpandTable& tb,
                                            uint8_t* tile, int t) {
  const int kbl = t / BN, col = t % BN;
  float slot[kNnzMax];
  PlaneStage<Plane>::slots(r.raw, kb0 + kbl, b.nnz, slot);
  const uint32_t off = col * kSwizzleRow + kbl * 16;
  *reinterpret_cast<uint4*>(tile + (off ^ ((col & 7) << 4))) =
      expand_block_bf16(r.mask, slot, b.nnz, tb);
}

// two adjacent outputs (n, n + 1) of row m, masked; one paired store when
// the row stride keeps it aligned. Acc: the f32 accumulator, or the int32
// one of the int8 body (tc_gemm_s8.cuh); finish<TO> takes either. scale and
// bias are read at n - c0 (c0 > 0: a copy that starts at column c0).
template <typename TO>
struct alignas(2 * sizeof(TO)) Two {
  TO v[2];
};

template <typename TO, typename Acc>
__device__ __forceinline__ void store_pair(TO* __restrict__ out, int m,
                                           int n, int M, int N, Acc a,
                                           Acc b, const float* scale,
                                           const float* bias, int act,
                                           int c0 = 0) {
  if (m >= M || n >= N) return;
  TO* p = out + (size_t)m * N + n;
  const TO ya = finish<TO>(a, n - c0, scale, bias, act);
  if (n + 1 >= N) {
    p[0] = ya;
    return;
  }
  const TO yb = finish<TO>(b, n + 1 - c0, scale, bias, act);
  if (N % 2 == 0) {
    Two<TO> two;
    two.v[0] = ya;
    two.v[1] = yb;
    *reinterpret_cast<Two<TO>*>(p) = two;
  } else {
    p[0] = ya;
    p[1] = yb;
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename TO, typename BSrc>
__global__ void __launch_bounds__(block_threads<BSrc>(), 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap bmap, const BSrc bsrc,
               const float* __restrict__ scale,
               const float* __restrict__ bias, TO* __restrict__ out, int M,
               int K, int N, int act) {
  constexpr bool kDbb = IsDbb<BSrc>::value;
  constexpr int BM = tile_m<BSrc>(), kATileBytes = a_tile_bytes<BSrc>();
  constexpr int kConsumerThreads = consumer_threads<BSrc>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // 128-byte swizzle atoms must sit on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* a_tiles = smem;
  uint8_t* b_tiles = smem + kStages * kATileBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(b_tiles + kStages * kBTileBytes);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + kStages);

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  // the DBB expansion table (nnz <= 4), one entry per thread
  ExpandTable& table =
      *reinterpret_cast<ExpandTable*>(b_tiles + kStages * kBTileBytes +
                                      kBarrierBytes);
  if constexpr (kDbb) {
    if (bsrc.nnz <= 4 && threadIdx.x < 256)
      build_expand_entry(table, threadIdx.x, bsrc.nnz);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // DBB: thread 0's expect_tx arrival + one per producer warp
      mbar_init(full + 8 * s,
                kDbb ? 1 + producer_threads<BSrc>() / 32 : 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);  // one per warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // ---- producer warpgroup(s) ----
    const int t = threadIdx.x - kConsumerThreads;
    if constexpr (kDbb) {
      // a ring of kPrefetch + 1 stages of plane values in registers: the
      // loads of stage kt + kPrefetch are issued before stage kt is
      // written (the inner loop is unrolled, so every index is static)
      StageSlots<decltype(bsrc.plane)> ring[kPrefetch + 1];
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i)
        if (i < nk)
          load_stage(bsrc, ring[i], t, i * (BK / kDbbBlock), n0, K, N);
      for (int kt0 = 0; kt0 < nk; kt0 += kPrefetch + 1) {
#pragma unroll
        for (int i = 0; i <= kPrefetch; ++i) {
          const int kt = kt0 + i;
          if (kt >= nk) break;
          if (kt + kPrefetch < nk)
            load_stage(bsrc, ring[(i + kPrefetch) % (kPrefetch + 1)], t,
                       (kt + kPrefetch) * (BK / kDbbBlock), n0, K, N);
          const int s = kt % kStages, round = kt / kStages;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          if (t == 0) {
            mbar_arrive_tx(full + 8 * s, kATileBytes);
            tma_load(smem_u32(a_tiles + s * kATileBytes), &amap,
                     full + 8 * s, kt * BK, m0);
          }
          write_stage(bsrc, ring[i], kt * (BK / kDbbBlock), table,
                      b_tiles + s * kBTileBytes, t);
          fence_proxy_async();
          mbar_arrive_warp(full + 8 * s);
        }
      }
    } else if (t == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        mbar_arrive_tx(full + 8 * s, kATileBytes + kBTileBytes);
        tma_load(smem_u32(a_tiles + s * kATileBytes), &amap, full + 8 * s,
                 kt * BK, m0);
        tma_load(smem_u32(b_tiles + s * kBTileBytes), &bmap, full + 8 * s,
                 n0, kt * BK);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows m0 + 64 * wg ... + 63 ----
  const int wg = threadIdx.x / 128;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_acc(acc);
  const uint32_t a_base = smem_u32(a_tiles) + wg * 64 * kSwizzleRow;
  const uint32_t b_base = smem_u32(b_tiles);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A, and B from the DBB producers: K-major, 16 K columns (32 bytes)
      // further along each swizzled row, 8-row groups 1024 bytes apart.
      // B by TMA from w[K, N]: MN-major, 16 K rows (2048 bytes) further
      // down, 8-row groups 1024 bytes apart, one 64-column atom wide.
      const uint64_t da =
          smem_desc(a_base + s * kATileBytes + kk * 32, 16, 1024);
      if constexpr (kDbb) {
        wgmma_m64n64k16<0>(
            acc, da, smem_desc(b_base + s * kBTileBytes + kk * 32, 16, 1024));
      } else {
        wgmma_m64n64k16<1>(
            acc, da,
            smem_desc(b_base + s * kBTileBytes + kk * 16 * kSwizzleRow,
                      kBTileBytes, 1024));
      }
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
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + (lane % 4) * 2;
    store_pair<TO>(out, r0, n, M, N, acc[4 * j], acc[4 * j + 1], scale,
                   bias, act);
    store_pair<TO>(out, r0 + 8, n, M, N, acc[4 * j + 2], acc[4 * j + 3],
                   scale, bias, act);
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch (tensor maps: hopper.cuh)
// ---------------------------------------------------------------------------

template <typename TO, typename BSrc>
int launch(const void* x, const CUtensorMap& bmap, const BSrc& bsrc,
           const void* scale, const void* bias, void* out, int M, int K,
           int N, int act, cudaStream_t s) {
  CUtensorMap amap{};  // K == 0: no stage, nothing to copy
  constexpr int BM = tile_m<BSrc>();
  if (K > 0 && !make_map(&amap, x, M, K, BM))
    return (int)cudaErrorInvalidValue;
  const auto kernel = tc_gemm_kernel<TO, BSrc>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BSrc>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, block_threads<BSrc>(), smem_bytes<BSrc>(), s>>>(
      amap, bmap, bsrc, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, K, N, act);
  return (int)cudaGetLastError();
}

// x[M, K] . w[K, N], both bf16 row-major (K % 8 == 0, N % 8 == 0)
template <typename TO>
int launch_dense(const void* x, const void* w, const void* scale,
                 const void* bias, void* out, int M, int K, int N, int act,
                 cudaStream_t s) {
  CUtensorMap bmap{};
  if (K > 0 && !make_map(&bmap, w, K, N, BK))
    return (int)cudaErrorInvalidValue;
  return launch<TO>(x, bmap, DenseB{}, scale, bias, out, M, K, N, act, s);
}

// x[M, K] bf16 . the DBB planes (K % 8 == 0); no B descriptor is read
template <typename TO, typename Plane>
int launch_dbb(const void* x, const Plane& plane, const void* bitmask,
               int nnz, const void* scale, const void* bias, void* out,
               int M, int K, int N, int act, cudaStream_t s) {
  CUtensorMap unused{};
  const int32_t* bm = static_cast<const int32_t*>(bitmask);
  if (N >= kTallN)
    return launch<TO>(x, unused, DbbB<Plane, 256>{plane, bm, nnz}, scale,
                      bias, out, M, K, N, act, s);
  return launch<TO>(x, unused, DbbB<Plane, 128>{plane, bm, nnz}, scale,
                    bias, out, M, K, N, act, s);
}

}  // namespace tc
}  // namespace repro
