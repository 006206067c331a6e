// The tensor-core body of conv_gemm_dbb (conv_gemm_dbb.cu) and of
// conv_gemm's dense images (conv_gemm.cu): the paper's STA-DBB convolution
// on Hopper. out[m, n] = act(scale[n] · sum_k patch[m, k] W[k, n] + bias[n])
// for an NHWC image x, M = B·Ho·Wo output pixels, K = kh·kw·C in the
// reference's order (i·kw + j)·C + c, W given as the DBB planes values
// [K/8·nnz, N] and bitmask [K/8, N] and decompressed in shared memory only,
// or (nnz = kDense) as the dense w [K, N] itself. One implicit-GEMM body for
// both of the kernels' branches:
//   - f32 image, f32 values: 3xTF32 on tf32 wgmma. Each operand is split
//     as a = hi + lo, hi = tf32(a), lo = tf32(a - hi), and the sum takes
//     lo·B_hi + hi·B_lo + hi·B_hi (small terms first): f32-class accuracy
//     (the dropped lo·lo and the two roundings are ~2^-22 of a product),
//     at three tf32 products a k8 step. Single-pass tf32 (10 mantissa bits)
//     would miss the stated f32 tolerances;
//   - int8 image, INT8 values: s8 wgmma, exact int32 sums (the IMAD body's
//     and the plain version's bits in any order), then finish<TO>.
//
// Why this shape. At convnet's conv1 and conv2 (B256: M 65536 / 16384, K
// 576 / 1152, N 128 / 256) the dense work is 9.66 GFLOP a layer, hundreds
// of operations per stored byte: the FMA body (gemm_tile.cuh) that ran them
// reached 41% of the f32 FMA rate and lost to cuDNN. Hopper's sparse
// tensor cores take tf32 only 1:2, which DBB k = 2 of 8 does not
// guarantee, so the body runs the dense product of each decompressed tile.
//
// The A operand: TMA in im2col mode (make_map_im2col, hopper.cuh). A stage
// is 128 bytes of K as two 64-byte pieces, each one box of BM = 128
// consecutive output pixels x 64 bytes of channels (16 f32 or 64 int8) of
// one filter tap (i, j), 64-byte swizzled: the TMA walks the pixels across
// image rows and images itself, reads each at its tap's offset and fills
// positions outside the image (SAME padding) and pixels past M with zeros.
// x's channels are contiguous, so the piece lands K-major, as both wgmma
// types need A. K is a multiple of a piece (16 f32 / 64 int8 values), so
// a stage is two pieces or, at K's end, one; a piece past K is not loaded
// (f32 zeroes its fragment; int8 reads stale bytes against zero weights).
//
// The B operand: a TMA thread stages each stage's bitmask and values boxes
// as stored ("raw"); a worker warpgroup writes the stage's K-major B tile,
// BN = 128 columns x 128 bytes of K (a column's 8 K values of a DBB block
// land contiguously, so no transpose), 128-byte swizzled:
//   - int8: tc_gemm_s8.cuh's DbbS8 expansion (expand_stage) as it is, on
//     each 64-column half (16 DBB blocks a stage);
//   - f32 (expand_f32): 4 DBB blocks a stage, one column a worker; zeros,
//     then each kept position's slot read straight from the staged values
//     box (min(rank, nnz - 1), rounded through the activation dtype f32: as
//     it is), split hi = tf32(w), lo = tf32(w - hi) into two tiles.
// A dense weight (nnz = kDense; conv_gemm's images) has no bitmask box: the
// TMA thread stages w's [32 or 128 K rows][128 columns] box, the rows of a
// DBB values plane of nnz 8 (at nnz 8 the slot order is K order), and the
// workers transpose it to the same K-major tile: f32 (expand_dense_f32)
// four K rows a 16-byte chunk, split hi / lo; int8 tc_gemm_s8.cuh's dense
// transpose (transpose_stage) on each 64-column half. Chosen over an nnz-8
// plane with an all-ones bitmask (the same product with a mask box to stage
// and ranks to walk; PERF.md).
//
// The consumers: two warpgroups of 64 rows. int8: four wgmma.m64n128k32 a
// stage from shared memory (A: 64-byte swizzle, B: 128-byte), one stage in
// flight, the stage before released on its `empty` barrier. f32: the A
// fragment is split in registers (the RS form): a half stage (one piece,
// two k8 steps) loads 8 values a thread from the swizzled piece, splits
// them and issues six wgmma.m64n128k8 (lo·B_hi, hi·B_lo, hi·B_hi per k8).
// A half is one commit group and one fragment set; two sets alternate, one
// group stays in flight, and a stage is released once its second half's
// group has completed. f32 sums run in another order than the FMA body's:
// within the f32 tolerances, not bit-equal. The tf32 rounding is two
// integer operations (tf32_rna, hopper.cuh: cvt.rna.tf32.f32's rounding),
// ~10% faster at conv1 than the cvt (PERF.md).
//
// One persistent block an SM walks output tiles (column-fastest), its ring
// running on across them: the producers fill the next tile's first stages
// while the consumers store a tile. The epilogue stages the tile's scale
// and bias in shared memory and stores 16-byte row pieces (a lane swap
// within each pair of lanes), half the store instructions of pairs.
//
// Stages: as many as fit H100's 227 KB of shared memory (kSmemMax), at most
// kMaxStages: f32 at nnz 2 holds 54 KB a stage (A 16 + B_hi 16 + B_lo 16 +
// raw 6) -> 4; int8 at nnz 2 44 KB (A 16 + B 16 + raw 12) -> 5; dense f32
// 64 KB (raw 16) -> 3, dense int8 48 KB -> 4. Measured:
// 2 and 3 stages are slower, the rest level (PERF.md). A ring of A pieces,
// raw boxes and B tiles each its own depth was slower at every depth.
//
// What bounds it (H100 SXM, 700 W, scripts/torch_conv_probe.py's phase
// split): f32 is tensor-core bound in its MMA alone (3 x 9.66 GFLOP of
// tf32 at ~the 494 TFLOP/s rate), but the producers' expansion and the
// consumers' fragment split share the SM's shared-memory port and issue
// slots with it, and the epilogue's stores run between tiles; int8 is
// bound by its output stores.
//
// Edges. Pixels past M and channels past N arrive as zeros (TMA) and the
// store is masked; DBB blocks past K / 8 read a zero mask (empty blocks).
// K never ends inside a piece (the rule: C a multiple of a piece).
//
// The launchers' rule (conv_gemm_dbb.cu, tc_body) takes the body for f32
// images with C % 16 == 0 and N % 4 == 0 and int8 images with C % 64 == 0
// and N % 16 == 0 (whole pieces; 16-byte rows of x's channels and of the
// planes' N for TMA), kh, kw <= 32 and stride <= 8 (the im2col map's
// corner and traversal-stride ranges), never on B, H or W; the wrappers
// check 16-byte aligned, contiguous data.
#pragma once

#include "gemm_tile.cuh"
#include "tc_gemm_s8.cuh"

namespace repro {
namespace convtc {

using namespace sm90;
using gemm::ConvGeom;

constexpr int BM = 128, BN = 128;
constexpr int kPieceBytes = 64, kPieces = 2;   // a stage: 128 bytes of K
constexpr int kConsumers = 256, kWorkers = 128;
constexpr int kThreads = kConsumers + 32 + kWorkers;  // + the TMA warp
constexpr int kATile = kPieces * BM * kPieceBytes;    // 16 KB
constexpr int kBTile = BN * kSwizzleRow;              // 16 KB
constexpr int kMaxStages = 6;
// the nnz code of a dense weight w [K, N] (no bitmask): staged as the
// values plane of nnz 8, whose slots are the block's K rows in order
constexpr int kDense = 0;
constexpr int kSmemMax = kSmemLimit;                  // 227 KB a block
// beside the stages: alignment slack, the int8 expansion table, two tiles'
// scale and bias columns
constexpr int kFixedBytes = 1024 + 256 * 4 + 2 * 2 * BN * 4;

// a barrier among the consumer warpgroups alone (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// the values rows a DBB block stores: nnz, or its 8 K rows when dense
__host__ __device__ inline int slots(int nnz) {
  return nnz == kDense ? kDbbBlock : nnz;
}

// What a branch puts in a stage.
template <typename T>
struct Stage;

template <>
struct Stage<float> {
  static constexpr int kEsz = 4, BK = 32, kBlocks = BK / kDbbBlock;  // 4
  static constexpr int kBTiles = 2;                                  // hi, lo
  // the bitmask box [4][128] int32 (none when dense), then the values box
  // [4 slots][128] f32
  __host__ __device__ static int mask_bytes(int nnz) {
    return nnz == kDense ? 0 : kBlocks * BN * 4;
  }
  __host__ __device__ static int raw_bytes(int nnz) {
    return mask_bytes(nnz) + kBlocks * BN * 4 * slots(nnz);
  }
};

template <>
struct Stage<int8_t> {
  static constexpr int kEsz = 1, BK = 128, kBlocks = BK / kDbbBlock;  // 16
  static constexpr int kBTiles = 1;
  // a DbbS8 staging buffer (bitmask [16][64] int32, values [16 nnz][64]
  // int8; dense: w's [128][64] box alone) for each 64-column half
  __host__ __device__ static int mask_bytes(int nnz) {
    return nnz == kDense ? 0 : tc8::kMaskBytes;
  }
  __host__ __device__ static int half_bytes(int nnz) {
    return mask_bytes(nnz) + kBlocks * slots(nnz) * 64;
  }
  __host__ __device__ static int raw_bytes(int nnz) {
    return 2 * half_bytes(nnz);
  }
};

template <typename T>
__host__ __device__ inline int stage_bytes(int nnz) {
  return kATile + Stage<T>::kBTiles * kBTile + Stage<T>::raw_bytes(nnz);
}

template <typename T>
inline int stages_for(int nnz) {
  const int n = (kSmemMax - kFixedBytes) / (stage_bytes<T>(nnz) + 3 * 8);
  return n < kMaxStages ? n : kMaxStages;
}

template <typename T>
inline int smem_bytes(int nnz, int stages) {
  return kFixedBytes + stages * (stage_bytes<T>(nnz) + 3 * 8);
}

// ---------------------------------------------------------------------------
// The f32 weight producer: a stage's raw boxes into the B_hi, B_lo tiles
// ---------------------------------------------------------------------------

// Worker u writes column u: for each of the stage's 4 DBB blocks, zeros
// into its two 16-byte chunks of each tile's 128-byte row (chunk c at c ^
// (u % 8): the 8 lanes of a store phase hit 8 distinct chunks), then each
// kept position p's value, slot min(rank(p), nnz - 1) of the staged values
// box (decompress_block's values), split into tf32 hi and lo, as one word
// of each. A block splits its kept values only (nnz of 8 at most): chosen
// over splitting all 8 positions and writing each tile once (PERF.md).
__device__ __forceinline__ void expand_f32(const uint8_t* raw, uint8_t* hi,
                                           uint8_t* lo, int nnz, int u) {
  constexpr int kBlocks = Stage<float>::kBlocks;
  const int32_t* mask = reinterpret_cast<const int32_t*>(raw);
  const float* vals = reinterpret_cast<const float*>(raw + kBlocks * BN * 4);
  const int row = u * kSwizzleRow, sw = u & 7;
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    uint32_t e = (uint32_t)mask[b * BN + u] & 0xFFu;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int off = row + (((2 * b + q) ^ sw) << 4);
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(0, 0, 0, 0);
    }
    for (int rank = 0; e != 0; ++rank, e &= e - 1) {
      const int p = __ffs(e) - 1;
      const int r = rank < nnz - 1 ? rank : nnz - 1;
      const float w = vals[(b * nnz + r) * BN + u];
      const uint32_t h = tf32_rna(w);
      const int off = row + (((2 * b + (p >> 2)) ^ sw) << 4) + 4 * (p & 3);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) =
          tf32_rna(w - __uint_as_float(h));
    }
  }
}

// The dense f32 weight producer: worker u writes column u of the B_hi,
// B_lo tiles from the staged box of w's 32 K rows x 128 columns, four K rows
// (one 16-byte chunk of each tile's row, chunk c at c ^ (u % 8)) at a time.
__device__ __forceinline__ void expand_dense_f32(const uint8_t* raw,
                                                 uint8_t* hi, uint8_t* lo,
                                                 int u) {
  const float* vals = reinterpret_cast<const float*>(raw);
  const int row = u * kSwizzleRow, sw = u & 7;
#pragma unroll
  for (int c = 0; c < Stage<float>::BK / 4; ++c) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = vals[(4 * c + e) * BN + u];
      h[e] = tf32_rna(w);
      l[e] = tf32_rna(w - __uint_as_float(h[e]));
    }
    const int off = row + ((c ^ sw) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// the TMA thread's copies of a stage's weight boxes to its raw buffer: the
// DBB bitmask and values boxes, or a dense w's box (rows of the values
// plane of nnz 8)
template <typename T>
__device__ __forceinline__ void issue_raw(const CUtensorMap* bmap,
                                          const CUtensorMap* cmap,
                                          uint8_t* raw, uint32_t bar, int n0,
                                          int kt, int nnz) {
  constexpr int kBlocks = Stage<T>::kBlocks;
  const bool dense = nnz == kDense;
  const int mask = Stage<T>::mask_bytes(nnz);
  const int vrow = kt * kBlocks * slots(nnz);  // the values box's first row
  mbar_arrive_tx(bar, Stage<T>::raw_bytes(nnz));
  if constexpr (sizeof(T) == 4) {
    if (!dense) tma_load(smem_u32(raw), bmap, bar, n0, kt * kBlocks);
    tma_load(smem_u32(raw + mask), cmap, bar, n0, vrow);
  } else {
    for (int half = 0; half < 2; ++half) {
      uint8_t* r = raw + half * Stage<T>::half_bytes(nnz);
      if (!dense)
        tma_load(smem_u32(r), bmap, bar, n0 + 64 * half, kt * kBlocks);
      tma_load(smem_u32(r + mask), cmap, bar, n0 + 64 * half, vrow);
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 consumer's A fragment
// ---------------------------------------------------------------------------

// The tf32 hi and lo fragments of the two k8 steps of one 64-byte piece
// (16 f32 of K) for this thread's rows of the warpgroup's 64: element (r,
// k) sits at r * 64 + ((k / 4) ^ ((r / 2) % 4)) * 16 + (k % 4) * 4 (the
// 64-byte swizzle); the 32 lanes of a load hit 32 distinct banks. Zeros
// where the piece lies past K.
struct Frag {
  uint32_t hi[2][4], lo[2][4];
};

__device__ __forceinline__ void load_frag(const uint8_t* piece, int row,
                                          int t, bool live, Frag& f) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 8 * (i & 1), chunk = 2 * s + (i >> 1);
      const float a =
          live ? *reinterpret_cast<const float*>(
                     piece + r * kPieceBytes +
                     ((chunk ^ ((r >> 1) & 3)) << 4) + 4 * t)
               : 0.f;
      f.hi[s][i] = tf32_rna(a);
      f.lo[s][i] = tf32_rna(a - __uint_as_float(f.hi[s][i]));
    }
}

__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    sm90::fence_frag(f.hi[s]);
    sm90::fence_frag(f.lo[s]);
  }
}

// one half stage: lo·B_hi, hi·B_lo, hi·B_hi for each of its two k8 steps
// (k8 step kk of the stage: 32 bytes into the B tiles' rows)
__device__ __forceinline__ void mma_half(float (&acc)[64], const Frag& f,
                                         uint32_t b_hi, uint32_t b_lo,
                                         int half) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t kb = (2 * half + s) * 32;
    wgmma_tf32_rs_m64n128k8(acc, f.lo[s], smem_desc(b_hi + kb, 16, 1024));
    wgmma_tf32_rs_m64n128k8(acc, f.hi[s], smem_desc(b_lo + kb, 16, 1024));
    wgmma_tf32_rs_m64n128k8(acc, f.hi[s], smem_desc(b_hi + kb, 16, 1024));
  }
}

// ---------------------------------------------------------------------------
// The epilogue's stores
// ---------------------------------------------------------------------------

template <typename TO>
struct alignas(4 * sizeof(TO)) Four {
  TO v[4];
};

// Four adjacent outputs (n .. n + 3, n % 4 == 0) of row m through finish<TO>,
// one vector store where the row stride keeps it aligned, else masked
// element stores; scale and bias read at n - c0.
template <typename TO, typename Acc>
__device__ __forceinline__ void store_four(TO* __restrict__ out, int m,
                                           int n, int M, int N,
                                           const Acc (&v)[4],
                                           const float* scale,
                                           const float* bias, int act,
                                           int c0) {
  if (m >= M || n >= N) return;
  Four<TO> y;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y.v[i] = finish<TO>(v[i], n + i - c0, scale, bias, act);
  TO* p = out + (size_t)m * N + n;
  if (N % 4 == 0) {
    *reinterpret_cast<Four<TO>*>(p) = y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < N) p[i] = y.v[i];
  }
}

// The accumulator fragment of a warp (rows lane / 4 and + 8 of its 16,
// columns 8 j + 2 (lane % 4) (+ 1) in acc[4 j .. 4 j + 3]) stored as
// 16-byte row pieces: lanes t and t ^ 1 swap a pair, so the even lane holds
// row lane / 4 at columns 8 j + 2 t .. + 3 and the odd one row + 8 at
// 8 j + 2 (t - 1) .. + 3.
template <typename TO, typename Acc>
__device__ __forceinline__ void store_frag(TO* __restrict__ out,
                                           const Acc (&acc)[BN / 2], int r0,
                                           int n0, int M, int N,
                                           const float* scale,
                                           const float* bias, int act) {
  const int lane = threadIdx.x % 32, t = lane % 4, odd = t & 1;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const Acc s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const Acc s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const Acc g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const Acc g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    Acc v[4];
    if (odd) {
      v[0] = g0;
      v[1] = g1;
      v[2] = acc[4 * j + 2];
      v[3] = acc[4 * j + 3];
    } else {
      v[0] = acc[4 * j];
      v[1] = acc[4 * j + 1];
      v[2] = g0;
      v[3] = g1;
    }
    store_four<TO>(out, r0 + 8 * odd, n0 + 8 * j + 2 * (t - odd), M, N, v,
                   scale, bias, act, n0);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Phases (`phase`, a bit set; the launchers pass kAll): kLoad runs the
// producers (TMA, expansion) and the consumers' waits, kMma the consumers'
// fragment loads and wgmma. scripts/torch_conv_probe.py times each alone.
// Diagnoses only (the output is garbage): kNoStore drops the epilogue's
// stores, kNoWait every barrier between the
// producers and the consumers (the producers refill a slot once their own
// previous fill of it is complete; the consumers read whatever it holds):
// the two then run side by side, unsynchronised.
enum Phase {
  kLoad = 1, kMma = 2, kAll = 3, kNoStore = 8, kNoWait = 16
};

// The output tile of tile index `tile`: its first pixel and column. Tiles
// run column-fastest, so the blocks that work at once share their pixels'
// im2col reads in L2.
__device__ __forceinline__ void tile_origin(int tile, int N, int& m0,
                                            int& n0) {
  const int tn = (N + BN - 1) / BN;
  m0 = (tile / tn) * BM;
  n0 = (tile % tn) * BN;
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
conv_tc_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap bmap,
               const __grid_constant__ CUtensorMap cmap, const ConvGeom g,
               int N, int nnz, int stages, const float* __restrict__ scale,
               const float* __restrict__ bias, TO* __restrict__ out, int act,
               int phase) {
  using S = Stage<T>;
  constexpr int BK = S::BK, kPieceK = kPieceBytes / S::kEsz;
  const int M = g.B * g.Ho * g.Wo, K = g.kh * g.kw * g.C;
  const int nk = (K + BK - 1) / BK;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int kStage = stage_bytes<T>(nnz);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // swizzle atoms and TMA boxes on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // stage s: A pieces, then the B tile(s), then the raw boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * kStage);
  const uint32_t full = smem_u32(bars), empty = full + 8 * stages,
                 rawb = empty + 8 * stages;
  uint32_t* table = reinterpret_cast<uint32_t*>(bars + 3 * stages);
  // the scale and bias of a tile's BN columns, staged in shared memory (the
  // epilogue's reads never wait behind its own global stores), for two
  // tiles in turn
  float* ep = reinterpret_cast<float*>(table + 256);
  auto a_tile = [&](int s) { return smem + s * kStage; };
  auto b_tile = [&](int s) { return smem + s * kStage + kATile; };
  auto raw_buf = [&](int s) {
    return smem + s * kStage + kATile + S::kBTiles * kBTile;
  };

  if constexpr (sizeof(T) == 1) {
    if (threadIdx.x < 256 && nnz != kDense)
      table[threadIdx.x] = tc8::expand_selectors(threadIdx.x, nnz);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1 + kWorkers / 32);  // TMA + the worker warps
      mbar_init(empty + 8 * s, kConsumers / 32);   // one per consumer warp
      mbar_init(rawb + 8 * s, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // A persistent block walks tiles blockIdx.x, + gridDim.x, ...; `it`
  // counts its stages across them (ring slot it % stages, round it /
  // stages), so the producers fill the next tile's first stages while the
  // consumers finish a tile and store it.
  const bool load = phase & kLoad, mma = phase & kMma;
  const bool sync = load && !(phase & kNoWait);
  if (threadIdx.x >= kConsumers) {
    if (!load) return;
    const int t = threadIdx.x - kConsumers;
    if (t == 0) {
      // the TMA thread
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, N, m0, n0);
        // the tile's first pixel: image b0, output (oh, ow), its window's
        // top-left corner (h0, w0)
        const int b0 = m0 / (g.Ho * g.Wo), rem = m0 - b0 * g.Ho * g.Wo;
        const int oh = rem / g.Wo, ow = rem - oh * g.Wo;
        const int h0 = oh * g.stride - g.pad_top;
        const int w0 = ow * g.stride - g.pad_left;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % stages, round = it / stages;
          if (round > 0)
            mbar_wait((sync ? empty : full) + 8 * s, (round - 1) & 1);
          const int left = (K - kt * BK) / kPieceK;
          const int pieces = left < kPieces ? left : kPieces;
          mbar_arrive_tx(full + 8 * s, pieces * BM * kPieceBytes);
          for (int q = 0; q < pieces; ++q) {
            const int k = kt * BK + q * kPieceK;
            const int tap = k / g.C, c = k - tap * g.C;
            const int i = tap / g.kw, j = tap - i * g.kw;
            tma_load_im2col(smem_u32(a_tile(s) + q * BM * kPieceBytes),
                            &amap, full + 8 * s, c, w0, h0, b0, (uint16_t)j,
                            (uint16_t)i);
          }
          issue_raw<T>(&bmap, &cmap, raw_buf(s), rawb + 8 * s, n0, kt, nnz);
        }
      }
      // unsynchronised: every copy lands before the block exits
      if (!sync)
        for (int j = it > stages ? it - stages : 0; j < it; ++j)
          mbar_wait(full + 8 * (j % stages), (j / stages) & 1);
    } else if (t >= 32) {
      // the workers: raw boxes -> K-major B tile(s)
      const int u = t - 32;
      const int n_it = ((tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                        (int)gridDim.x) * nk;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % stages;
        mbar_wait(rawb + 8 * s, (it / stages) & 1);
        if constexpr (sizeof(T) == 4) {
          if (nnz == kDense)
            expand_dense_f32(raw_buf(s), b_tile(s), b_tile(s) + kBTile, u);
          else
            expand_f32(raw_buf(s), b_tile(s), b_tile(s) + kBTile, nnz, u);
        } else {
          for (int half = 0; half < 2; ++half) {
            const uint8_t* r = raw_buf(s) + half * S::half_bytes(nnz);
            uint8_t* tile = b_tile(s) + half * 64 * kSwizzleRow;
            if (nnz == kDense)
              tc8::transpose_stage(r, tile, u);
            else if (nnz <= 4)
              tc8::expand_stage<4>(r, tile, table, nnz, u);
            else
              tc8::expand_stage<8>(r, tile, table, nnz, u);
          }
        }
        fence_proxy_async();
        mbar_arrive_warp(full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups: pixels m0 + 64 wg ... + 63 of each tile ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int a_off = wg * 64 * kPieceBytes;  // the warpgroup's rows
  using Acc = acc_t<T>;
  int it = 0, parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
    int m0, n0;
    tile_origin(tile, N, m0, n0);
    // this tile's columns; the buffer's last readers (two tiles back) have
    // all passed the previous tile's consumer_sync
    float* tep = ep + parity * 2 * BN;
    if (threadIdx.x < BN) {
      const int n = n0 + threadIdx.x;
      tep[threadIdx.x] = scale != nullptr && n < N ? scale[n] : 0.f;
      tep[BN + threadIdx.x] = bias != nullptr && n < N ? bias[n] : 0.f;
    }
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
    fence_acc(acc);
    if constexpr (sizeof(T) == 4) {
      const int row = warp * 16 + lane / 4, t4 = lane % 4;
      Frag f[2];
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % stages;
        if (sync) mbar_wait(full + 8 * s, (it / stages) & 1);
        if (!mma) {
          if (sync) mbar_arrive_warp(empty + 8 * s);
          continue;
        }
        const uint32_t b_hi = smem_u32(b_tile(s)), b_lo = b_hi + kBTile;
#pragma unroll
        for (int h = 0; h < kPieces; ++h) {
          // set h was last read by the group two halves back: complete
          load_frag(a_tile(s) + h * BM * kPieceBytes + a_off, row, t4,
                    kt * BK + h * kPieceK < K, f[h]);
          wgmma_fence();
          mma_half(acc, f[h], b_hi, b_lo, h);
          wgmma_commit();
          wgmma_wait<1>();  // the group before this one is done
          fence_frag(f[h ^ 1]);
          // that group was the tile's previous stage's last: release it
          if (h == 0 && kt > 0 && sync)
            mbar_arrive_warp(empty + 8 * ((it - 1) % stages));
        }
      }
    } else {
      const uint32_t a_base = smem_u32(smem) + a_off;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % stages;
        if (sync) mbar_wait(full + 8 * s, (it / stages) & 1);
        if (!mma) {
          if (sync) mbar_arrive_warp(empty + 8 * s);
          continue;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          // A: 32 bytes into a 64-byte piece row (8-row groups 512 bytes
          // apart); B: 32 bytes into a 128-byte row
          const uint32_t a = a_base + s * kStage +
                             (kk / 2) * BM * kPieceBytes + (kk % 2) * 32;
          const uint32_t b = smem_u32(b_tile(s)) + kk * 32;
          wgmma_s8_m64n128k32(acc, smem_desc(a, 16, 512, 2),
                              smem_desc(b, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the stage before this one is read: release it
        if (kt > 0 && sync) mbar_arrive_warp(empty + 8 * ((it - 1) % stages));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // the tile's last stage is read: release it before the stores
    if (mma && sync) mbar_arrive_warp(empty + 8 * ((it - 1) % stages));
    consumer_sync();  // the tile's scale and bias are staged
    if (phase & kNoStore) continue;
    // the warp's rows 16 w + lane / 4 (+ 8) of the warpgroup's 64
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    store_frag<TO>(out, acc, r0, n0, M, N, scale != nullptr ? tep : nullptr,
                   bias != nullptr ? tep + BN : nullptr, act);
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch
// ---------------------------------------------------------------------------

// x [B, H, W, C] (f32 or int8), the DBB planes in x's value type (nnz
// kDense: `values` is the dense w [K, N], `bitmask` unused); out [M, N] in
// TO. One persistent block an SM (at most one a tile). `stages`: the ring's
// depth, or 0 for stages_for (the probe's sweep sets it; at most what
// fits). Returns a cudaError_t code. In an unnamed namespace: each library
// that includes this header (conv_gemm.cu, conv_gemm_dbb.cu) keeps its own
// per-device state below for its own kernels (a static in an inline
// template of external linkage is one object across the process, so the
// second library would skip raising its kernels' shared-memory ceiling).
namespace {

template <typename T, typename TO>
int launch(const void* x, const void* values, const void* bitmask,
           const void* scale, const void* bias, void* out, const ConvGeom& g,
           int N, int nnz, int act, int phase, cudaStream_t s,
           int stages = 0) {
  using S = Stage<T>;
  const int M = g.B * g.Ho * g.Wo, K = g.kh * g.kw * g.C;
  if (M == 0 || N == 0) return (int)cudaSuccess;  // no output
  const bool f32 = sizeof(T) == 4;
  const int bn = f32 ? BN : 64;  // an int8 box is one 64-column half
  CUtensorMap amap{}, bmap{}, cmap{};
  if (!make_map_im2col(&amap, x,
                       f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                       S::kEsz, g.B, g.H, g.W, g.C, g.Ho, g.Wo, g.stride,
                       g.pad_top, g.pad_left, kPieceBytes / S::kEsz, BM) ||
      (nnz != kDense &&
       !make_map_2d(&bmap, bitmask, CU_TENSOR_MAP_DATA_TYPE_INT32, 4,
                    K / kDbbBlock, N, S::kBlocks, bn, false)) ||
      !make_map_2d(&cmap, values,
                   f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                   S::kEsz, K / kDbbBlock * slots(nnz), N,
                   S::kBlocks * slots(nnz), bn, false))
    return (int)cudaErrorInvalidValue;
  const int fit = stages_for<T>(nnz);
  if (stages <= 1 || stages > fit) stages = fit;
  const int smem = smem_bytes<T>(nnz, stages);
  const auto kernel = conv_tc_kernel<T, TO>;
  // per device, on its first call: the kernel's shared-memory ceiling
  // (raised to what any call may ask) and the SM count
  constexpr int kDevices = 64;
  static cudaError_t attr[kDevices];
  static int sms[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kDevices) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    attr[device] = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    err = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  if (attr[device] != cudaSuccess) return (int)attr[device];
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms[device] ? (int)tiles : sms[device];
  kernel<<<grid, kThreads, smem, s>>>(
      amap, bmap, cmap, g, N, nnz, stages, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TO*>(out), act, phase);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace convtc
}  // namespace repro
