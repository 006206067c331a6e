// DBB structured-sparse GEMM for skinny M (decode, M <= 32):
// out = act(scale * (x @ W) + bias), W given as the DBB planes values and
// bitmask[K/8, N] (int32). Three value planes: f32 values[K/8 * nnz, N]
// (dbb_gemm_skinny_launch), int8 values whose per-channel scale rides the
// epilogue (dbb_gemm_skinny_i8_launch), and the w4 nibble plane
// values[K/8 * nnz / 2, N] with groupwise scales gscale[K/G, N]
// (dbb_gemm_skinny_w4_launch), all for float x; and int8 x on the int8
// plane (dbb_gemm_skinny_s8_launch: INT8 x INT8 -> INT32, output int32,
// f32 or int8 requantized).
//
// Replaces: src/repro/kernels/skinny/kernel.py, dbb_gemm_skinny_pallas
// (float activations, its bits=8 and bits=4 branches, and its int8
// activations with the int32 accumulator) — every decode and
// speculative-verify projection of the serving path (M = batch, 3·batch).
//
// What bounds it on the H100: bytes, in principle. At M <= 32 the work is
// a few operations per stored byte (the card can do ~295), so the least
// time is the stored weight stream (values + bitmask, + the group scales
// at w4: 2.5 / 1.0 / 0.78 bytes per dense weight for the f32 / int8 / w4
// planes at k = 4) over the 3.35 TB/s memory rate. Measured (PERF.md), the
// float body runs at 2.5-5.8x that bound on the f32 plane and up to 18x
// on the smaller ones: a block's stage takes about the same time on every
// plane, so its fixed work (the decompression of its pairs, the product,
// the issue and the wait), not the plane's bytes, sets its pace.
//
// Two bodies, by x's dtype: float x on the split-K body below (split_body's
// rule, which never reads M; the wrapper's split_body mirrors it), int8 x
// on the int8 split-K body of split_k_s8.cuh.
//
// Float x: the split-K body (kSplit* below; helpers in split_k.cuh). A
// block owns 64 output columns, every row of the batch (so each weight
// tile is read and decompressed once per call) and one of S = splits(K,
// N) slices of K (S <= 8, from K and N alone, so that the grid holds ~2
// blocks per SM: N 2048 runs 256 blocks). It streams its slice in stages
// of 8 DBB blocks (64 K) through a shared-memory ring of 5 stages (f32
// plane) or 8 (the 3-4x smaller int8 / w4 stages), 3-6 stages ahead of
// the one consumed. A stage is three or four TMA boxes that thread 0
// issues against the slot's mbarrier (bitmask [8, 64], values rows, the w4
// group rows, x [M, 64] 128-byte swizzled; out-of-bounds parts read as
// zero),
// or, where a row is no 16-byte multiple (N % 4, int8 N % 16), every
// thread's cp.async copies. Per stage each of the 512 threads takes one
// (DBB block, column) pair from the staged planes:
//   - bf16 x: it expands the pair into 8 bf16 weights by the byte-permute
//     table of tc_gemm.cuh (rounded as the reference casts its tile) and
//     stores them as one 16-byte chunk of a swizzled W^T tile; the next
//     iteration, after the block's barrier, each warp loads a 16-column x
//     k16 A fragment of that tile with ldmatrix and runs
//     mma.sync.m16n8k16 against each 8-row tile of x (out^T = W^T . x^T,
//     f32 accumulators); 16 warps = 4 column groups x the stage's 4 k16
//     steps;
//   - f32 x keeps f32 FMA (no TF32): it decompresses the pair's 8 weights
//     in registers and accumulates all M rows, the activations broadcast
//     from shared memory.
// The block's partial [M, 64] tile is summed in a fixed order in shared
// memory (the four k16 steps; the eight block lanes) and stored to a
// workspace [S, M, N] the wrapper allocates; a second launch adds the S
// slices in slice order, applies the epilogue and stores the output. No
// atomics: a row's K order depends on (K, N, nnz) alone, so its bits are
// the same at any M <= 32 and any place in the batch, and two calls give
// equal bits.
//
// int8 x (the _s8 branch, split_k_s8.cuh, shared with sta_gemm_skinny.cu):
// the same grid, slices and workspace in 128-deep stages of int8 (16 DBB
// blocks); each stage's planes are expanded by byte permutes into a K-major
// int8 W^T tile for s8 mma.sync (int32 sums, exact in any order, so every
// output equals the plain version's). Bound by the plane's stream too
// (1.0 byte a weight at k = 4).
#include "common.cuh"
#include "split_k.cuh"
#include "split_k_s8.cuh"
#include "tc_gemm.cuh"

namespace {

using repro::kDbbBlock;
using repro::kNnzMax;
namespace sk = repro::splitk;

// ---------------------------------------------------------------------------
// The split-K body (float x)
// ---------------------------------------------------------------------------

namespace tc = repro::tc;

constexpr int kSplitCols = 64;                   // output columns per block
constexpr int kStageKb = 8;                      // DBB blocks per stage
constexpr int kStageK = kStageKb * kDbbBlock;    // 64
constexpr int kSplitThreads = kStageKb * kSplitCols;  // one pair a thread
constexpr int kWtBytes = kSplitCols * kStageK * 2;    // a bf16 W^T tile
static_assert(kSplitThreads == 512, "16 warps: 4 column groups x 4 k16");

// The K slices of a call: doubled while the grid holds under 2 blocks per
// SM, up to 8, as long as each slice keeps at least two stages. A rule on
// (K, N) alone.
int splits(int K, int N) {
  const int kb = K / kDbbBlock;
  const int tiles = (N + kSplitCols - 1) / kSplitCols;
  int s = 1;
  while (s < sk::kMaxSplit && tiles * s < 2 * sk::kSMs &&
         kb >= 2 * s * 2 * kStageKb)
    s *= 2;
  return s;
}

// How a values plane is staged and read back. Rows are compressed rows
// (F32 / I8: row kb * nnz + s holds slot s) or, for w4, byte rows (row
// r >> 1 holds compressed row r); a stage starts on a multiple of 8
// blocks, so first(kb0) is exact and a stage holds rows(nnz) rows.
template <typename Plane>
struct Staged;

template <>
struct Staged<repro::F32Plane> {
  static constexpr int kEsz = 4;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr bool kGroups = false;
  __host__ __device__ static int rows(int nnz) { return kStageKb * nnz; }
  __device__ static int first(int kb, int nnz) { return kb * nnz; }
  __host__ __device__ static int total(int K, int nnz) {
    return K / kDbbBlock * nnz;
  }
  __host__ __device__ static const char* base(const repro::F32Plane& p) {
    return reinterpret_cast<const char*>(p.v);
  }
};

template <>
struct Staged<repro::I8Plane> {
  static constexpr int kEsz = 1;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr bool kGroups = false;
  __host__ __device__ static int rows(int nnz) { return kStageKb * nnz; }
  __device__ static int first(int kb, int nnz) { return kb * nnz; }
  __host__ __device__ static int total(int K, int nnz) {
    return K / kDbbBlock * nnz;
  }
  __host__ __device__ static const char* base(const repro::I8Plane& p) {
    return reinterpret_cast<const char*>(p.v);
  }
};

template <>
struct Staged<repro::W4Plane> {
  static constexpr int kEsz = 1;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr bool kGroups = true;
  __host__ __device__ static int rows(int nnz) { return kStageKb * nnz / 2; }
  __device__ static int first(int kb, int nnz) { return kb * nnz / 2; }
  __host__ __device__ static int total(int K, int nnz) {
    return K / kDbbBlock * nnz / 2;
  }
  __host__ __device__ static const char* base(const repro::W4Plane& p) {
    return reinterpret_cast<const char*>(p.v);
  }
};

// The byte layout of the dynamic shared memory: a ring of stages (each:
// bitmask rows, values rows, w4 group scales, x rows: dense, as a TMA box
// lands; the bf16 x rows 128-byte swizzled, 16-byte chunk c of row r at
// c ^ (r % 8), so the fragment loads avoid bank conflicts, on a 1024-byte
// boundary), then (bf16 x) two decompressed W^T tiles, the expansion
// table and the ring's mbarriers. The reduction's partial tile reuses the
// ring.
struct Layout {
  int mask, vals, gs, x, x_row, stage, wt, table, bars, total;
};

template <typename Plane>
__host__ __device__ inline Layout layout(int nnz, int mp, int xsz,
                                         int stages) {
  using St = Staged<Plane>;
  Layout L;
  L.mask = 0;
  L.vals = kStageKb * kSplitCols * 4;
  L.gs = L.vals + (St::rows(nnz) * kSplitCols * St::kEsz + 15) / 16 * 16;
  L.x = (L.gs + (St::kGroups ? kStageKb * kSplitCols * 4 : 0) + 1023) /
        1024 * 1024;
  L.x_row = kStageK * xsz;
  L.stage = (L.x + mp * L.x_row + 1023) / 1024 * 1024;
  L.wt = stages * L.stage;
  const bool mma = xsz == 2;
  L.table = L.wt + (mma ? 2 * kWtBytes : 0);
  L.bars = L.table + (mma ? (int)sizeof(tc::ExpandTable) : 0);
  L.total = L.bars + stages * 8;  // the ring outgrows the [mp, 64] part
  return L;
}

struct SplitArgs {
  const void* x;
  const int32_t* bitmask;
  const float* scale;
  const float* bias;
  float* work;                   // [S, M, N]: each K slice's partial sums
  int M, K, N, nnz, act;
  int slice_kb;                  // DBB blocks per K slice
  int lv_mask, lv_vals;          // log2 of the copy widths (copy_tile)
  int tma;  // 1: the stages come as TMA boxes (every row 16-byte aligned)
  int gs_rows;  // w4: the group rows a stage's 64 K can span (<= 8)
};

// The group rows of the w4 scales that one stage (64 K, starting on a
// multiple of 64) can span with groups of G: 64 / G where G divides 64,
// 1 where 64 divides G, else ceil(64 / G) + 1; at most 8 (G >= 8).
int group_rows(int group) {
  if (64 % group == 0) return 64 / group;
  if (group % 64 == 0) return 1;
  const int r = (64 + group - 1) / group + 1;
  return r < kStageKb ? r : kStageKb;
}

// the TMA boxes of a stage: bitmask [8, 64], values [rows(nnz), 64],
// (w4) group scales [gs_rows, 64] from the stage's first group, x [mp, 64]
struct StageMaps {
  CUtensorMap mask, vals, gs, x;
};

// The nnz stored values of (stage block l = global block kb, column c) as
// f32, the plane's loader's values bit for bit (w4: nibble times the
// block's group scale, from the stage's group row gi); slots past nnz are
// zero.
template <typename Plane>
__device__ __forceinline__ void stage_slots(const char* sb, const Layout& L,
                                            int l, int kb, int c, int nnz,
                                            int vr0, int gi,
                                            float slot[kNnzMax]) {
  using St = Staged<Plane>;
  const char* vs = sb + L.vals;
  float g = 0.f;  // w4: the block's group scale, staged group row gi
  if (St::kGroups)
    g = reinterpret_cast<const float*>(sb + L.gs)[gi * kSplitCols + c];
#pragma unroll
  for (int s = 0; s < kNnzMax; ++s) {
    slot[s] = 0.f;
    if (s < nnz) {
      if constexpr (St::kEsz == 4) {
        slot[s] = reinterpret_cast<const float*>(
            vs)[(l * nnz + s) * kSplitCols + c];
      } else if constexpr (!St::kGroups) {
        slot[s] = (float)reinterpret_cast<const int8_t*>(
            vs)[(l * nnz + s) * kSplitCols + c];
      } else {
        const int R = kb * nnz + s;
        const int byte = (int)reinterpret_cast<const int8_t*>(
            vs)[((R >> 1) - vr0) * kSplitCols + c];
        slot[s] = repro::W4Plane::dequant(byte, R, g);
      }
    }
  }
}

template <typename Plane>
__host__ __device__ inline const float* plane_gscale(const Plane&) {
  return nullptr;
}
__host__ __device__ inline const float* plane_gscale(const repro::W4Plane& p) {
  return p.gscale;
}
template <typename Plane>
__host__ __device__ inline int plane_group(const Plane&) {
  return kDbbBlock;
}
__host__ __device__ inline int plane_group(const repro::W4Plane& p) {
  return p.group;
}

template <typename T, typename Plane, int kStages>
__global__ void __launch_bounds__(
    kSplitThreads, std::is_same<T, __nv_bfloat16>::value ? 2 : 1)
dbb_gemm_skinny_split_kernel(const Plane plane, const SplitArgs a,
                             const __grid_constant__ StageMaps maps) {
  extern __shared__ __align__(16) char smem_raw[];
  // the layout on a 1024-byte boundary (the swizzled x boxes need it)
  char* smem =
      smem_raw + ((1024 - (repro::sm90::smem_u32(smem_raw) & 1023)) & 1023);
  using St = Staged<Plane>;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int xsz = sizeof(T);
  constexpr int kAhead = kStages - 2;  // stages in flight past the current
  const int tid = threadIdx.x;
  const int M = a.M, K = a.K, N = a.N, nnz = a.nnz;
  const int mp = (M + 7) / 8 * 8;
  const Layout L = layout<Plane>(nnz, mp, xsz, kStages);
  const int n0 = blockIdx.x * kSplitCols;
  const int rank = blockIdx.y;  // this block's K slice
  const int kb_total = K / kDbbBlock;
  const int kb_begin = rank * a.slice_kb;
  const int kb_end = min(kb_total, kb_begin + a.slice_kb);
  const int n_stages =
      kb_end > kb_begin ? (kb_end - kb_begin + kStageKb - 1) / kStageKb : 0;
  const int group = plane_group(plane);
  const char* vbase = St::base(plane);
  const char* xg = static_cast<const char*>(a.x);
  tc::ExpandTable& table =
      *reinterpret_cast<tc::ExpandTable*>(smem + L.table);
  if constexpr (kMma) {
    if (tid < 256) tc::build_expand_entry(table, tid, nnz);
  }
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t bars = repro::sm90::smem_u32(smem + L.bars);
  if (a.tma) {
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st)
        repro::sm90::mbar_init(bars + 8 * st, 1);
      repro::sm90::fence_mbar_init();
    }
    __syncthreads();
  }
  // issue the copies of stage `it` (into ring slot it % kStages): its TMA
  // boxes (thread 0; the slot's mbarrier counts their bytes), or every
  // thread's cp.async (one group per call, issued or not)
  auto issue = [&](int it) {
    if (a.tma) {
      if (tid == 0 && it < n_stages) {
        const int kb0 = kb_begin + it * kStageKb;
        const uint32_t sb =
            repro::sm90::smem_u32(smem + (it % kStages) * L.stage);
        const uint32_t bar = bars + 8 * (it % kStages);
        namespace h = repro::sm90;
        h::mbar_arrive_tx(bar, (kStageKb + a.gs_rows) * kSplitCols * 4 +
                                   St::rows(nnz) * kSplitCols * St::kEsz +
                                   mp * L.x_row);
        h::tma_load(sb + L.mask, &maps.mask, bar, n0, kb0);
        h::tma_load(sb + L.vals, &maps.vals, bar, n0, St::first(kb0, nnz));
        if (St::kGroups)
          h::tma_load(sb + L.gs, &maps.gs, bar, n0, kb0 * kDbbBlock / group);
        h::tma_load(sb + L.x, &maps.x, bar, kb0 * kDbbBlock, 0);
      }
      return;
    }
    if (it < n_stages) {
      const int kb0 = kb_begin + it * kStageKb;
      char* sb = smem + (it % kStages) * L.stage;
      sk::copy_tile(sb + L.mask, reinterpret_cast<const char*>(a.bitmask),
                    kb0, kStageKb, kb_end, n0, kSplitCols, N, 4, a.lv_mask);
      const int vr0 = St::first(kb0, nnz);
      // (kb_end * nnz is even for w4: whole byte rows end the slice)
      sk::copy_tile(sb + L.vals, vbase, vr0, St::rows(nnz),
                    St::first(kb_end, nnz), n0, kSplitCols, N, St::kEsz,
                    a.lv_vals);
      if (St::kGroups) {  // the group rows from the stage's first group
        const int g0 = kb0 * kDbbBlock / group;
        sk::copy_tile(sb + L.gs,
                      reinterpret_cast<const char*>(plane_gscale(plane)), g0,
                      a.gs_rows, K / group, n0, kSplitCols, N, 4, a.lv_mask);
      }
      // the M activation rows of these 64 K (16-byte copies: K % 8 == 0)
      constexpr int per_row = kStageK * xsz / 16;
      for (int i = tid; i < mp * per_row; i += kSplitThreads) {
        const int m = i / per_row, cc = i % per_row;
        const int k = kb0 * kDbbBlock + cc * (16 / xsz);
        const bool ok = m < M && k < kb_end * kDbbBlock;
        const int c16 = xsz == 2 ? cc ^ (m & 7) : cc;  // as TMA swizzles
        sk::cp_async16(sb + L.x + m * L.x_row + c16 * 16,
                       xg + ((size_t)(ok ? m : 0) * K + (ok ? k : 0)) * xsz,
                       ok);
      }
    }
    sk::cp_async_commit();
  };

  // this thread's (DBB block, column) pair of every stage
  const int pl = tid / kSplitCols, pc = tid % kSplitCols;
  // mma: warp -> 16-column group cg, the stage's k16 step kq; fragment
  // coordinates g, t
  const int cg = warp % 4, kq = warp / 4, g = lane / 4, t = lane % 4;
  const int ntiles = mp / 8;
  float acc_mma[4][4];
  float acc_fma[32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_mma[i][j] = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) acc_fma[r] = 0.f;

  // ldmatrix row of this lane in a W^T tile: column cg * 16 + (lane % 8)
  // (+ 8 for matrices 1, 3), 16-byte chunk 2 kq (+ 1 for matrices 2, 3)
  const int ar = cg * 16 + (lane % 8) + 8 * ((lane / 8) % 2);
  const int ak = 2 * kq + lane / 16;
  const uint32_t a_off = ar * (kStageK * 2) + ((ak ^ (ar & 7)) << 4);

  for (int s = 0; s < kAhead; ++s) issue(s);
  // iteration it decompresses stage it and (bf16 x) multiplies stage it - 1
  for (int it = 0; it <= n_stages; ++it) {
    if (it < n_stages) {
      if (a.tma)
        repro::sm90::mbar_wait(bars + 8 * (it % kStages),
                               (it / kStages) & 1);
      else
        sk::cp_async_wait<kAhead - 1>();
    }
    __syncthreads();
    issue(it + kAhead);
    if (it < n_stages) {
      const char* sb = smem + (it % kStages) * L.stage;
      const int kb0 = kb_begin + it * kStageKb;
      const uint32_t mask =
          reinterpret_cast<const uint32_t*>(sb + L.mask)[tid];
      float slot[kNnzMax];
      // w4: the block's group row among the stage's, (kb0 + pl) / (G / 8)
      // - kb0 / (G / 8), by shifts where G / 8 is a power of two
      const int gkb = group / kDbbBlock;
      const int gi = !St::kGroups ? 0
                     : (gkb & (gkb - 1)) == 0
                         ? ((kb0 + pl) >> (__ffs(gkb) - 1)) -
                               (kb0 >> (__ffs(gkb) - 1))
                         : (kb0 + pl) / gkb - kb0 / gkb;
      stage_slots<Plane>(sb, L, pl, kb0 + pl, pc, nnz, St::first(kb0, nnz),
                         gi, slot);
      if constexpr (kMma) {
        // the pair's 8 bf16 weights: row pc, chunk pl of W^T (swizzled)
        char* wt = smem + L.wt + (it & 1) * kWtBytes;
        *reinterpret_cast<uint4*>(
            wt + pc * (kStageK * 2) + ((pl ^ (pc & 7)) << 4)) =
            tc::expand_block_bf16(mask, slot, nnz, table);
      } else {
        float w[kDbbBlock];
        repro::decompress_block<T>(mask, slot, nnz, w);
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          if (r >= M) break;
          float xv[kDbbBlock];
          repro::load8(reinterpret_cast<const float*>(sb + L.x + r * L.x_row) +
                           pl * kDbbBlock,
                       xv);
#pragma unroll
          for (int p = 0; p < kDbbBlock; ++p)
            acc_fma[r] = fmaf(xv[p], w[p], acc_fma[r]);
        }
      }
    }
    if constexpr (kMma) {
      if (it > 0) {  // stage it - 1: its W^T tile and its x rows
        const char* sb = smem + ((it - 1) % kStages) * L.stage;
        uint32_t af[4];
        sk::ldmatrix_x4(af, repro::sm90::smem_u32(
                                smem + L.wt + ((it - 1) & 1) * kWtBytes +
                                a_off));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= ntiles) break;
          const int r = nt * 8 + g;  // x row: chunks 2 kq, 2 kq + 1
          const char* xr = sb + L.x + r * L.x_row + 4 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
              xr + (((2 * kq) ^ (r & 7)) << 4));
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
              xr + (((2 * kq + 1) ^ (r & 7)) << 4));
          sk::mma_bf16_16816(acc_mma[nt], af, b0, b1);
        }
      }
    }
  }
  sk::cp_async_wait<0>();
  __syncthreads();

  // the block's partial [mp, 64] tile, summed in a fixed order
  float* part = reinterpret_cast<float*>(smem);
  if constexpr (kMma) {
    for (int j = 0; j < 4; ++j) {  // the k16 steps, in order
      if (kq == j) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= ntiles) break;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = nt * 8 + 2 * t + (i & 1);
            const int c = cg * 16 + g + 8 * (i >> 1);
            float& d = part[r * kSplitCols + c];
            d = j == 0 ? acc_mma[nt][i] : d + acc_mma[nt][i];
          }
        }
      }
      __syncthreads();
    }
  } else {
    for (int j = 0; j < kStageKb; ++j) {  // the block lanes, in order
      if (pl == j) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          if (r >= M) break;
          float& d = part[r * kSplitCols + pc];
          d = j == 0 ? acc_fma[r] : d + acc_fma[r];
        }
      }
      __syncthreads();
    }
  }

  // the slice's partial sums of the block's columns, for split_reduce
  for (int e = tid; e < M * kSplitCols; e += kSplitThreads) {
    const int m = e / kSplitCols, n = n0 + e % kSplitCols;
    if (n < N) a.work[((size_t)rank * M + m) * N + n] = part[e];
  }
}

// out = finish(the S slices' partial sums added in slice order 0 .. S - 1)
template <typename T>
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ work, int S, int M, int N,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, int act,
                    T* __restrict__ out) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = work[i];
  for (int s = 1; s < S; ++s) sum += work[s * mn + i];
  out[i] = repro::finish<T>(sum, (int)(i % N), scale, bias, act);
}

// 5 stages of the f32 plane (~10 KB each at k = 4; 3 in flight past the
// current one), 8 of the int8 and w4 planes' 3-4x smaller ones (6 ahead)
template <typename Plane>
struct RingDepth {
  static constexpr int value = 8;
};
template <>
struct RingDepth<repro::F32Plane> {
  static constexpr int value = 5;
};

template <typename T, typename Plane>
int launch_split(const void* x, const Plane plane, const void* bitmask,
                 const void* scale, const void* bias, void* out, void* work,
                 int M, int K, int N, int nnz, int act, cudaStream_t s) {
  constexpr int kStages = RingDepth<Plane>::value;
  using St = Staged<Plane>;
  const int S = splits(K, N);
  const int kb_total = K / kDbbBlock;
  const int per = (kb_total + S - 1) / S;
  SplitArgs a{x,
              static_cast<const int32_t*>(bitmask),
              static_cast<const float*>(scale),
              static_cast<const float*>(bias),
              static_cast<float*>(work),
              M, K, N, nnz, act,
              (per + kStageKb - 1) / kStageKb * kStageKb,
              sk::copy_lv(N, 4), sk::copy_lv(N, St::kEsz), 0,
              St::kGroups ? group_rows(plane_group(plane)) : 0};
  const int mp = (M + 7) / 8 * 8;
  // TMA boxes where every row is a 16-byte multiple, else cp.async
  StageMaps maps{};
  if (a.lv_mask == 4 && a.lv_vals == 4 && K > 0) {
    const bool bf = sizeof(T) == 2;
    const bool ok =
        sk::make_map_2d(&maps.mask, bitmask, CU_TENSOR_MAP_DATA_TYPE_INT32,
                        4, K / kDbbBlock, N, kStageKb, kSplitCols, false) &&
        sk::make_map_2d(&maps.vals, St::base(plane), St::kType, St::kEsz,
                        St::total(K, nnz), N, St::rows(nnz), kSplitCols,
                        false) &&
        (!St::kGroups ||
         sk::make_map_2d(&maps.gs, plane_gscale(plane),
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                         K / plane_group(plane), N, a.gs_rows, kSplitCols,
                         false)) &&
        sk::make_map_2d(&maps.x, x,
                        bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        sizeof(T), M, K, mp, kStageK, bf);
    if (!ok) return (int)cudaErrorInvalidValue;
    a.tma = 1;
  }
  const Layout L = layout<Plane>(nnz, mp, sizeof(T), kStages);
  const int smem = L.total + 1024;  // + the slack that aligns it
  auto* kernel = dbb_gemm_skinny_split_kernel<T, Plane, kStages>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((N + kSplitCols - 1) / kSplitCols, S), kSplitThreads, smem,
           s>>>(plane, a, maps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t mn = (size_t)M * N;
  split_reduce_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      a.work, S, M, N, a.scale, a.bias, act, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

bool dims_ok(int M, int K, int nnz) {
  return M >= 1 && M <= 32 && nnz >= 1 && nnz <= repro::kNnzMax &&
         K % repro::kDbbBlock == 0;
}

bool split_body(int dtype) {
  return dtype == repro::DT_F32 || dtype == repro::DT_BF16;
}

// float x: out in x's dtype (dtype); work: splits(K, N) * M * N floats
template <typename Plane>
int launch(const void* x, const Plane plane, const void* bitmask,
           const void* scale, const void* bias, void* out, void* work, int M,
           int K, int N, int nnz, int act, int dtype, void* stream) {
  if (!dims_ok(M, K, nnz) || !split_body(dtype) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == repro::DT_BF16
             ? launch_split<__nv_bfloat16>(x, plane, bitmask, scale, bias,
                                           out, work, M, K, N, nnz, act, s)
             : launch_split<float>(x, plane, bitmask, scale, bias, out, work,
                                   M, K, N, nnz, act, s);
}

}  // namespace

// 1 where the launchers run the split-K body for x of this dtype
extern "C" int dbb_gemm_skinny_split_body(int dtype) {
  return split_body(dtype) ? 1 : 0;
}

// the K slices of the split-K body at (K, N): its workspace holds
// splits(K, N) * M * N floats
extern "C" int dbb_gemm_skinny_splits(int K, int N) { return splits(K, N); }

extern "C" int dbb_gemm_skinny_launch(const void* x, const void* values,
                                      const void* bitmask, const void* scale,
                                      const void* bias, void* out, void* work,
                                      int M, int K, int N, int nnz, int act,
                                      int dtype, void* stream) {
  return launch(x, repro::F32Plane{static_cast<const float*>(values)},
                bitmask, scale, bias, out, work, M, K, N, nnz, act, dtype,
                stream);
}

extern "C" int dbb_gemm_skinny_i8_launch(const void* x, const void* values,
                                         const void* bitmask,
                                         const void* scale, const void* bias,
                                         void* out, void* work, int M, int K,
                                         int N, int nnz, int act, int dtype,
                                         void* stream) {
  return launch(x, repro::I8Plane{static_cast<const int8_t*>(values)},
                bitmask, scale, bias, out, work, M, K, N, nnz, act, dtype,
                stream);
}

extern "C" int dbb_gemm_skinny_w4_launch(const void* x, const void* values,
                                         const void* bitmask,
                                         const void* gscale, int group,
                                         const void* scale, const void* bias,
                                         void* out, void* work, int M, int K,
                                         int N, int nnz, int act, int dtype,
                                         void* stream) {
  if (!repro::w4_dims_ok(K, nnz, group)) return (int)cudaErrorInvalidValue;
  return launch(x,
                repro::W4Plane{static_cast<const int8_t*>(values),
                               static_cast<const float*>(gscale), group},
                bitmask, scale, bias, out, work, M, K, N, nnz, act, dtype,
                stream);
}

// int8 x on the int8 values plane (split_k_s8.cuh): out_dtype DT_I32,
// DT_F32 or DT_I8; work: dbb_gemm_skinny_s8_splits(K, N) * M * N int32
extern "C" int dbb_gemm_skinny_s8_launch(const void* x, const void* values,
                                         const void* bitmask, const void* scale,
                                         const void* bias, void* out,
                                         void* work, int M, int K, int N,
                                         int nnz, int act, int out_dtype,
                                         void* stream) {
  if (!dims_ok(M, K, nnz) || work == nullptr)
    return (int)cudaErrorInvalidValue;
  namespace s8 = repro::splitk8;
  const s8::Args a{static_cast<const int8_t*>(x),
                   static_cast<const int8_t*>(values),
                   static_cast<const int32_t*>(bitmask),
                   static_cast<const float*>(scale),
                   static_cast<const float*>(bias),
                   out, static_cast<int*>(work), M, K, N, nnz, act};
  int rc = 0;
  const int e = repro::with_s8_out(out_dtype, [&](auto o) {
    rc = s8::launch<decltype(o), true>(a, static_cast<cudaStream_t>(stream));
  });
  return rc != 0 ? rc : e;
}

// the int8 body's K slices at (K, N): its workspace holds
// dbb_gemm_skinny_s8_splits(K, N) * M * N int32
extern "C" int dbb_gemm_skinny_s8_splits(int K, int N) {
  return repro::splitk8::splits(K, N);
}
