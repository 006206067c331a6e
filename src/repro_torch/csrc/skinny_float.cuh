// The persistent float body of the skinny dense GEMMs (M <= 32): the logits
// sum[r, n] = x[r, :] . w[:, n] for x[M, K], w[K, N] of one dtype (f32 or
// bf16), f32 FMA, handed 8 rows at a time to an epilogue policy. Two
// launchers run it: sta_gemm_skinny.cu (its store epilogue: act(scale * sum
// + bias) in x's dtype; the greedy head and the dense decode layers) and
// head_sample_fused.cu (its sampling epilogue: penalties, 1/T, Gumbel noise
// and a running argmax; the sampled head). One body, so the two heads' logits
// are the same bits: temperature-0 sampling picks greedy's token exactly.
//
// What bounds it on the H100: bytes. The head's 412 MB f32 weight is read
// once per step for 2 * M operations per 4-byte weight, below the card's
// operations-per-byte balance, so the least time is the weight stream over
// the 3.35 TB/s memory rate. At M 24-32 the f32 FMAs (no TF32, as the
// reference computes the head in f32) need 60-80% of that time on the 67
// TFLOP/s f32 pipes, so the body spends its issue slots on FMAs and keeps the
// weight stream going while they run.
//
// The K order: output (r, n) is ((0 + s_0) + s_1) + ... + s_15, then the
// epilogue, where strand s_v is one sequential f32 FMA chain over the 8-row
// K groups g = v, v + 16, v + 32, ... in ascending g, rows p = 0..7 inside a
// group. Any tiling that keeps these chains and this sum gives the same
// bits; this one does, at any M <= 32, Q and grid.
//
// Design. A column tile is 64 output columns and every row of the batch, so
// the weight is read from memory once at any M <= 32. A block's 16 warps
// hold the 16 strands. The blocks are persistent (one a SM, at most as many
// as tiles), each walking tiles blockIdx.x, + gridDim.x, and the weight and
// x stream through one ring of shared-memory stages (4 for f32, 6 for bf16)
// that runs on across a block's tiles, so a tile's epilogue overlaps the
// next tile's loads. A stage is one 8-row group of every strand: K rows
// [128 j, 128 j + 128) x 64 columns of w (TMA boxes that thread 0 issues
// against the slot's mbarrier where w's rows are 16-byte multiples, else
// every thread's cp.async copies, 4- or 2-byte where a row needs them) and
// the same K of the batch's x rows (16-byte cp.async copies; rows padded by
// 16 bytes so that the row lanes' loads fall on different banks). A lane
// owns C adjacent columns (f32 4, bf16 8: one 16-byte vector of a weight
// row) and a block of MT rows, one every RL (f32 2, bf16 4 row lanes), so
// each weight value read from shared memory feeds MT FMAs and each x value
// C; the rows sit at a fixed stride, so their loads take immediate offsets
// and the accumulators keep the registers (at MT >= 12 the lane holds 2 of a
// group's 8 weight rows at a time, not 4). Where the tiles would fill at
// most half the SMs (N <= 4224), Q blocks of a thread-block cluster (Q = 2,
// 4 or 8: a rule on K and N) split the strands: block q holds strands [q S,
// q S + S), S = 16 / Q, its warps (strand, row part) walk Q groups of their
// strand a stage, so a stage is still 128 K rows. After a tile's last stage,
// 8 rows at a time, each block leaves its strands' partial sums [S][8][64]
// in shared memory and rank 0 of the cluster adds them in strand order
// (over distributed shared memory), one (row, column) a thread, and hands
// each sum to the epilogue. No atomics, and nothing of the order depends on
// M, Q or the tiling.
//
// The epilogue policy (StoreEpi below, head_sample_fused.cu's SampleEpi):
//   struct Shared;  its static shared memory
//   begin(sh, M)    every thread, before the first stage (the first
//                   stage's barrier orders it before any chunk)
//   chunk(sh, sum, r, col, live, N)
//                   every thread of rank 0 (so whole warps: shuffles
//                   work), once per 8-row chunk of a tile: thread t holds
//                   row r = r0 + t / 64, column col = n0 + t % 64 (a warp:
//                   one row, 32 adjacent columns; live: r < M and col < N)
//   end(sh, M)      every thread, after the block's last tile (after a
//                   cluster barrier: every chunk's writes are visible)
#pragma once

#include "split_k.cuh"

namespace repro {
namespace skinny {

namespace sk = repro::splitk;

constexpr int kSkinnyWarps = 16;           // warps a block: the K strands
constexpr int kCols = 64;                  // output columns per block
constexpr int kStrands = kSkinnyWarps;     // 16: the K order's strands
constexpr int kGroupK = 8;                 // rows of a K group
constexpr int kRoundK = kStrands * kGroupK;  // 128: one group per strand
constexpr int kThreads = kStrands * 32;    // 512
constexpr int kMaxCluster = 8;
static_assert(8 * kCols == kThreads, "an 8-row chunk is one sum a thread");

// C: adjacent columns a lane owns (one 16-byte weight vector), RL: row
// lanes (a warp is kCols / C column lanes x RL row lanes), PC: x elements a
// lane reads per vector load (and weight rows it keeps in registers).
template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int C = 4, RL = 2, PC = 4, kStages = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int C = 8, RL = 4, PC = 2, kStages = 6;
};

// the blocks of a cluster that split the strands: doubled while the
// doubled grid still fits the SMs and each block keeps two stages, up to 8
// (the fewer strands a block splits, the more of its warps have rows)
inline int cluster_q(int K, int N) {
  const int tiles = (N + kCols - 1) / kCols;
  const int rounds = (K / kGroupK + kStrands - 1) / kStrands;
  int q = 1;
  while (q < kMaxCluster && tiles * 2 * q <= sk::kSMs && rounds >= 4 * q)
    q *= 2;
  return q;
}

// the grid's x: one block a SM (one cluster per q SMs), at most one a tile
inline int blocks(int K, int N) {
  const int q = cluster_q(K, N);
  const int tiles = (N + kCols - 1) / kCols;
  return tiles < sk::kSMs / q ? tiles : sk::kSMs / q;
}

// The dynamic shared memory: the ring (per stage a w tile [128][64] and an
// x tile [xr][128], xr = the rows the threads cover, x rows padded by 16
// bytes so that the row lanes' loads fall on different banks), the
// partial sums of one 8-row chunk [S][8][64] f32, the ring's mbarriers.
struct Layout {
  int x, x_row, stage, part, bars, total;
};

__host__ __device__ inline Layout layout(int esz, int xr, int stages, int q) {
  Layout L;
  L.x = kRoundK * kCols * esz;
  L.x_row = kRoundK * esz + 16;
  L.stage = L.x + xr * L.x_row;  // a multiple of 128 bytes (xr % 8 == 0)
  L.part = stages * L.stage;
  L.bars = L.part + (kStrands / q) * 8 * kCols * 4;
  L.total = L.bars + stages * 8;
  return L;
}

struct FloatArgs {
  const void* x;
  const void* w;
  int M, K, N;
  int xr;    // rows of the x tile (zero past M)
  int tma;   // 1: the w tiles come as TMA boxes (rows of 16-byte multiples)
  // log2 of the copy widths: 4 (16 B), 2 (4 B), 1 (2 B); x's rows are
  // 16-byte multiples (K % 8 == 0), but a width read at run time keeps the
  // compiler from hoisting the x copies' addresses out of the stage loop,
  // which spilled the accumulators at 12 rows a thread and cost M24 3%
  int lv_w, lv_x;
};

// sta_gemm_skinny's epilogue: act(scale * sum + bias), stored in T
template <typename T>
struct StoreEpi {
  const float* scale;
  const float* bias;
  T* out;
  int act;
  struct Shared {};
  __device__ __forceinline__ void begin(Shared&, int) const {}
  __device__ __forceinline__ void chunk(Shared&, float sum, int r, int col,
                                        bool live, int N) const {
    if (live) out[(size_t)r * N + col] = finish<T>(sum, col, scale, bias, act);
  }
  __device__ __forceinline__ void end(Shared&, int) const {}
};

// Copy one 16-byte chunk of a row whose first `valid` bytes exist (the
// rest, and the whole chunk where valid <= 0, read as zero): one 16-byte
// cp.async, four 4-byte ones, or eight plain 2-byte loads and stores.
__device__ __forceinline__ void copy16(char* dst, const char* src, int valid,
                                       int lv) {
  if (lv == 4) {
    sk::cp_async16(dst, src, valid >= 16);
  } else if (lv == 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sk::cp_async4(dst + 4 * e, src + 4 * e, 4 * e + 4 <= valid);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      reinterpret_cast<uint16_t*>(dst)[e] =
          2 * e + 2 <= valid ? reinterpret_cast<const uint16_t*>(src)[e] : 0;
  }
}

// n consecutive T values at p (16-byte aligned for n * sizeof(T) == 16) as
// f32
template <int n>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[n]) {
  static_assert(n == 2 || n == 4, "f32 vectors are 8 or 16 bytes");
  if constexpr (n == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}
template <int n>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&v)[n]) {
  static_assert(n == 2 || n == 8, "bf16 vectors are 4 or 16 bytes");
  if constexpr (n == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    load8(p, v);
  }
}

// the cluster's barrier (a block's own where the cluster is one block)
__device__ __forceinline__ void tile_sync(int Q) {
  if (Q == 1)
    __syncthreads();
  else
    sk::cluster_sync();
}

template <typename T, int MT, typename Epi>
__global__ void __launch_bounds__(kThreads, 1)
skinny_float_kernel(const FloatArgs a, const Epi epi,
                    const __grid_constant__ CUtensorMap wmap) {
  using Ln = Lanes<T>;
  constexpr int C = Ln::C, RL = Ln::RL, kStages = Ln::kStages;
  // with 12 or more f32 rows a thread, half the weight rows in registers
  // at a time keep the accumulators within the 128 registers
  constexpr int PC = MT >= 12 ? Ln::PC / 2 : Ln::PC;
  constexpr int CL = kCols / C;  // column lanes
  constexpr int esz = sizeof(T);
  static_assert(CL * RL == 32, "a warp is column lanes x row lanes");
  extern __shared__ __align__(128) char smem[];
  __shared__ typename Epi::Shared es;
  const int M = a.M, K = a.K, N = a.N, xr = a.xr;
  const int Q = gridDim.y, q = blockIdx.y;  // the cluster splits strands
  const int S = kStrands / Q;                // strands of this block
  const int run = 8 * S;  // K rows of this block's strands in one round
  const Layout L = layout(esz, xr, kStages, Q);
  const int G = K / kGroupK;
  const int rounds = (G + kStrands - 1) / kStrands;
  const int n_stages = (rounds + Q - 1) / Q;  // Q rounds a stage
  // the column tiles of this block (of its cluster): blockIdx.x, + gridDim.x
  const int tiles = (N + kCols - 1) / kCols;
  const int my_tiles = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_total = my_tiles * n_stages;  // the ring runs across tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const char* wg = static_cast<const char*>(a.w);
  const char* xg = static_cast<const char*>(a.x);
  const uint32_t bars = sm90::smem_u32(smem + L.bars);
  epi.begin(es, M);
  if (a.tma) {
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st) sm90::mbar_init(bars + 8 * st, 1);
      sm90::fence_mbar_init();
    }
    __syncthreads();
  }

  // Tile row tr of stage t is K row kRoundK (t Q + tr / run) + run q +
  // tr % run: round t Q + tr / run, this block's strands' groups in it.
  // Ring stage u is stage u % n_stages of this block's tile u / n_stages.
  constexpr int xch = kRoundK * esz / 16;  // 16-byte chunks of an x row
  constexpr int wch = kCols * esz / 16;    // 16-byte chunks of a w row
  auto k0_of = [&](int tr) {
    return kRoundK * (tr / run) + run * q + tr % run;
  };
  auto issue = [&](int u) {
    if (u < n_total) {
      const int ti = u / n_stages, t = u - ti * n_stages;
      const int n0 = (blockIdx.x + ti * gridDim.x) * kCols;
      char* sb = smem + (u % kStages) * L.stage;
      const int kt = kRoundK * Q * t;
      if (a.tma) {
        if (tid == 0) {
          const uint32_t bar = bars + 8 * (u % kStages);
          sm90::mbar_arrive_tx(bar, kRoundK * kCols * esz);
          for (int j = 0; j < Q; ++j)
            sm90::tma_load(sm90::smem_u32(sb + j * run * kCols * esz), &wmap,
                           bar, n0, kt + kRoundK * j + run * q);
        }
      } else {
        for (int i = tid; i < kRoundK * wch; i += kThreads) {
          const int tr = i / wch, ch = i % wch;
          const int k = kt + k0_of(tr);
          const int col = n0 + ch * (16 / esz);
          const int valid = k < K ? (N - col) * esz : 0;
          copy16(sb + tr * (kCols * esz) + ch * 16,
                 wg + ((size_t)(k < K ? k : 0) * N + (valid > 0 ? col : 0)) *
                          esz,
                 valid, a.lv_w);
        }
      }
      for (int i = tid; i < xr * xch; i += kThreads) {
        const int r = i / xch, ch = i % xch;
        const int k = kt + k0_of(ch * (16 / esz));
        const bool ok = r < M && k < K;
        copy16(sb + L.x + r * L.x_row + ch * 16,
               xg + ((size_t)(ok ? r : 0) * K + (ok ? k : 0)) * esz,
               ok ? 16 : 0, a.lv_x);
      }
    }
    sk::cp_async_commit();
  };

  // this warp's strand (local sl, global v) and row part; this lane's
  // column and row lanes
  const int sl = warp % S, rp = warp / S;
  const int v = q * S + sl;
  const int cl = lane % CL, rl = lane / CL;
  float* part = reinterpret_cast<float*>(smem + L.part);  // [S][8][kCols]
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();

  for (int u = 0; u < kStages - 1; ++u) issue(u);
  int u = 0;
  for (int ti = 0; ti < my_tiles; ++ti) {
    const int n0 = (blockIdx.x + ti * gridDim.x) * kCols;
    float acc[MT][C];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

    for (int t = 0; t < n_stages; ++t, ++u) {
      sk::cp_async_wait<kStages - 2>();
      if (a.tma) sm90::mbar_wait(bars + 8 * (u % kStages), (u / kStages) & 1);
      __syncthreads();  // stage u landed; every warp left stage u - 1's slot
      issue(u + kStages - 1);
      const char* sb = smem + (u % kStages) * L.stage;
      const T* ws = reinterpret_cast<const T*>(sb);
      for (int j = 0; j < Q; ++j) {
        const int g = kStrands * (t * Q + j) + v;  // ascending in a strand
        if (g >= G) break;
        const int tr0 = j * run + 8 * sl;
#pragma unroll
        for (int p0 = 0; p0 < kGroupK; p0 += PC) {
          float wv[PC][C];
#pragma unroll
          for (int p = 0; p < PC; ++p)
            load_f32<C>(ws + (tr0 + p0 + p) * kCols + cl * C, wv[p]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            // rows past M hold zeros (no branch: the x loads can run
            // ahead); with one row a thread, a warp whose rows are all
            // past M stops
            if (MT == 1 && rp * RL >= M) break;
            const int r = (rp * MT + i) * RL + rl;
            float xv[PC];
            load_f32<PC>(
                reinterpret_cast<const T*>(sb + L.x + r * L.x_row) + tr0 +
                    p0,
                xv);
#pragma unroll
            for (int p = 0; p < PC; ++p)
#pragma unroll
              for (int c = 0; c < C; ++c)
                acc[i][c] = fmaf(xv[p], wv[p][c], acc[i][c]);
          }
        }
      }
    }

    // the tile's outputs, 8 rows at a time: every block leaves its
    // strands' partial sums, then rank 0 adds them in strand order (over
    // distributed shared memory across the cluster), one (row, column) a
    // thread, and hands the sums to the epilogue; the ring meanwhile fills
    // with the next tile
    for (int r0 = 0; r0 < M; r0 += 8) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = (rp * MT + i) * RL + rl;
        if (r >= r0 && r < r0 + 8 && r < M) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            part[(sl * 8 + r - r0) * kCols + cl * C + c] = acc[i][c];
        }
      }
      tile_sync(Q);  // every block's partials of these rows written
      if (q == 0) {
        const int e = tid, c = e % kCols;
        const int r = r0 + e / kCols, col = n0 + c;
        const bool live = r < M && col < N;
        float sum = 0.f;
        if (live) {
          for (int rank = 0; rank < Q; ++rank) {
            const float* pr =
                Q == 1 ? part : cluster.map_shared_rank(part, rank);
            for (int s = 0; s < S; ++s)
              sum += pr[(s * 8 + e / kCols) * kCols + c];
          }
        }
        epi.chunk(es, sum, r, col, live, N);
      }
      tile_sync(Q);  // read before the next rows overwrite; no block leaves
                     // while another reads its partials
    }
  }
  sk::cp_async_wait<0>();
  epi.end(es, M);
}

// log2 of the widest copy of a row of `row_bytes` (from a 16-byte aligned
// base): 16 bytes where the rows are 16-byte multiples, else 4, else 2
inline int row_lv(size_t row_bytes) {
  if (row_bytes % 16 == 0) return 4;
  if (row_bytes % 4 == 0) return 2;
  return 1;
}

template <typename T, int MT, typename Epi>
cudaError_t launch_float_mt(FloatArgs a, const Epi& e, int q,
                            cudaStream_t s) {
  constexpr int esz = sizeof(T);
  // the x tile's rows: every row a thread computes (one a thread: the
  // warps past M stop), in whole 128-byte stages
  a.xr = ((MT == 1 ? a.M : MT * q * Lanes<T>::RL) + 7) / 8 * 8;
  CUtensorMap wmap{};
  a.tma = a.lv_w == 4 &&
          sm90::make_map_2d(&wmap, a.w,
                            esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            esz, a.K, a.N, kRoundK / q, kCols, false);
  const Layout L = layout(esz, a.xr, Lanes<T>::kStages, q);
  // persistent: each block walks column tiles blockIdx.x, + gridDim.x
  return sk::launch(skinny_float_kernel<T, MT, Epi>, blocks(a.K, a.N), q,
                    kThreads, L.total, s, a, e, wmap);
}

// Run the body on x, w (a.lv_w, a.lv_x set; M <= 32, K % 8 == 0) with
// epilogue e: rows a thread keeps, ceil(M / (Q RL)), rounded up to an
// instantiation.
template <typename T, typename Epi>
cudaError_t launch_float(const FloatArgs& a, const Epi& e, cudaStream_t s) {
  const int q = cluster_q(a.K, a.N);
  const int rows = (a.M + q * Lanes<T>::RL - 1) / (q * Lanes<T>::RL);
  if (rows <= 1) return launch_float_mt<T, 1>(a, e, q, s);
  if (rows <= 2) return launch_float_mt<T, 2>(a, e, q, s);
  if (rows <= 4) return launch_float_mt<T, 4>(a, e, q, s);
  if (rows <= 6) return launch_float_mt<T, 6>(a, e, q, s);
  if (rows <= 8) return launch_float_mt<T, 8>(a, e, q, s);
  if constexpr (32 / Lanes<T>::RL > 8) {
    if (rows <= 12) return launch_float_mt<T, 12>(a, e, q, s);
    return launch_float_mt<T, 16>(a, e, q, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace skinny
}  // namespace repro
