// Implicit-GEMM NHWC convolution with a dense weight:
// out[b, oh, ow, n] = act(scale[n] * sum_{i,j,c} x[b, oh*s + i - pt,
// ow*s + j - pl, c] * w[(i*kw + j)*C + c, n] + bias[n]), zero outside
// the image; x [B, H, W, C], w [kh*kw*C, N], out [B, Ho, Wo, N]. Float
// operands (conv_gemm_launch) accumulate in f32 and store x's dtype; an
// int8 image and weight (conv_gemm_s8_launch, the paper's INT8 datapath)
// sum exactly in int32 and store int32, f32 or int8 requantized.
//
// Replaces: src/repro/kernels/conv_gemm/kernel.py, conv_gemm_pallas — the
// CNN's dense conv layers (convnet's conv0, every conv under
// matmul="sta", lenet's conv1).
//
// Three bodies, picked by rules on dtype, C, kh, kw, stride and N alone
// (never B, H or W, so a pixel's bits do not depend on the batch or the
// image size), in this order:
//   - the small-C body (small_body: f32 or int8 images with K = kh·kw·C <=
//     kSmallK and N <= kSmallN; convnet's conv0, C 3 K 27 N 64, and lenet's
//     conv1, C 6 K 150 N 16), below. What bounds it: at conv0 the output,
//     2·K operations per 4-byte f32 (or int32 / int8) output, so the store
//     of 67 MB at B256 is the bound, the FMAs ~65% of it (f32 at the 67
//     TFLOP/s FMA rate). A block owns a tile of up to 128 output pixels
//     (whole output rows of one image where they fit: conv0 4 rows of 32,
//     lenet's conv1 9 of 14) x all N channels, so no tile is half empty.
//     It stages the whole [K, N] filter (6.9 KB at conv0, 9.6 KB at lenet's
//     conv1), a K table and the tile's image window with a zero halo (the
//     input rows and columns its pixels read, positions outside the image
//     zero: SAME padding, lo = total // 2; loaded row by row, coalesced)
//     in shared memory; each thread keeps 4 adjacent pixels x 8 channels
//     in registers: per K value four window reads and two 16-byte filter
//     reads feed 32 FMAs. f32 keeps one ascending-k fmaf chain per output
//     from 0, the FMA body's order, so its outputs are the FMA body's
//     bits; int8 packs a tap's channels 4 a word (padded with zeros to a
//     multiple of 4, in the window and the filter) and sums with dp4a:
//     exact int32, the IMAD body's and the plain version's bits. The
//     epilogue (finish) stores each run of 4 channels of a pixel as one
//     vector (16 bytes for f32 / int32 out, a word for int8): the 8 lanes
//     of a pixel write whole 32-byte sectors.
//   - the tensor-core body (tc_body: f32 images with C % 16 == 0 and N % 4
//     == 0, int8 ones with C % 64 == 0 and N % 16 == 0, kh, kw <= 32,
//     stride <= 8; conv_gemm_dbb.cu's rule; convnet's conv1 and conv2 under
//     matmul="sta"): conv_tc.cuh in its dense mode (TMA im2col boxes, w's
//     [K, N] boxes transposed to K-major tiles by a worker warpgroup,
//     3xTF32 wgmma for f32: within the f32 tolerances, not the FMA body's
//     bits; s8 wgmma for int8: exact). At conv1 / conv2 the dense work is
//     9.66 GFLOP a layer, hundreds of operations per stored byte: bound by
//     the tensor cores (3 tf32 products a k8 step for f32).
//   - the FMA body, for everything else (bf16 images, which no path
//     launches, and images off both rules): the block body of gemm_tile.cuh
//     (128 output pixels x 128 output channels, plain f32 FMA or int32 IMAD,
//     fused epilogue) with the im2col gather as its activation loader (an
//     integer 0 outside the image for int8): each K step gathers its
//     [128, 16] patch tile straight from device memory (L2 serves the
//     kh·kw reuse), so shared memory stays 16.6 KB at any image size.
// No body pads or copies the image or materialises an im2col tensor; K
// runs in the reference's order, so the weight matrix is the explicit
// lowering's. If a chosen body cannot be set up or launched, the call
// returns the error; it never falls back to another body.
// conv_gemm_small_body and conv_gemm_tc_body export the rules; the
// wrapper's small_body / tc_body mirror them and count conv_gemm_small /
// conv_gemm_tc (conv_gemm_s8_small / conv_gemm_s8_tc) launches.
#include "conv_tc.cuh"
#include "gemm_tile.cuh"
#include "split_k.cuh"

namespace {

using namespace repro::gemm;

template <typename T, typename TO = T>
__global__ void __launch_bounds__(kThreads)
conv_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, TO* __restrict__ out,
                 ConvGeom g, int N, int act) {
  const int M = g.B * g.Ho * g.Wo, K = g.kh * g.kw * g.C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const ConvGather<T> a(x, m0 + act_row(), g);
  const DenseWeights<T> wl{w, K, N};
  gemm_tile<TO>(a, wl, M, N, K, m0, n0, scale, bias, act, out);
}

// ---------------------------------------------------------------------------
// The small-C body
// ---------------------------------------------------------------------------

constexpr int kSmallK = 160;  // K = kh·kw·C: the filter it stages
constexpr int kSmallN = 64;   // N: 8 channel lanes of 8 channels
constexpr int kBand = 128;    // output pixels a block, at most
constexpr int kPT = 4;        // adjacent pixels a thread
constexpr int kNT = 8;        // channels a thread: two runs of 4
constexpr int kPL = kBand / kPT;       // pixel lanes: 32
constexpr int kWindowMax = 48 * 1024;  // bytes of a block's image window
constexpr int kBatch = 4;     // int8: loads a thread keeps in flight
// blocks an SM the registers must allow (at 256 threads: 64 registers a
// thread; 4 over 3 was faster for int8 conv0, level for f32: PERF.md)
constexpr int kSmallBlocks = 4;

// The small-C body's rule: dtype (the image's code), C, kh, kw and N only.
bool small_body(int dtype, int C, int kh, int kw, int N) {
  return (dtype == repro::DT_F32 || dtype == repro::DT_I8) &&
         kh * kw * C <= kSmallK && N <= kSmallN;
}

// The tensor-core body's rule, conv_gemm_dbb.cu's: dtype, C, kh, kw,
// stride and N only.
bool tc_body(int dtype, int C, int kh, int kw, int stride, int N) {
  return ((dtype == repro::DT_F32 && C % 16 == 0 && N % 4 == 0) ||
          (dtype == repro::DT_I8 && C % 64 == 0 && N % 16 == 0)) &&
         kh <= 32 && kw <= 32 && stride <= 8;
}

// What an operand type stages a word at a time: f32 one K value; int8 four
// channels of one tap (a tap's channels padded with zeros to a multiple of
// 4, in the window and in the filter alike), for dp4a.
template <typename T>
struct Small {
  using Word = float;
  static constexpr int kPack = 1;
};
template <>
struct Small<int8_t> {
  using Word = int;
  static constexpr int kPack = 4;
};

// One call's tiling (the launcher's choice from the whole geometry; no
// choice changes a sum's order): a block's tile is R output rows x CW
// output columns of one image, its window the input rows and columns they
// read, (R - 1)·stride + kh x (CW - 1)·stride + kw pixels of cp channels.
struct SmallGeom {
  ConvGeom g;
  int cp;     // channels a window pixel holds: C, or C rounded up to 4
  int words;  // K in words: K (f32), kh·kw·cp / 4 (int8)
  int R, CW, WR, WC;
  int th, tw;  // tiles along Ho and along Wo
};

// The phases of the small-C body (the launchers pass kSmallAll; the
// probe's phase launcher times subsets: the staging always runs)
enum SmallPhase { kSmallMath = 1, kSmallStore = 2, kSmallAll = 3 };

__host__ __device__ inline int align16(int b) { return (b + 15) / 16 * 16; }

// The dynamic shared memory, in bytes (16-byte aligned pieces): the filter
// [words][NP] words, scale and bias [2][NP] f32, the K table [words] int,
// the window [nwin] words.
struct SmallSmem {
  int ep, koff, win, total;
};

__host__ __device__ inline SmallSmem small_smem(int words, int NP,
                                                int nwin) {
  SmallSmem L;
  L.ep = align16(words * NP * 4);
  L.koff = L.ep + 2 * NP * 4;
  L.win = L.koff + align16(words * 4);
  L.total = L.win + nwin * 4;
  return L;
}

// four Words at a 16-byte aligned shared-memory address
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const int* p, int* v) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// One block: one tile (R x CW output pixels, R·CW <= 128) x all N
// channels. Threads: CL channel lanes (8 CL >= N) x 32 pixel lanes; thread
// (cl, pl) holds the tile's pixels 4 pl .. 4 pl + 3 (row-major in the tile)
// and channels 4 cl .. + 3 and 4 CL + 4 cl .. + 3 (so the 8 lanes of a
// pixel store whole 32-byte sectors). Shared memory (SmallSmem): the filter
// [words][8 CL] (word kq of channel n: f32 K row kq; int8 tap kq / cw,
// channels 4 (kq % cw) .. + 3; zero past C and N), scale and bias, the K
// table (word kq's offset in the window from a pixel's corner) and the
// window [WR][WC][cw] (zero outside the image), all staged at once: f32 by
// 4-byte cp.async copies (zero-filled where nothing is read), int8 by
// loads kBatch at a time a thread (its words are packed from bytes). Per K
// word: one table read, one window read a pixel, two 16-byte filter reads;
// 32 fmaf (f32: one ascending-k chain an output, from 0) or dp4a (int8:
// exact). Blocks are not persistent: the scheduler staggers their phases,
// so one block's staging and stores overlap another's math (a persistent
// grid with a double-buffered window, or with the outputs staged in shared
// memory and TMA bulk stores, was slower on the card: PERF.md).
template <typename T, typename TO, int CL>
__global__ void __launch_bounds__(CL * kPL, kSmallBlocks)
conv_small_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, TO* __restrict__ out,
                  const SmallGeom sg, int N, int act, int phase) {
  using Sm = Small<T>;
  using Word = typename Sm::Word;
  using Acc = repro::acc_t<T>;
  constexpr int kThr = CL * kPL, NP = CL * kNT;
  const ConvGeom& g = sg.g;
  const int KW = sg.words, cw = sg.cp / Sm::kPack;  // words a window pixel
  const int nfil = KW * NP, nwin = sg.WR * sg.WC * cw;
  const int t = threadIdx.x;
  const SmallSmem L = small_smem(KW, NP, nwin);
  extern __shared__ __align__(16) char smem[];
  Word* ws = reinterpret_cast<Word*>(smem);           // [KW][NP]
  float* ep = reinterpret_cast<float*>(smem + L.ep);  // scale [NP], bias
  int* koff = reinterpret_cast<int*>(smem + L.koff);  // [KW]
  Word* win = reinterpret_cast<Word*>(smem + L.win);  // [WR][WC][cw]

  // this block's tile: image b, first output row oh0 and column ow0, its
  // window's corner (ih0, iw0)
  const int per_image = sg.th * sg.tw;
  const int b = blockIdx.x / per_image, tr = blockIdx.x - b * per_image;
  const int oh0 = (tr / sg.tw) * sg.R, ow0 = (tr % sg.tw) * sg.CW;
  const int ih0 = oh0 * g.stride - g.pad_top;
  const int iw0 = ow0 * g.stride - g.pad_left;
  const int row_words = sg.WC * cw;  // a window row's words
  // the filter's words e < nfil, then the window's
  for (int e0 = t; e0 < nfil + nwin; e0 += kBatch * kThr) {
    Word v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThr;
      v[u] = Word(0);
      if (e < nfil) {
        const int kq = e / NP, n = e - kq * NP;
        if constexpr (Sm::kPack == 1) {
          repro::splitk::cp_async4(ws + e, w + (n < N ? kq * N + n : 0),
                                   n < N);
        } else if (n < N) {
          const int tap = kq / cw, c0 = 4 * (kq - tap * cw);
          uint32_t q32 = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c0 + q < g.C)
              q32 |= (uint32_t)(uint8_t)w[(tap * g.C + c0 + q) * N + n]
                     << (8 * q);
          v[u] = (Word)q32;
        }
      } else if (e < nfil + nwin) {
        const int wr = (e - nfil) / row_words;
        const int rem = e - nfil - wr * row_words;
        const int ih = ih0 + wr;
        const T* row = x + ((size_t)b * g.H + (ih >= 0 ? ih : 0)) * g.W * g.C;
        if constexpr (Sm::kPack == 1) {
          const int pos = iw0 * g.C + rem;  // element of the image row
          const bool ok = (unsigned)ih < (unsigned)g.H &&
                          (unsigned)pos < (unsigned)(g.W * g.C);
          repro::splitk::cp_async4(win + (e - nfil), ok ? row + pos : x, ok);
        } else {
          const int wc = rem / cw, c0 = 4 * (rem - wc * cw);
          const int iw = iw0 + wc;
          if ((unsigned)ih < (unsigned)g.H && (unsigned)iw < (unsigned)g.W) {
            uint32_t q32 = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (c0 + q < g.C)
                q32 |= (uint32_t)(uint8_t)row[iw * g.C + c0 + q] << (8 * q);
            v[u] = (Word)q32;
          }
        }
      }
    }
    if constexpr (Sm::kPack == 4) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThr;
        if (e < nfil)
          ws[e] = v[u];
        else if (e < nfil + nwin)
          win[e - nfil] = v[u];
      }
    }
  }
  repro::splitk::cp_async_commit();
  for (int n = t; n < NP; n += kThr) {
    ep[n] = scale != nullptr && n < N ? scale[n] : 0.f;
    ep[NP + n] = bias != nullptr && n < N ? bias[n] : 0.f;
  }
  for (int kq = t; kq < KW; kq += kThr) {
    const int tap = kq / cw, c = kq - tap * cw;
    const int i = tap / g.kw, j = tap - i * g.kw;
    koff[kq] = (i * sg.WC + j) * cw + c;
  }
  repro::splitk::cp_async_wait<0>();
  __syncthreads();

  // this thread's pixels: window offset and output row (-1: none)
  const int cl = t % CL, pl = t / CL;
  int off[kPT], m[kPT];
#pragma unroll
  for (int i = 0; i < kPT; ++i) {
    const int q = kPT * pl + i, r = q / sg.CW, col = q - r * sg.CW;
    const bool live =
        q < sg.R * sg.CW && oh0 + r < g.Ho && ow0 + col < g.Wo;
    off[i] = live ? (r * g.stride * sg.WC + col * g.stride) * cw : 0;
    m[i] = live ? (b * g.Ho + oh0 + r) * g.Wo + ow0 + col : -1;
  }
  Acc acc[kPT][kNT];
#pragma unroll
  for (int i = 0; i < kPT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j] = Acc(0);
  const Word* w0 = ws + 4 * cl;
  const Word* w1 = ws + 4 * CL + 4 * cl;
  if (phase & kSmallMath) {
#pragma unroll 4
    for (int kq = 0; kq < KW; ++kq) {
      const int ko = koff[kq];
      Word xv[kPT], wv[kNT];
#pragma unroll
      for (int i = 0; i < kPT; ++i) xv[i] = win[off[i] + ko];
      load4(w0 + kq * NP, wv);
      load4(w1 + kq * NP, wv + 4);
#pragma unroll
      for (int i = 0; i < kPT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if constexpr (Sm::kPack == 1)
            acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
          else
            acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
        }
    }
  }
  if (!(phase & kSmallStore)) return;

  // the epilogue: per pixel two runs of 4 channels through finish<TO>
  // (conv_tc.cuh's store_four: one vector store where N % 4 == 0), scale
  // and bias read from shared memory
  const float* sc = scale != nullptr ? ep : nullptr;
  const float* bi = bias != nullptr ? ep + NP : nullptr;
  const int M = g.B * g.Ho * g.Wo;
#pragma unroll
  for (int i = 0; i < kPT; ++i) {
    if (m[i] < 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Acc v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]};
      repro::convtc::store_four<TO>(out, m[i], 4 * (h ? CL + cl : cl), M, N,
                                    v, sc, bi, act, 0);
    }
  }
}

// the tiling: whole output rows up to 128 pixels (CW = min(Wo, 128), R =
// 128 / CW), halved (R first) until the window fits kWindowMax
template <typename T>
SmallGeom small_geom(const ConvGeom& g) {
  using Sm = Small<T>;
  SmallGeom sg{};
  sg.g = g;
  sg.cp = (g.C + Sm::kPack - 1) / Sm::kPack * Sm::kPack;
  sg.words = g.kh * g.kw * sg.cp / Sm::kPack;
  sg.CW = g.Wo < kBand ? g.Wo : kBand;
  sg.R = kBand / sg.CW < g.Ho ? kBand / sg.CW : g.Ho;
  for (;;) {
    sg.WR = (sg.R - 1) * g.stride + g.kh;
    sg.WC = (sg.CW - 1) * g.stride + g.kw;
    const long long bytes = (long long)sg.WR * sg.WC * sg.cp * 4 /
                            Small<T>::kPack;
    if (bytes <= kWindowMax || (sg.R == 1 && sg.CW == 1)) break;
    if (sg.R > 1)
      sg.R = (sg.R + 1) / 2;
    else
      sg.CW = (sg.CW + 1) / 2;
  }
  sg.th = (g.Ho + sg.R - 1) / sg.R;
  sg.tw = (g.Wo + sg.CW - 1) / sg.CW;
  return sg;
}

// Launch the small-C body: one block a tile.
template <typename T, typename TO, int CL>
int launch_small_cl(const T* x, const T* w, const float* scale,
                    const float* bias, TO* out, const ConvGeom& g, int N,
                    int act, int phase, cudaStream_t s) {
  const SmallGeom sg = small_geom<T>(g);
  const int nwin = sg.WR * sg.WC * (sg.cp / Small<T>::kPack);
  const int smem = small_smem(sg.words, CL * kNT, nwin).total;
  const auto kernel = conv_small_kernel<T, TO, CL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<g.B * sg.th * sg.tw, CL * kPL, smem, s>>>(x, w, scale, bias, out,
                                                      sg, N, act, phase);
  return (int)cudaGetLastError();
}

// channel lanes: the fewest (a power of two) whose 8 channels each cover N
template <typename T, typename TO>
int launch_small(const void* x, const void* w, const void* scale,
                 const void* bias, void* out, const ConvGeom& g, int N,
                 int act, cudaStream_t s, int phase = kSmallAll) {
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* o = static_cast<TO*>(out);
  if (N <= kNT)
    return launch_small_cl<T, TO, 1>(xt, wt, sc, bi, o, g, N, act, phase,
                                     s);
  if (N <= 2 * kNT)
    return launch_small_cl<T, TO, 2>(xt, wt, sc, bi, o, g, N, act, phase,
                                     s);
  if (N <= 4 * kNT)
    return launch_small_cl<T, TO, 4>(xt, wt, sc, bi, o, g, N, act, phase,
                                     s);
  return launch_small_cl<T, TO, 8>(xt, wt, sc, bi, o, g, N, act, phase, s);
}

}  // namespace

extern "C" int conv_gemm_small_body(int dtype, int C, int kh, int kw, int N) {
  return small_body(dtype, C, kh, kw, N) ? 1 : 0;
}

extern "C" int conv_gemm_tc_body(int dtype, int C, int kh, int kw, int stride,
                                 int N) {
  return !small_body(dtype, C, kh, kw, N) &&
                 tc_body(dtype, C, kh, kw, stride, N)
             ? 1
             : 0;
}

extern "C" int conv_gemm_launch(const void* x, const void* w,
                                const void* scale, const void* bias,
                                void* out, int B, int H, int W, int C, int Ho,
                                int Wo, int kh, int kw, int stride,
                                int pad_top, int pad_left, int N, int act,
                                int dtype, void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small_body(dtype, C, kh, kw, N))
    return launch_small<float, float>(x, w, scale, bias, out, g, N, act, s);
  if (tc_body(dtype, C, kh, kw, stride, N))
    return repro::convtc::launch<float, float>(
        x, w, nullptr, scale, bias, out, g, N, repro::convtc::kDense, act,
        repro::convtc::kAll, s);
  const dim3 grid = grid_for(B * Ho * Wo, N);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == repro::DT_BF16) {
    conv_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), sc, bi,
        static_cast<__nv_bfloat16*>(out), g, N, act);
  } else {
    conv_gemm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sc, bi,
        static_cast<float*>(out), g, N, act);
  }
  return (int)cudaGetLastError();
}

// int8 image and weight: out_dtype DT_I32, DT_F32 or DT_I8
extern "C" int conv_gemm_s8_launch(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int B, int H, int W, int C,
                                   int Ho, int Wo, int kh, int kw, int stride,
                                   int pad_top, int pad_left, int N, int act,
                                   int out_dtype, void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = small_body(repro::DT_I8, C, kh, kw, N);
  const bool tc = !small && tc_body(repro::DT_I8, C, kh, kw, stride, N);
  int rc = 0;
  const int last = repro::with_s8_out(out_dtype, [&](auto o) {
    using TO = decltype(o);
    if (small) {
      rc = launch_small<int8_t, TO>(x, w, scale, bias, out, g, N, act, s);
    } else if (tc) {
      rc = repro::convtc::launch<int8_t, TO>(
          x, w, nullptr, scale, bias, out, g, N, repro::convtc::kDense, act,
          repro::convtc::kAll, s);
    } else {
      conv_gemm_kernel<int8_t, TO><<<grid_for(B * Ho * Wo, N), kThreads, 0,
                                     s>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(scale), static_cast<const float*>(bias),
          static_cast<TO*>(out), g, N, act);
    }
  });
  return rc != 0 ? rc : last;
}

// The small-C body alone, one phase set at a time (SmallPhase: 1 the math,
// 2 the epilogue and the copy out, 3 both; the staging always runs), f32
// output;
// for scripts/torch_conv_probe.py's phase split. dtype: the image's code
// (DT_F32 or DT_I8); a shape off the rule launches nothing.
extern "C" int conv_gemm_small_phase_launch(
    const void* x, const void* w, const void* scale, const void* bias,
    void* out, int B, int H, int W, int C, int Ho, int Wo, int kh, int kw,
    int stride, int pad_top, int pad_left, int N, int act, int dtype,
    int phase, void* stream) {
  const ConvGeom g{B, H, W, C, Ho, Wo, kh, kw, stride, pad_top, pad_left};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!small_body(dtype, C, kh, kw, N)) return (int)cudaErrorInvalidValue;
  return dtype == repro::DT_F32
             ? launch_small<float, float>(x, w, scale, bias, out, g, N, act,
                                          s, phase)
             : launch_small<int8_t, float>(x, w, scale, bias, out, g, N, act,
                                           s, phase);
}
