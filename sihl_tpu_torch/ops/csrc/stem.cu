// The ResNet stem's 7x7 / stride 2 / pad 3 convolution of an image with up
// to 8 channels to 64 channels, with BatchNorm's batch statistics in the
// same pass (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel sihl_tpu/ops/pallas/stem.py:_stem_kernel (launched
// by stem_conv_stats).  Given x (B, H, W, C) in NHWC memory and the weights,
// it writes y (B, H/2, W/2, 64) in x's type, and the f32 sum and sum of
// squares over every position of each channel of y *after* y is rounded to
// its type: what BatchNorm's batch statistics reduce over.  Each output is a
// sum of 49 * C exact products in f32, rounded once (the TPU kernel takes
// bf16 products into f32 on its matrix unit).
//
// What bounds it on this card.  At the training shape (16 images of
// 3 x 640 x 640 -> 16 x 64 x 320 x 320) the call moves 249 MB in bf16
// (0.074 ms at 3.35 TB/s) and does 15.4 G multiply-adds: 0.031 ms on the
// bf16 tensor cores, 0.46 ms as f32 FMAs.  So the bytes bound it, once the
// products run on the tensor cores.  Two bodies, chosen by x's type:
//  - bf16 (every bf16 training step): stem_conv_stats_mma_kernel<C>, the
//    products on bf16 mma.sync with f32 accumulators.  A block takes tiles
//    of 8 x 16 output pixels in a persistent loop (blocks sized by
//    occupancy, stride gridDim.x).  It stages each tile's raw halo (21
//    rows x 38 pixels x C) from the unpadded image with 4-byte cp.async,
//    zeros outside the image being the padding, two tiles deep so the next
//    halo loads while this tile is computed, then widens it to CP = 4
//    channels a pixel (8 for C > 4), zeros past C.  No patch operand is
//    built: with k = (ky * 8 + kx) * CP + c and an eighth tap kx = 7 of
//    zero weights (as the TPU kernel's), the k of kernel row ky of output
//    pixel (i, j) are one contiguous, 16-byte aligned run of staged row
//    2 i + ky from pixel 2 j on, so ldmatrix reads A's rows from the halo
//    itself, the eight rows of a phase 16 bytes apart (no bank conflicts
//    at CP = 4).  That costs 224 k at C = 3 instead of 147 rounded up to
//    160 (0.044 ms of products at the tensor cores' peak instead of
//    0.031) and saves the copy into an operand, which took about a third
//    of the stem-variant probe's full leg (stem_variants.cu builds it).
//    The weights (KP x 64, the wrapper's weight image: zero rows at
//    kx = 7 and c >= C) stay in shared memory, swizzled, for the block's
//    life.  8 warps as 4 (two tile rows) x 2 (32 channels) run the
//    products; the epilogue rounds each output once to bf16 into a shared
//    y tile, which goes out with 16-byte stores.  BatchNorm's sums are read
//    back from that tile, whose values are the rounded y: each warp sums
//    one tile row's pixels inside the image (a ragged tile's rows and
//    columns past H/2 or W/2 hold the conv of the zero padding, which is
//    not zero), a lane two channels, in column order; then the tile rows
//    are summed in order through shared memory into one partial per tile.
//    That takes fewer instructions than folding the mma fragments with
//    lane shuffles.  A partial per tile, not per block, keeps the sums
//    independent of how many blocks are resident; the partials lie
//    (2 * 64, tiles), so the reduction reads contiguous rows.  At C = 3 a
//    block takes 64 KB of shared memory and 124 registers a thread, two
//    blocks an SM; at C = 8, 114 KB and one.
//  - f32 (the f32 slices, held against an f64 step within 1e-5):
//    stem_conv_stats_kernel<float>, f32 FMAs.  f32 operands cannot go to
//    the bf16 tensor cores without changing the function, and TF32 keeps
//    too few digits for that agreement.  A block takes 8 output rows x 32
//    columns x 64 channels with 512 threads, staging the halo'd input
//    (21 x 69 x C, zeros outside the image) and the (7, 7, C, 64) weights
//    in shared memory; each thread owns 8 neighbouring output columns of
//    one row by 4 channels (32 accumulators) and loads the 21 input values
//    its 8 outputs x 7 taps read once per channel and kernel row, each
//    weight quad one 16-byte broadcast: about 8 FMAs per shared load.  Its
//    epilogue sums into one partial per block.
// The TPU kernel's design is not carried over: its parity and lane-phase
// split of the padded image (stem.py:13-31, :203-209) and its row tiling
// exist to turn the taps into a deep contraction for the 128-lane matrix
// unit.  stem_stats_reduce_kernel sums the partials in a fixed order (the
// TPU accumulates them across its sequential grid, which the card's blocks
// do not have).  No atomics: the sums are bitwise the same from call to
// call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KS = 7;             // kernel height and width
constexpr int CO = 64;            // output channels
constexpr int MAX_C = 8;          // input channels
constexpr int TR = 8;             // output rows per block
constexpr int TC = 32;            // output columns per block
constexpr int PIX = 8;            // output columns per thread
constexpr int IN_ROWS = 2 * TR + KS - 2;   // 21
constexpr int IN_COLS = 2 * TC + KS - 2;   // 69
constexpr int SPAN = 2 * PIX + KS - 2;     // 21 input columns a thread reads
constexpr int THREADS = 512;      // 16 channel quads x 32 pixel groups
constexpr int GROUPS = THREADS / (CO / 4);
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }

// Store four f32 outputs at p (4 consecutive channels); they need no rounding.
__device__ __forceinline__ void round_store4(float* p, float v[4], bool valid) {
  if (valid) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Floats of the staged input tile, rounded up so that the weights after it
// sit on a 16-byte boundary.
__host__ __device__ int input_floats(int c) { return (c * IN_ROWS * IN_COLS + 3) / 4 * 4; }

size_t smem_bytes(int c) {
  return sizeof(float) * ((size_t)input_floats(c) + (size_t)KS * KS * c * CO + 2 * GROUPS * CO);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_conv_stats_kernel(const T* __restrict__ x,       // (b, h, w, c)
                       const float* __restrict__ wk,  // (7, 7, c, 64)
                       int h, int w, int c,
                       T* __restrict__ y,             // (b, h/2, w/2, 64)
                       float* __restrict__ partials)  // (blocks, 2, 64)
{
  extern __shared__ float smem[];
  float* s_in = smem;                                  // (c, IN_ROWS, IN_COLS)
  float* s_w = s_in + input_floats(c);                 // (7, 7, c, 64)
  float* s_red = s_w + KS * KS * c * CO;               // (2, GROUPS, 64)
  const int h2 = h / 2, w2 = w / 2;
  const int b = blockIdx.z, i0 = blockIdx.y * TR, j0 = blockIdx.x * TC;
  const int tid = threadIdx.x;

  // stage the halo'd input tile (channel planes) and the weights
  const int row0 = 2 * i0 - 3, col0 = 2 * j0 - 3;
  const int n_in = IN_ROWS * IN_COLS * c;
  for (int idx = tid; idx < n_in; idx += THREADS) {
    const int ch = idx % c, rest = idx / c;
    const int u = rest % IN_COLS, t = rest / IN_COLS;
    const int ir = row0 + t, ic = col0 + u;
    float v = 0.f;
    if (ir >= 0 && ir < h && ic >= 0 && ic < w) v = to_float(x[(((size_t)b * h + ir) * w + ic) * c + ch]);
    s_in[(ch * IN_ROWS + t) * IN_COLS + u] = v;
  }
  const int n_w4 = KS * KS * c * CO / 4;
  for (int idx = tid; idx < n_w4; idx += THREADS)
    reinterpret_cast<float4*>(s_w)[idx] = reinterpret_cast<const float4*>(wk)[idx];
  __syncthreads();

  // thread = (pixel group, channel quad); a pixel group is PIX columns of one row
  const int quad = tid % (CO / 4), group = tid / (CO / 4);
  const int r = group / (TC / PIX), q = group % (TC / PIX);
  float acc[PIX][4];
#pragma unroll
  for (int p = 0; p < PIX; ++p)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[p][o] = 0.f;

  for (int ch = 0; ch < c; ++ch) {
#pragma unroll
    for (int ky = 0; ky < KS; ++ky) {
      const float* row = s_in + (ch * IN_ROWS + 2 * r + ky) * IN_COLS + 2 * PIX * q;
      float in[SPAN];
#pragma unroll
      for (int u = 0; u < SPAN; ++u) in[u] = row[u];
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const float4 wv = reinterpret_cast<const float4*>(s_w + ((ky * KS + kx) * c + ch) * CO)[quad];
#pragma unroll
        for (int p = 0; p < PIX; ++p) {
          const float v = in[2 * p + kx];
          acc[p][0] = fmaf(v, wv.x, acc[p][0]);
          acc[p][1] = fmaf(v, wv.y, acc[p][1]);
          acc[p][2] = fmaf(v, wv.z, acc[p][2]);
          acc[p][3] = fmaf(v, wv.w, acc[p][3]);
        }
      }
    }
  }

  // round, store, and sum the rounded values over this thread's pixels
  const int oi = i0 + r;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const int oj = j0 + PIX * q + p;
    const bool valid = oi < h2 && oj < w2;
    T* dst = y + (((size_t)b * h2 + oi) * w2 + oj) * CO + 4 * quad;
    round_store4(dst, acc[p], valid);
    if (valid) {
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        s[o] += acc[p][o];
        sq[o] += acc[p][o] * acc[p][o];
      }
    }
  }
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    s_red[group * CO + 4 * quad + o] = s[o];
    s_red[(GROUPS + group) * CO + 4 * quad + o] = sq[o];
  }
  __syncthreads();
  // the block's partial: each (statistic, channel) summed over the groups in order
  if (tid < 2 * CO) {
    const int stat = tid / CO, chan = tid % CO;
    float total = 0.f;
    for (int g = 0; g < GROUPS; ++g) total += s_red[(stat * GROUPS + g) * CO + chan];
    const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partials[block * 2 * CO + tid] = total;
  }
}

// One block per (statistic, channel): the partials summed in a fixed order
// (a strided pass, then a fixed tree).  Partial j of entry e (stat * 64 +
// channel) is at j * part_stride + e * entry_stride.
__global__ void __launch_bounds__(REDUCE_THREADS)
stem_stats_reduce_kernel(const float* __restrict__ partials, int count, long long part_stride,
                         long long entry_stride, float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float red[REDUCE_THREADS];
  const int entry = blockIdx.x;
  float total = 0.f;
  for (int j = threadIdx.x; j < count; j += REDUCE_THREADS)
    total += partials[(size_t)j * part_stride + (size_t)entry * entry_stride];
  red[threadIdx.x] = total;
  __syncthreads();
  for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) (entry < CO ? sum : sumsq)[entry % CO] = red[0];
}

int launch_f32(const float* x, int b, int h, int w, int c, const float* wk, float* y, float* partials, float* sum,
               float* sumsq, cudaStream_t stream) {
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(stem_conv_stats_kernel<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w / 2 + TC - 1) / TC, (h / 2 + TR - 1) / TR, b);
  stem_conv_stats_kernel<float><<<grid, THREADS, smem, stream>>>(x, wk, h, w, c, y, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // partials (blocks, 2, 64)
  stem_stats_reduce_kernel<<<2 * CO, REDUCE_THREADS, 0, stream>>>(partials, (int)(grid.x * grid.y * grid.z), 2 * CO,
                                                                    1, sum, sumsq);
  return (int)cudaGetLastError();
}

// ---------------------------------------------- the bf16 body: tensor cores

namespace mma {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TR = 8, TC = 16, PIX = TR * TC;  // output tile: 128 pixels
constexpr int HR = 2 * TR + KS - 2;            // 21 halo rows
// 38 halo pixels a row: the 7 taps of 16 outputs at stride 2, and an
// eighth tap of zero weights (kx = 7, as the TPU kernel's), so a kernel
// row's taps come in whole 16-byte chunks
constexpr int HC = 2 * TC + KS - 1;
constexpr int KX = KS + 1;
// 8 warps as 4 (pixels) x 2 (channels): a warp owns 32 pixels by 32
// channels, two m-tiles of 16 (two tile rows) by four n-tiles of 8
constexpr int WM = 32, WN = 32, MT = WM / 16, NT = WN / 8;
constexpr int W_CHUNKS = CO / 8;                       // 16-byte chunks of a w or y row
constexpr int Y_BYTES = PIX * CO * 2;                  // 16,384
constexpr int RED_BYTES = TR * 2 * CO * 4;             // 4,096: (tile row, stat, channel)
constexpr int STORE_STEPS = PIX * W_CHUNKS / THREADS;  // 4
static_assert(PIX * W_CHUNKS % THREADS == 0, "the store pass");
static_assert(PIX == 4 * WM && CO == 2 * WN && TC == 16, "warps tile the pixels and channels; an m-tile is a tile row");
static_assert(WARPS == TR && CO == 2 * 32, "the sums: a warp a tile row, a lane two channels");

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// Shared-memory layout for C input channels.
template <int C>
struct Geometry {
  // channels of a staged pixel: a pair of taps (CP = 4) or one tap (8) is
  // 16 bytes, one ldmatrix row
  static constexpr int CP = C <= 4 ? 4 : 8;
  static constexpr int KP = KS * KX * CP;  // 224 or 448: k = (ky * 8 + kx) * CP + c
  // A raw halo row holds C % 2 bf16 before its first pixel, so its 4-byte
  // words sit on even element offsets of the image row ((2 c0 - 3) C is
  // odd for odd C), and ends on a whole word.
  static constexpr int LEAD = C % 2;
  static constexpr int HROW = (LEAD + HC * C + 1) / 2 * 2;
  static constexpr int HWORDS = HROW / 2;
  static constexpr int RAW_BYTES = align128(HR * HROW * 2);
  static constexpr int ROW_BYTES = HC * CP * 2;  // a staged halo row: 304 or 608 bytes
  static constexpr int PAD_BYTES = align128(HR * ROW_BYTES);
  static constexpr int W_BYTES = KP * CO * 2;
  static constexpr int SMEM = 2 * RAW_BYTES + PAD_BYTES + W_BYTES + Y_BYTES + RED_BYTES;
  // blocks that share an SM's 228 KB (1 KB of it reserved per block): the
  // register budget follows, 128 a thread for two blocks
  static constexpr int BLOCKS_PER_SM = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static constexpr int HALO_STEPS = (HR * HWORDS + THREADS - 1) / THREADS;
  static constexpr int PAD_STEPS = (HR * HC + THREADS - 1) / THREADS;
  static_assert(KP % 16 == 0 && KX * CP % 16 == 0, "a k-step stays in one kernel row");
  static_assert(SMEM <= 232448, "a block's shared memory");
};

struct Tile {
  int b, r0, c0;  // image, first output row and column
};

__device__ __forceinline__ Tile tile_at(long long t, int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int b = (int)(t / per_image), rem = (int)(t % per_image);
  return {b, (rem / tiles_w) * TR, (rem % tiles_w) * TC};
}

// Start copying the raw halo of `tile` into `dst`: input rows 2 r0 - 3 ..
// 2 r0 + 17 and pixels 2 c0 - 3 .. 2 c0 + 34, zeros outside the image.
// Halo element (row hr, pixel pc, channel c) lands at hr * HROW + LEAD +
// pc * C + c.  A 4-byte pair never straddles the image's edge, since a row
// holds an even number of elements (W is even).
template <int C>
__device__ __forceinline__ void load_halo(uint32_t dst, const bf16* x, int h, int w, Tile tile, int tid) {
  using G = Geometry<C>;
  const int row_elems = w * C;
#pragma unroll
  for (int r = 0; r < G::HALO_STEPS; ++r) {
    const int i = tid + r * THREADS;
    if (i < HR * G::HWORDS) {
      const int hr = i / G::HWORDS, word = i % G::HWORDS;
      const int ih = 2 * tile.r0 - 3 + hr;
      const int g = (2 * tile.c0 - 3) * C - G::LEAD + 2 * word;  // even element of the image row
      const bool in = ih >= 0 && ih < h && g >= 0 && g < row_elems;
      const bf16* src = in ? x + ((size_t)tile.b * h + ih) * row_elems + g : x;
      cp_async4(dst + (uint32_t)(hr * G::HROW + 2 * word) * 2u, src, in ? 4 : 0);
    }
  }
}

// Widen the raw halo to CP channels a pixel, zeros past C: staged pixel
// (hr, pc) is CP bf16 at hr * ROW_BYTES + pc * CP * 2.  Output pixel
// (i, j) of the tile then reads the taps of kernel row ky as one
// contiguous run of the staged row 2 i + ky from pixel 2 j on, which is
// its row of the patch operand A: ldmatrix reads A from the halo itself.
template <int C>
__device__ __forceinline__ void pad_halo(char* pad_s, const uint16_t* raw, int tid) {
  using G = Geometry<C>;
#pragma unroll
  for (int r = 0; r < G::PAD_STEPS; ++r) {
    const int i = tid + r * THREADS;
    if (i < HR * HC) {
      const int hr = i / HC, pc = i % HC;
      const uint16_t* src = raw + hr * G::HROW + G::LEAD + pc * C;
      uint32_t words[G::CP / 2];
#pragma unroll
      for (int c = 0; c < G::CP; c += 2)
        words[c / 2] = (c < C ? (uint32_t)src[c] : 0u) | ((c + 1 < C ? (uint32_t)src[c + 1] : 0u) << 16);
      char* dst = pad_s + hr * G::ROW_BYTES + pc * G::CP * 2;
      if constexpr (G::CP == 4)
        *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

// x: (b, h, w, C) NHWC bf16, 4-byte aligned; wk: (KP, 64) bf16 rows in k
// order, zero at kx = 7 and c >= C, as 16-byte chunks; y: (b, h/2, w/2, 64);
// partials: (2 * 64, tiles), entry-major, one column per tile.
template <int C>
__global__ void __launch_bounds__(THREADS, Geometry<C>::BLOCKS_PER_SM)
stem_conv_stats_mma_kernel(const bf16* __restrict__ x, const uint4* __restrict__ wk, int b, int h, int w,
                           bf16* __restrict__ y, float* __restrict__ partials) {
  using G = Geometry<C>;
  extern __shared__ __align__(128) char smem[];
  char* raw_s = smem;                           // two raw halos
  char* pad_s = raw_s + 2 * G::RAW_BYTES;       // the staged halo, CP channels a pixel
  char* w_s = pad_s + G::PAD_BYTES;             // weights, [k][co] swizzled
  char* y_s = w_s + G::W_BYTES;                 // y tile, [pixel][co] swizzled
  float* red_s = reinterpret_cast<float*>(y_s + Y_BYTES);
  const uint32_t raw_base = smem_addr(raw_s), pad_base = smem_addr(pad_s), w_base = smem_addr(w_s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ho = h / 2, wo = w / 2;
  const int tiles_h = (ho + TR - 1) / TR, tiles_w = (wo + TC - 1) / TC;
  const long long tiles = (long long)b * tiles_h * tiles_w;
  const long long step = gridDim.x;

  for (int e = tid; e < G::KP * W_CHUNKS; e += THREADS)
    *reinterpret_cast<uint4*>(w_s + swz(e / W_CHUNKS, e % W_CHUNKS)) = wk[e];

  long long t = blockIdx.x;
  if (t < tiles) load_halo<C>(raw_base, x, h, w, tile_at(t, tiles_h, tiles_w), tid);
  cp_async_commit();
  int stage = 0;
  for (; t < tiles; t += step, stage ^= 1) {
    const Tile tile = tile_at(t, tiles_h, tiles_w);
    // the next tile's halo goes into the buffer the last tile read
    if (t + step < tiles)
      load_halo<C>(raw_base + (stage ^ 1) * G::RAW_BYTES, x, h, w, tile_at(t + step, tiles_h, tiles_w), tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    pad_halo<C>(pad_s, reinterpret_cast<const uint16_t*>(raw_s + stage * G::RAW_BYTES), tid);
    __syncthreads();

    const int wm = (warp >> 1) * WM, wn = (warp & 1) * WN, j8 = lane >> 3;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    // this lane's ldmatrix row of A: pixel (tile row wm / 16 + i, column
    // (lane & 7) + 8 (j8 & 1)), whose window starts at staged row 2 (wm /
    // 16 + i), pixel 2 column; j8 >> 1 picks the upper 8 k of a k-step
    const uint32_t a_lane = pad_base + (uint32_t)(2 * (wm / TC) * G::ROW_BYTES +
                                                  2 * ((lane & 7) + (j8 & 1) * 8) * G::CP * 2 + (j8 >> 1) * 16);
#pragma unroll
    for (int k0 = 0; k0 < G::KP; k0 += 16) {
      const int ky = k0 / (KX * G::CP), kx = k0 % (KX * G::CP) / G::CP;
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], a_lane + (uint32_t)((2 * i + ky) * G::ROW_BYTES + kx * G::CP * 2));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, w_base + swz(k0 + (lane & 7) + (j8 & 1) * 8, ((wn + j * 8) >> 3) + (j8 >> 1)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], a[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], a[i], bf[2], bf[3]);
        }
      }
    }

    // epilogue: round once to bf16 into the y tile
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int p = wm + i * 16 + (lane >> 2), co = wn + j * 8 + (lane & 3) * 2;
        stage_pair(y_s, p, co, pack_bf16(acc[i][j][0], acc[i][j][1]));
        stage_pair(y_s, p + 8, co, pack_bf16(acc[i][j][2], acc[i][j][3]));
      }
    __syncthreads();

    // 16 bytes a thread, a tile row of 16 pixels 2 KB contiguous in y
#pragma unroll
    for (int r = 0; r < STORE_STEPS; ++r) {
      const int p = tid / W_CHUNKS + r * (THREADS / W_CHUNKS), ch = tid % W_CHUNKS;
      const int oh = tile.r0 + p / TC, ow = tile.c0 + p % TC;
      if (oh < ho && ow < wo)
        *reinterpret_cast<uint4*>(y + (((size_t)tile.b * ho + oh) * wo + ow) * CO + ch * 8) =
            *reinterpret_cast<const uint4*>(y_s + swz(p, ch));
    }
    // BatchNorm's sums of the rounded y, from the y tile: warp w sums tile
    // row w over its columns inside the image (in a ragged tile the rest
    // hold the conv of the zero padding, which is not zero), lane l
    // channels 2 l and 2 l + 1
    {
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
      if (tile.r0 + warp < ho) {
#pragma unroll
        for (int u = 0; u < TC; ++u) {
          if (tile.c0 + u < wo) {
            const __nv_bfloat162 v =
                *reinterpret_cast<const __nv_bfloat162*>(y_s + swz(warp * TC + u, lane >> 2) + (lane & 3) * 4);
            const float lo = __low2float(v), hi = __high2float(v);
            s0 += lo;
            q0 += lo * lo;
            s1 += hi;
            q1 += hi * hi;
          }
        }
      }
      float* red = red_s + warp * 2 * CO;
      red[2 * lane] = s0;
      red[2 * lane + 1] = s1;
      red[CO + 2 * lane] = q0;
      red[CO + 2 * lane + 1] = q1;
    }
    __syncthreads();  // the y tile and the staged halo are free again
    // the tile's partial: each (statistic, channel) summed over the tile rows in order
    if (tid < 2 * CO) {
      float total = 0.f;
#pragma unroll
      for (int r = 0; r < TR; ++r) total += red_s[r * 2 * CO + tid];
      partials[(size_t)tid * tiles + t] = total;
    }
  }
  cp_async_wait<0>();
}

long long tiles(int b, int h, int w) { return (long long)b * ((h / 2 + TR - 1) / TR) * ((w / 2 + TC - 1) / TC); }

template <int C>
int launch(const bf16* x, int b, int h, int w, const uint4* wk, bf16* y, float* partials, float* sum, float* sumsq,
           cudaStream_t stream) {
  constexpr int smem = Geometry<C>::SMEM;
  auto kernel = stem_conv_stats_mma_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n = tiles(b, h, w), resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(n < resident ? n : resident), THREADS, smem, stream>>>(x, wk, b, h, w, y, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stem_stats_reduce_kernel<<<2 * CO, REDUCE_THREADS, 0, stream>>>(partials, (int)n, 1, n, sum, sumsq);
  return (int)cudaGetLastError();
}

}  // namespace mma

int launch_bf16(const bf16* x, int b, int h, int w, int c, const uint4* wk, bf16* y, float* partials, float* sum,
                float* sumsq, cudaStream_t stream) {
  switch (c) {
    case 1: return mma::launch<1>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    case 2: return mma::launch<2>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    case 3: return mma::launch<3>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    case 4: return mma::launch<4>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    case 5: return mma::launch<5>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    case 6: return mma::launch<6>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    case 7: return mma::launch<7>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    case 8: return mma::launch<8>(x, b, h, w, wk, y, partials, sum, sumsq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Widest input the kernel takes (channels), and its output channels.
int sihl_stem_max_channels() { return MAX_C; }
int sihl_stem_out_channels() { return CO; }

// Floats of scratch sihl_stem_conv_stats needs for these sizes: one
// (2, 64) partial per tile of the bf16 body, per block of the f32 body.
long long sihl_stem_workspace_floats(int is_bf16, int b, int h, int w) {
  const long long blocks = (long long)((w / 2 + TC - 1) / TC) * ((h / 2 + TR - 1) / TR) * b;
  return (is_bf16 ? mma::tiles(b, h, w) : blocks) * 2 * CO;
}

// x: (b, h, w, c) NHWC in bf16 (is_bf16; 4-byte aligned) or f32, h and w
// even, 1 <= c <= 8; wk: for bf16 the (7 * 8 * CP, 64) bf16 weight image
// (row k = (ky * 8 + kx) * CP + ch, CP = 4 for c <= 4, else 8; zero rows
// at kx = 7 and ch >= c; 16-byte aligned), for f32 the (7, 7, c, 64) f32
// weights; y:
// (b, h/2, w/2, 64) in x's type; partials: the scratch of
// sihl_stem_workspace_floats; sum, sumsq: (64) f32.  Two launches on
// `stream` without synchronising; returns the first cudaError_t that is
// not cudaSuccess.
int sihl_stem_conv_stats(int is_bf16, const void* x, int b, int h, int w, int c, const void* wk, void* y,
                         float* partials, float* sum, float* sumsq, void* stream) {
  if (c < 1 || c > MAX_C || h % 2 || w % 2 || b < 1 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_f32(static_cast<const float*>(x), b, h, w, c, static_cast<const float*>(wk), static_cast<float*>(y),
                      partials, sum, sumsq, st);
  if (reinterpret_cast<uintptr_t>(x) % 4 || reinterpret_cast<uintptr_t>(wk) % 16)
    return (int)cudaErrorMisalignedAddress;
  return launch_bf16(static_cast<const bf16*>(x), b, h, w, c, static_cast<const uint4*>(wk), static_cast<bf16*>(y),
                     partials, sum, sumsq, st);
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
