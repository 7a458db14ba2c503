// The ResNet stem's 7x7 / stride 2 / pad 3 convolution of a 3-channel image
// to 64 channels, split into legs that each do one part of the work, for
// Hopper (sm_90a): the stem-variant probe P3.
//
// Replaces tools/probe_stem_variants.py:run (:180, inside main; its
// pallas_calls at :182 and :196), which times stripped variants of the TPU
// stem kernel to say which part is slow.  Given x (B, H, W, 3) NHWC bf16
// with H and W even, and w (7, 7, 3, 64) HWIO bf16, every leg writes y
// (B, H/2, W/2, 64) NHWC bf16 with the same 16-byte stores; the legs differ
// only in the work that fills the y tile:
//   LOAD     stage the tile's halo of x in shared memory, then
//            y[b, i, j, co] = x[b, 2i, 2j, co % 3] read back from it;
//   STAGE    LOAD, and build the tile's patch operand A from the halo;
//            y[b, i, j, co] = A[pixel (i, j)][co] for co < 64;
//   PRODUCT  no image staged per tile: A's every row is the window of
//            output pixel (0, 0) of the tile's image (built when a block
//            moves to another image), then the products and the epilogue
//            of FULL: y[b, i, j, :] = the conv's output at (b, 0, 0);
//   FULL     LOAD, STAGE and PRODUCT together: y = the stem conv, rounded
//            once from f32 sums to bf16.
// The patch operand's contraction index is k = (ky * 7 + kx) * 3 + c, so
// A[pixel (i, j)][k] = x_pad[b, 2i + ky - 3, 2j + kx - 3, c]; 147 entries,
// padded with zeros to 160 (ten k-steps of 16; the padding's weights are
// zero, as the TPU kernel's eighth tap column kx = 7 is).
//
// What bounds it on this card.  At the probe's shape (16 images of
// 640 x 640 x 3 -> 16 x 320 x 320 x 64) the full conv moves 249 MB (x read
// once, y written once: 0.0743 ms at 3.35 TB/s) and does 30.8 GFLOP (0.031
// ms on the bf16 tensor cores, 0.46 ms as f32 FMAs, which K4's f32 body in
// stem.cu runs): bytes, mostly y's 210 MB.  The question the legs answer is how far
// each part keeps the kernel from that: staging an unaligned 3-channel
// halo, building a 147-deep operand in shared memory, or the products.
//
// Design.  The TPU kernel split the padded image by row parity and lane
// phase so its taps became one deep contraction for the 128-lane matrix
// unit; here a block stages the halo of its tile (8 x 16 outputs: 21 x 37
// input pixels) from the unpadded image with 4-byte cp.async (zero-filled
// outside the image: the padding; a pair of bf16 never straddles the image's
// edge, since a row holds an even number of elements), two tiles deep so the
// next tile's halo loads while this one is computed.  The patch operand A
// (128 pixels x 160, rows 336 bytes apart so an ldmatrix phase's eight rows
// fall in eight bank groups) is built from the halo: row p, k is a copy of
// halo element base(p) + off(k), each thread holding the offsets of its six
// k.  The weights (160 x 64, 20 KB) stay in shared memory for the block's
// life.  The products are bf16 mma.sync m16n8k16 from ldmatrix with f32
// accumulators, 8 warps as 4 (32 pixels) x 2 (32 channels); the epilogue
// rounds to bf16 into a shared y tile and writes it with 16-byte stores,
// each tile row 2 KB contiguous in y, masked at the ragged edge.  Blocks
// (two per SM) walk tiles in a loop.  A tile's phases (halo wait, operand,
// products, stores) run one after another; only an SM's two blocks overlap
// them, so the legs' times add up roughly as their parts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

enum Mode { LOAD = 0, STAGE = 1, PRODUCT = 2, FULL = 3 };

constexpr int THREADS = 256;
constexpr int C = 3, CO = 64, KS = 7;
constexpr int TAPS = KS * KS * C;              // 147
constexpr int KP = 160;                        // contraction padded to 16s
constexpr int TR = 8, TC = 16, PIX = TR * TC;  // output tile: 128 pixels
constexpr int HR = 2 * TR + KS - 2;            // 21 halo rows
constexpr int HC = 2 * TC + KS - 2;            // 37 halo pixels a row
// a halo row holds one bf16 before the first pixel, so its 4-byte words sit
// on even element offsets of the image row
constexpr int HROW = 1 + HC * C;               // 112 elements
constexpr int HWORDS = HROW / 2;               // 56
constexpr int HALO_BYTES = HR * HROW * 2;      // 4,704
constexpr int A_STRIDE = 168;                  // elements between A rows (336 B)
constexpr int A_BYTES = PIX * A_STRIDE * 2;    // 43,008
constexpr int W_CHUNKS = CO / 8;               // 16-byte chunks of a w or y row
constexpr int W_BYTES = KP * CO * 2;           // 20,480
constexpr int Y_BYTES = PIX * CO * 2;          // 16,384
constexpr int SMEM = 2 * HALO_BYTES + A_BYTES + W_BYTES + Y_BYTES;  // 89,280
constexpr int PAIRS = KP / 2;                  // 80 bf16 pairs of an A row
constexpr int PAIR_SLOTS = (PAIRS + 31) / 32;  // 3 a lane
// 8 warps as 4 (pixels) x 2 (channels): a warp owns 32 pixels by 32
// channels, two m-tiles of 16 by four n-tiles of 8
constexpr int WM = 32, WN = 32, MT = WM / 16, NT = WN / 8;
// Every per-tile loop has a trip count known at compile time, the same for
// every thread, so it unrolls and its shared-memory loads overlap: a pass
// over the tile's 128 pixels gives warp w the pixels w + 8 r (tile row
// r / 2, column w + 8 (r % 2)) and lane l the channel pair 2 l.
constexpr int WARPS = THREADS / 32;
constexpr int HALO_STEPS = (HR * HWORDS + THREADS - 1) / THREADS;  // 5
constexpr int PIXEL_STEPS = PIX / WARPS;                           // 16
constexpr int STORE_STEPS = PIX * W_CHUNKS / THREADS;              // 4
static_assert(TC == 2 * WARPS && CO == 64 && PIX * W_CHUNKS % THREADS == 0, "the pass layouts above");
static_assert(HROW % 2 == 0, "halo rows are whole 4-byte words");
static_assert(PIX == 4 * WM && CO == 2 * WN, "warps tile the pixels and channels");

// ------------------------------------------------------------------- the legs

struct Tile {
  int b, r0, c0;  // image, first output row and column
};

__device__ __forceinline__ Tile tile_at(long long t, int tiles_h, int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int b = (int)(t / per_image), rem = (int)(t % per_image);
  return {b, (rem / tiles_w) * TR, (rem % tiles_w) * TC};
}

// Start copying the halo of tile (b, r0, c0) into `dst`: input rows
// 2 r0 - 3 .. 2 r0 + 17 and pixels 2 c0 - 3 .. 2 c0 + 33, zeros outside the
// image.  Halo element (row hr, pixel pc, channel c) lands at
// hr * HROW + 1 + pc * 3 + c.
__device__ __forceinline__ void load_halo(uint32_t dst, const __nv_bfloat16* x, int h, int wd, Tile tile,
                                          int tid) {
  const int row_elems = wd * C;  // even, since W is
#pragma unroll
  for (int r = 0; r < HALO_STEPS; ++r) {
    const int i = tid + r * THREADS;
    if (i >= HR * HWORDS) break;
    const int hr = i / HWORDS, word = i % HWORDS;
    const int ih = 2 * tile.r0 - 3 + hr;
    const int g = (2 * tile.c0 - 3) * C - 1 + 2 * word;  // even element of the image row
    const bool in = ih >= 0 && ih < h && g >= 0 && g < row_elems;
    const __nv_bfloat16* src = in ? x + ((size_t)tile.b * h + ih) * row_elems + g : x;
    cp_async4(dst + (uint32_t)(hr * HROW + 2 * word) * 2u, src, in ? 4 : 0);
  }
}

// Build the patch operand: A[p][k] = halo[base(p) + off(k)] for k < 147,
// zero above.  base(p) = 0 for every row builds the window of the halo's
// first output pixel into each row (PRODUCT).  Warp w builds rows w + 8 r;
// lane l the pairs l, l + 32, l + 64 of each.
template <bool ONE_WINDOW>
__device__ __forceinline__ void build_operand(char* a_s, const uint16_t* halo, const int off[PAIR_SLOTS][2],
                                              int warp, int lane) {
#pragma unroll 4
  for (int r = 0; r < PIXEL_STEPS; ++r) {
    const int p = warp + WARPS * r;
    const int base = ONE_WINDOW ? 0 : 2 * (r / 2) * HROW + 2 * C * (warp + WARPS * (r % 2));
#pragma unroll
    for (int s = 0; s < PAIR_SLOTS; ++s) {
      const int m = lane + 32 * s;
      if (m < PAIRS) {
        const uint32_t lo = off[s][0] >= 0 ? halo[base + off[s][0]] : 0u;
        const uint32_t hi = off[s][1] >= 0 ? halo[base + off[s][1]] : 0u;
        *reinterpret_cast<uint32_t*>(a_s + (p * A_STRIDE + 2 * m) * 2) = lo | (hi << 16);
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
stem_variant_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, int b, int h, int wd,
                    __nv_bfloat16* __restrict__ y) {
  extern __shared__ __align__(128) char smem[];
  char* halo_s = smem;                        // two halos
  char* a_s = halo_s + 2 * HALO_BYTES;        // patch operand
  char* w_s = a_s + A_BYTES;                  // weights, [k][co] swizzled
  char* y_s = w_s + W_BYTES;                  // y tile, [pixel][co] swizzled
  const uint32_t halo_base = smem_addr(halo_s), a_base = smem_addr(a_s), w_base = smem_addr(w_s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ho = h / 2, wo = wd / 2;
  const int tiles_h = (ho + TR - 1) / TR, tiles_w = (wo + TC - 1) / TC;
  const long long tiles = (long long)b * tiles_h * tiles_w;
  const long long step = gridDim.x;
  constexpr bool PRODUCTS = MODE == PRODUCT || MODE == FULL;

  // this lane's operand offsets: k = 2m and 2m + 1 of its pairs m, -1 for
  // the zero padding
  int off[PAIR_SLOTS][2];
#pragma unroll
  for (int s = 0; s < PAIR_SLOTS; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * (lane + 32 * s) + e;
      off[s][e] = k < TAPS ? (k / (KS * C)) * HROW + 1 + k % (KS * C) : -1;
    }

  if (PRODUCTS) {
    // the weights, (147, 64) rows of 64 output channels, zero rows to 160
    const uint16_t* wsrc = reinterpret_cast<const uint16_t*>(w);
    for (int e = tid; e < KP * CO; e += THREADS) {
      const int k = e / CO, n = e % CO;
      *reinterpret_cast<uint16_t*>(w_s + swz(k, n >> 3) + (n & 7) * 2) = k < TAPS ? wsrc[e] : (uint16_t)0;
    }
  }

  long long t = blockIdx.x;
  if (MODE != PRODUCT && t < tiles) load_halo(halo_base, x, h, wd, tile_at(t, tiles_h, tiles_w), tid);
  cp_async_commit();
  int stage = 0, window_of = -1;
  for (; t < tiles; t += step, stage ^= 1) {
    const Tile tile = tile_at(t, tiles_h, tiles_w);
    const uint16_t* halo = reinterpret_cast<const uint16_t*>(halo_s + stage * HALO_BYTES);
    if (MODE != PRODUCT) {
      // the next tile's halo goes into the buffer the last tile read
      if (t + step < tiles)
        load_halo(halo_base + (stage ^ 1) * HALO_BYTES, x, h, wd, tile_at(t + step, tiles_h, tiles_w), tid);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    } else if (tile.b != window_of) {
      // the window of output pixel (0, 0) of this image, in every row of A
      halo = reinterpret_cast<const uint16_t*>(halo_s);
      load_halo(halo_base, x, h, wd, Tile{tile.b, 0, 0}, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      build_operand<true>(a_s, halo, off, warp, lane);
      __syncthreads();
      window_of = tile.b;
    }

    if (MODE == LOAD) {
      // y[p][co] = x[2i, 2j, co % 3]: halo row 2 pr + 3, pixel 2 pc + 3
      const int c_lo = (2 * lane) % C, c_hi = (2 * lane + 1) % C;
#pragma unroll
      for (int r = 0; r < PIXEL_STEPS; ++r) {
        const int pr = r / 2, pc = warp + WARPS * (r % 2);
        const int centre = (2 * pr + 3) * HROW + 1 + (2 * pc + 3) * C;
        stage_pair(y_s, warp + WARPS * r, 2 * lane,
                   (uint32_t)halo[centre + c_lo] | ((uint32_t)halo[centre + c_hi] << 16));
      }
    }
    if (MODE == STAGE || MODE == FULL) {
      build_operand<false>(a_s, halo, off, warp, lane);
      __syncthreads();
    }
    if (MODE == STAGE) {
      // y[p][co] = A[p][co], the operand's first 64 entries
#pragma unroll
      for (int r = 0; r < PIXEL_STEPS; ++r) {
        const int p = warp + WARPS * r;
        stage_pair(y_s, p, 2 * lane, *reinterpret_cast<const uint32_t*>(a_s + (p * A_STRIDE + 2 * lane) * 2));
      }
    }
    if (PRODUCTS) {
      const int wm = (warp >> 1) * WM, wn = (warp & 1) * WN, j8 = lane >> 3;
      float acc[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < KP; k0 += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int row = wm + i * 16 + (lane & 7) + (j8 & 1) * 8;
          ldmatrix_x4(a[i], a_base + (uint32_t)(row * A_STRIDE + k0 + (j8 >> 1) * 8) * 2u);
        }
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
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int p = wm + i * 16 + (lane >> 2), co = wn + j * 8 + (lane & 3) * 2;
          stage_pair(y_s, p, co, pack_bf16(acc[i][j][0], acc[i][j][1]));
          stage_pair(y_s, p + 8, co, pack_bf16(acc[i][j][2], acc[i][j][3]));
        }
    }
    __syncthreads();

    // the same stores in every leg: 16 bytes a thread, a tile row of 16
    // pixels 2 KB contiguous in y
#pragma unroll
    for (int r = 0; r < STORE_STEPS; ++r) {
      const int p = tid / W_CHUNKS + r * (THREADS / W_CHUNKS), ch = tid % W_CHUNKS;
      const int oh = tile.r0 + p / TC, ow = tile.c0 + p % TC;
      if (oh < ho && ow < wo)
        *reinterpret_cast<uint4*>(y + (((size_t)tile.b * ho + oh) * wo + ow) * CO + ch * 8) =
            *reinterpret_cast<const uint4*>(y_s + swz(p, ch));
    }
    __syncthreads();  // the y tile, the operand and this halo are free again
  }
  cp_async_wait<0>();
}

// Blocks of `kernel` that fit on the card at once; 0 or less is minus a
// cudaError_t.
template <typename Kernel>
long long resident_blocks(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

template <int MODE>
int launch(const void* x, const void* w, int b, int h, int wd, void* y, cudaStream_t stream) {
  const long long resident = resident_blocks(stem_variant_kernel<MODE>);
  if (resident <= 0) return (int)-resident;
  const long long tiles = (long long)b * ((h / 2 + TR - 1) / TR) * ((wd / 2 + TC - 1) / TC);
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  stem_variant_kernel<MODE><<<blocks, THREADS, SMEM, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                               static_cast<const __nv_bfloat16*>(w), b, h, wd,
                                                               static_cast<__nv_bfloat16*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 load, 1 stage, 2 product, 3 full.  x: (b, h, wd, 3) NHWC bf16,
// 4-byte aligned, h and wd even; w: (7, 7, 3, 64) HWIO bf16; y: (b, h/2,
// wd/2, 64) NHWC bf16.  One launch on `stream` without synchronising;
// returns the first cudaError_t that is not cudaSuccess.
int sihl_stem_variant(int mode, const void* x, const void* w, int b, int h, int wd, void* y, void* stream) {
  if (b < 1 || h < 2 || wd < 2 || h % 2 || wd % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case LOAD: return launch<LOAD>(x, w, b, h, wd, y, st);
    case STAGE: return launch<STAGE>(x, w, b, h, wd, y, st);
    case PRODUCT: return launch<PRODUCT>(x, w, b, h, wd, y, st);
    case FULL: return launch<FULL>(x, w, b, h, wd, y, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
