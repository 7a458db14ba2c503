// The ResNet stem's 7x7 / stride 2 / pad 3 convolution of an image with up
// to 8 channels to 64 channels, with BatchNorm's batch statistics in the
// same pass (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel sihl_tpu/ops/pallas/stem.py:_stem_kernel (launched
// by stem_conv_stats).  Given x (B, H, W, C) in NHWC memory and the weights
// (7, 7, C, 64), it writes y (B, H/2, W/2, 64) in x's type, and the f32 sum
// and sum of squares over every position of each channel of y *after* y is
// rounded to its type: what BatchNorm's batch statistics reduce over.  Each
// output is a sum of 49 * C products in f32; bf16 operands are widened
// first, so their products are exact and only the sum rounds (the TPU kernel
// takes bf16 products into f32 on its matrix unit).
//
// What bounds it on this card.  At the training shape (16 images of
// 3 x 640 x 640 -> 16 x 64 x 320 x 320) the call moves 249 MB in bf16
// (0.074 ms at 3.35 TB/s) and does 15.4 G multiply-adds: 0.031 ms on the
// bf16 tensor cores, 0.46 ms as f32 FMAs.  This kernel does them as f32
// FMAs, so the FMA rate bounds it; moving the products to wgmma is later
// work.  The TPU kernel's design is not carried over: its parity and lane-
// phase split of the padded image (stem.py:13-31, :203-209) and its row
// tiling exist to turn the taps into a deep contraction for the 128-lane
// matrix unit.  Here:
//  - stem_conv_stats_kernel takes a tile of 8 output rows x 32 output
//    columns x 64 channels per block of 512 threads.  It stages the tile's
//    halo'd input (21 x 69 x C, zeros outside the image: the padding) and
//    all the weights (7 * 7 * C * 64 f32, 37.6 KB at C = 3) in shared
//    memory.  Each thread owns 8 neighbouring output columns of one row by
//    4 channels (32 accumulators); for each input channel and kernel row it
//    loads the 21 input values its 8 outputs x 7 taps read into registers
//    once, and each weight quad is one 16-byte shared-memory broadcast, so
//    about 8 FMAs run for each shared-memory load.
//  - The epilogue rounds each output to y's type, writes 4 channels with
//    one vector store, and sums the rounded values and their squares per
//    channel over the block's outputs, in a fixed order, into one partial
//    per block.  The ragged edge of the image is masked, so any even H and
//    W work.
//  - stem_stats_reduce_kernel sums the partials over blocks in a fixed
//    order (the TPU accumulates them across its sequential grid, which the
//    card's blocks do not have).  No atomics: the sums are bitwise the same
//    from call to call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Round four outputs to T, store them at p (4 consecutive channels), and
// return the rounded values in v.
__device__ __forceinline__ void round_store4(float* p, float v[4], bool valid) {
  if (valid) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void round_store4(bf16* p, float v[4], bool valid) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
  if (valid) {
    uint2 packed;
    packed.x = *reinterpret_cast<unsigned*>(&lo);
    packed.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = packed;
  }
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

// One block per (statistic, channel): the partials of every block summed in
// a fixed order (a strided pass, then a fixed tree).
__global__ void __launch_bounds__(REDUCE_THREADS)
stem_stats_reduce_kernel(const float* __restrict__ partials, int blocks, float* __restrict__ sum,
                         float* __restrict__ sumsq) {
  __shared__ float red[REDUCE_THREADS];
  const int entry = blockIdx.x;  // stat * 64 + channel
  float total = 0.f;
  for (int blk = threadIdx.x; blk < blocks; blk += REDUCE_THREADS) total += partials[(size_t)blk * 2 * CO + entry];
  red[threadIdx.x] = total;
  __syncthreads();
  for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) (entry < CO ? sum : sumsq)[entry % CO] = red[0];
}

template <typename T>
int launch(const void* x, int b, int h, int w, int c, const float* wk, void* y, float* partials, float* sum,
           float* sumsq, cudaStream_t stream) {
  const size_t smem = smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(stem_conv_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w / 2 + TC - 1) / TC, (h / 2 + TR - 1) / TR, b);
  stem_conv_stats_kernel<T><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), wk, h, w, c,
                                                             static_cast<T*>(y), partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stem_stats_reduce_kernel<<<2 * CO, REDUCE_THREADS, 0, stream>>>(partials, (int)(grid.x * grid.y * grid.z), sum,
                                                                    sumsq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest input the kernel takes (channels), and its output channels.
int sihl_stem_max_channels() { return MAX_C; }
int sihl_stem_out_channels() { return CO; }

// Floats of scratch sihl_stem_conv_stats needs for these sizes: one
// (2, 64) partial per block.
long long sihl_stem_workspace_floats(int b, int h, int w) {
  return (long long)((w / 2 + TC - 1) / TC) * ((h / 2 + TR - 1) / TR) * b * 2 * CO;
}

// x: (b, h, w, c) NHWC in bf16 (is_bf16) or f32, h and w even, 1 <= c <= 8;
// wk: (7, 7, c, 64) f32; y: (b, h/2, w/2, 64) in x's type; partials: the
// scratch of sihl_stem_workspace_floats; sum, sumsq: (64) f32.  Two
// launches on `stream` without synchronising; returns the first
// cudaError_t that is not cudaSuccess.
int sihl_stem_conv_stats(int is_bf16, const void* x, int b, int h, int w, int c, const float* wk, void* y,
                         float* partials, float* sum, float* sumsq, void* stream) {
  if (c < 1 || c > MAX_C || h % 2 || w % 2 || b < 1 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, b, h, w, c, wk, y, partials, sum, sumsq, st)
                 : launch<float>(x, b, h, w, c, wk, y, partials, sum, sumsq, st);
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
