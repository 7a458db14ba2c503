// The flagship backbone's stage-1/2 convolutions as tensor-core GEMMs, for
// Hopper (sm_90a): the three conv probes of the JAX package's tools/.  bf16
// operands, f32 sums in mma.sync (m16n8k16) accumulators, operands staged in
// shared memory with cp.async and read into fragments with ldmatrix.  Every
// 16-byte chunk of a staged row sits at (chunk ^ (row & 7)), so the eight
// rows one ldmatrix phase reads fall in eight bank groups.
//
// matmul_stats_kernel (P4) replaces tools/probe_conv1x1_pallas.py:build_pallas
// (:79, kernel _mm_kernel :64): y = x w for x (M, 64) and w (64, 256) bf16,
// y (M, 256) bf16 rounded once from the f32 sum; with STATS, also BatchNorm's
// per-channel sum and sum of squares of y taken from the f32 accumulators
// before rounding.  Bound: at the probe's shape (M = 16 * 160 * 160) it reads
// 52.4 MB and writes 209.7 MB, 0.078 ms at 3.35 TB/s, against 13.4 GFLOP,
// 0.014 ms at 989 TFLOP/s: bytes.  Design: w (32 KB) stays in shared memory
// for the block's life; the block walks its 64-row tiles of x (one TPU grid
// step each) through a four-stage cp.async ring, so three tiles' reads are in
// flight while one is multiplied; y goes out through a shared-memory tile as
// 16-byte stores, a warp writing a whole 512-byte row.  The statistics need
// no atomics: each thread sums its columns over its rows and tiles, a fixed
// shuffle tree and a fixed pass over the warps make one (2, 256) partial per
// block, and sum_partials_kernel adds the partials in block order, so the
// sums are bitwise the same from call to call.
//
// weight_grad_kernel (P5) replaces tools/probe_wrt_filter.py:build_pallas
// (:78, kernel _acc_kernel :66): dW = x^T dy in f32 for x (M, ci) and
// dy (M, co) bf16, ci a multiple of 64 and co of 256.  Bound: bytes, reading
// x and dy once (0.078, 0.039 and 0.031 ms at the probe's three shapes; the
// products take 0.014-0.027 ms).  Design: the TPU carries one accumulator
// across its sequential row grid, which the card's blocks do not have.  A
// block owns a 64 x 256 tile of dW and one contiguous split of the rows,
// streams 64-row chunks of x and dy through a two-stage cp.async ring (A is
// x^T, read with ldmatrix.trans), keeps the tile's sums in registers and
// writes them as one partial; sum_partials_kernel sums the splits in a fixed
// order.  The split count gives about two blocks per SM.
//
// conv3x3_kernel (P2) replaces tools/probe_conv3x3_pallas.py:build_pallas
// (:89, kernel _conv_kernel :59): the stride-1 SAME 3x3 conv of x
// (B, H, W, 64) NHWC bf16 by w (3, 3, 64, 64) HWIO bf16, y NHWC bf16 rounded
// once from the f32 sum over the 9 taps and 64 channels.  Bound: 104.9 MB
// (0.031 ms at 3.35 TB/s) and 30.2 GFLOP (0.031 ms at 989 TFLOP/s) at
// batch 16, 160 x 160: balanced.  Design: the TPU probe fed pre-haloed row
// slabs because its BlockSpec blocks cannot overlap; here a block stages
// the 6 x 34 pixel halo of its 4 x 32 output tile from the unpadded input,
// zero-filling what lies outside the image (the SAME padding), and keeps
// all nine taps' weights (72 KB) in shared memory for its life, walking
// tiles in a loop.  Each warp owns one output row of the tile by 32
// channels and accumulates the 9 K = 64 products in registers; y goes out
// through shared memory as 16-byte stores, masked at the image's edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps in every product kernel
constexpr int REDUCE_THREADS = 256;

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros and reads
// nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16 x 16 bf16 A fragment, a 16 x 8 bf16 B fragment, f32 d.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a staged tile whose
// rows are `row_chunks` chunks long (a multiple of 8).
__device__ __forceinline__ uint32_t swz(int row, int chunk, int row_chunks) {
  return (uint32_t)(row * row_chunks + (chunk ^ (row & 7))) * 16u;
}

// A fragment (rows m0..m0+15, k0..k0+15) of a row-major [m][k] tile.
__device__ __forceinline__ void load_a(uint32_t a[4], uint32_t base, int m0, int k0, int row_chunks, int lane) {
  const int j = lane >> 3;
  ldmatrix_x4(a, base + swz(m0 + (lane & 7) + (j & 1) * 8, (k0 >> 3) + (j >> 1), row_chunks));
}

// A fragment (rows i0..i0+15, k0..k0+15) of A = T^T for a [k][i] tile T.
__device__ __forceinline__ void load_a_trans(uint32_t a[4], uint32_t base, int i0, int k0, int row_chunks,
                                             int lane) {
  const int j = lane >> 3;
  ldmatrix_x4_trans(a, base + swz(k0 + (lane & 7) + (j >> 1) * 8, (i0 >> 3) + (j & 1), row_chunks));
}

// B fragments of two n-tiles (k0..k0+15 by n0..n0+15) of a [k][n] tile:
// b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15.
__device__ __forceinline__ void load_b(uint32_t b[4], uint32_t base, int k0, int n0, int row_chunks, int lane) {
  const int j = lane >> 3;
  ldmatrix_x4_trans(b, base + swz(k0 + (lane & 7) + (j & 1) * 8, (n0 >> 3) + (j >> 1), row_chunks));
}

// Two bf16 values (4 bytes) at column col of row row of a staged tile.
__device__ __forceinline__ void stage_pair(char* tile, int row, int col, int row_chunks, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + swz(row, col >> 3, row_chunks) + (col & 7) * 2) = v;
}

// out[i] = sum over p of partials[p * n + i], p in order: one thread per
// output, so the sums are the same from call to call.
__global__ void __launch_bounds__(REDUCE_THREADS)
sum_partials_kernel(const float* __restrict__ partials, int parts, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= n) return;
  float total = 0.f;
  for (int p = 0; p < parts; ++p) total += partials[(size_t)p * n + i];
  out[i] = total;
}

int sum_partials(const float* partials, int parts, long long n, float* out, cudaStream_t stream) {
  sum_partials_kernel<<<(unsigned)((n + REDUCE_THREADS - 1) / REDUCE_THREADS), REDUCE_THREADS, 0, stream>>>(
      partials, parts, n, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- P4: matmul_stats

namespace p4 {

constexpr int K = 64, N = 256;      // x (M, 64) by w (64, 256)
constexpr int TM = 64;              // rows per tile
constexpr int STAGES = 4;           // x tiles in the ring
constexpr int X_CHUNKS = K / 8;     // 16-byte chunks of an x row: 8
constexpr int W_CHUNKS = N / 8;     // of a w or y row: 32
constexpr int W_BYTES = K * N * 2;  // 32 KB
constexpr int X_BYTES = TM * K * 2; // 8 KB a stage
constexpr int Y_BYTES = TM * N * 2; // 32 KB
constexpr int SMEM = W_BYTES + STAGES * X_BYTES + Y_BYTES;
// 8 warps as 2 (rows) x 4 (columns): a warp owns 32 rows x 64 columns, two
// m-tiles of 16 by eight n-tiles of 8.
constexpr int WM = 32, WN = 64, MT = WM / 16, NT = WN / 8;

__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* x, long long m, long long tile,
                                          int tid) {
  for (int c = tid; c < TM * X_CHUNKS; c += THREADS) {
    const int r = c / X_CHUNKS, ch = c % X_CHUNKS;
    const long long row = tile * TM + r;
    const bool in = row < m;
    cp_async16(dst + swz(r, ch, X_CHUNKS), in ? x + row * K + ch * 8 : x, in ? 16 : 0);
  }
}

template <bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
matmul_stats_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, long long m,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ partials) {
  extern __shared__ __align__(128) char smem[];
  char* w_s = smem;
  char* x_s = smem + W_BYTES;
  char* y_s = x_s + STAGES * X_BYTES;
  const uint32_t w_base = smem_addr(w_s), x_base = smem_addr(x_s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const long long tiles = (m + TM - 1) / TM;
  const long long first = blockIdx.x, step = gridDim.x;

  for (int c = tid; c < K * W_CHUNKS; c += THREADS) {
    const int r = c / W_CHUNKS, ch = c % W_CHUNKS;
    cp_async16(w_base + swz(r, ch, W_CHUNKS), w + r * N + ch * 8, 16);
  }
  // prologue: w and the first STAGES - 1 tiles, one commit group each
  for (int s = 0; s < STAGES - 1; ++s) {
    const long long t = first + s * step;
    if (t < tiles) load_tile(x_base + s * X_BYTES, x, m, t, tid);
    cp_async_commit();
  }

  float s1[NT][2], s2[NT][2];
  if (STATS) {
#pragma unroll
    for (int j = 0; j < NT; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
  }

  int stage = 0;
  for (long long t = first; t < tiles; t += step) {
    // refill the stage read STAGES - 1 tiles ago (freed by the last barrier)
    {
      const long long ahead = t + (STAGES - 1) * step;
      if (ahead < tiles) load_tile(x_base + ((stage + STAGES - 1) % STAGES) * X_BYTES, x, m, ahead, tid);
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    const uint32_t xt = x_base + stage * X_BYTES;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) load_a(a[i], xt, wm + i * 16, k0, X_CHUNKS, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        load_b(b, w_base, k0, wn + j * 8, W_CHUNKS, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }

    // epilogue: statistics from the f32 sums (rows past m are zeros), then
    // y rounded once into the staged tile
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* v = acc[i][j];
        if (STATS) {
          s1[j][0] += v[0] + v[2];
          s1[j][1] += v[1] + v[3];
          s2[j][0] += v[0] * v[0] + v[2] * v[2];
          s2[j][1] += v[1] * v[1] + v[3] * v[3];
        }
        const int row = wm + i * 16 + (lane >> 2), col = wn + j * 8 + (lane & 3) * 2;
        stage_pair(y_s, row, col, W_CHUNKS, pack_bf16(v[0], v[1]));
        stage_pair(y_s, row + 8, col, W_CHUNKS, pack_bf16(v[2], v[3]));
      }
    __syncthreads();
    for (int c = tid; c < TM * W_CHUNKS; c += THREADS) {
      const int r = c / W_CHUNKS, ch = c % W_CHUNKS;
      const long long row = t * TM + r;
      if (row < m)
        *reinterpret_cast<uint4*>(y + row * N + ch * 8) = *reinterpret_cast<const uint4*>(y_s + swz(r, ch, W_CHUNKS));
    }
    stage = (stage + 1) % STAGES;
  }
  cp_async_wait<0>();

  if (STATS) {
    // the 8 lanes of a column (lane >> 2 = 0..7) in a fixed tree, then the
    // two row-warps of a column in order
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[j][h] += __shfl_xor_sync(0xffffffffu, s1[j][h], off);
          s2[j][h] += __shfl_xor_sync(0xffffffffu, s2[j][h], off);
        }
    __syncthreads();  // the y tile is free
    float* red = reinterpret_cast<float*>(y_s);  // [row-warp][stat][N]
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = wn + j * 8 + lane * 2 + h;
          red[((warp >> 2) * 2 + 0) * N + col] = s1[j][h];
          red[((warp >> 2) * 2 + 1) * N + col] = s2[j][h];
        }
    }
    __syncthreads();
    for (int e = tid; e < 2 * N; e += THREADS)
      partials[(size_t)blockIdx.x * 2 * N + e] = red[e] + red[2 * N + e];
  }
}

template <bool STATS>
int launch(const void* x, const void* w, long long m, void* y, float* partials, float* sums, int blocks,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(matmul_stats_kernel<STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return (int)err;
  matmul_stats_kernel<STATS><<<blocks, THREADS, SMEM, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                                static_cast<const __nv_bfloat16*>(w), m,
                                                                static_cast<__nv_bfloat16*>(y), partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return STATS ? sum_partials(partials, blocks, 2 * N, sums, stream) : 0;
}

}  // namespace p4

// --------------------------------------------------------- P5: weight_grad_1x1

namespace p5 {

constexpr int TK = 64;               // rows of x and dy per chunk
constexpr int TI = 64, TO = 256;     // the block's tile of dW
constexpr int X_CHUNKS = TI / 8;     // 8
constexpr int D_CHUNKS = TO / 8;     // 32
constexpr int X_BYTES = TK * TI * 2; // 8 KB
constexpr int D_BYTES = TK * TO * 2; // 32 KB
constexpr int STAGE_BYTES = X_BYTES + D_BYTES;
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE_BYTES;
// 8 warps as 2 (ci) x 4 (co): a warp owns 32 x 64 of the tile
constexpr int WM = 32, WN = 64, MT = WM / 16, NT = WN / 8;

__device__ __forceinline__ void load_chunk(uint32_t dst, const __nv_bfloat16* x, const __nv_bfloat16* dy,
                                           long long m, int ci, int co, int i0, int o0, long long chunk,
                                           int tid) {
  for (int c = tid; c < TK * (X_CHUNKS + D_CHUNKS); c += THREADS) {
    const bool is_x = c < TK * X_CHUNKS;
    const int cc = is_x ? c : c - TK * X_CHUNKS;
    const int per_row = is_x ? X_CHUNKS : D_CHUNKS;
    const int r = cc / per_row, ch = cc % per_row;
    const long long row = chunk * TK + r;
    const bool in = row < m;
    const __nv_bfloat16* src = is_x ? x + row * ci + i0 + ch * 8 : dy + row * co + o0 + ch * 8;
    cp_async16(dst + (is_x ? 0 : X_BYTES) + swz(r, ch, per_row), in ? src : x, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
weight_grad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy, long long m, int ci,
                   int co, float* __restrict__ partials) {
  extern __shared__ __align__(128) char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const int i_tiles = ci / TI;
  const int i0 = (blockIdx.x % i_tiles) * TI, o0 = (blockIdx.x / i_tiles) * TO;
  const long long chunks = (m + TK - 1) / TK;
  const long long begin = chunks * blockIdx.y / gridDim.y, end = chunks * (blockIdx.y + 1) / gridDim.y;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (begin < end) load_chunk(base, x, dy, m, ci, co, i0, o0, begin, tid);
  cp_async_commit();
  int stage = 0;
  for (long long c = begin; c < end; ++c) {
    if (c + 1 < end) load_chunk(base + (stage ^ 1) * STAGE_BYTES, x, dy, m, ci, co, i0, o0, c + 1, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t xs = base + stage * STAGE_BYTES, ds = xs + X_BYTES;
#pragma unroll
    for (int k0 = 0; k0 < TK; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) load_a_trans(a[i], xs, wm + i * 16, k0, X_CHUNKS, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        load_b(b, ds, k0, wn + j * 8, D_CHUNKS, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled next
    stage ^= 1;
  }
  cp_async_wait<0>();

  float* out = partials + (size_t)blockIdx.y * ci * co;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = i0 + wm + i * 16 + (lane >> 2), col = o0 + wn + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(out + (size_t)row * co + col) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * co + col) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

}  // namespace p5

// ------------------------------------------------------------------ P2: conv3x3

namespace p2 {

constexpr int C = 64;                 // input and output channels
constexpr int TR = 4, TC = 32;        // output rows and columns per tile
constexpr int HR = TR + 2, HC = TC + 2;
constexpr int C_CHUNKS = C / 8;       // 8
constexpr int W_BYTES = 9 * C * C * 2;       // 72 KB
constexpr int SLAB_BYTES = HR * HC * C * 2;  // 25.5 KB, also the y tile (16 KB)
constexpr int SMEM = W_BYTES + SLAB_BYTES;
// 8 warps as 4 (output rows) x 2 (channel halves): a warp owns one output
// row of 32 pixels by 32 channels
constexpr int WN = 32, MT = TC / 16, NT = WN / 8;

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, int b, int h, int wd,
               __nv_bfloat16* __restrict__ y) {
  extern __shared__ __align__(128) char smem[];
  char* slab = smem + W_BYTES;
  const uint32_t w_base = smem_addr(smem), s_base = smem_addr(slab);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = warp >> 1, wn = (warp & 1) * WN;
  const int tiles_h = (h + TR - 1) / TR, tiles_w = (wd + TC - 1) / TC;
  const long long tiles = (long long)b * tiles_h * tiles_w;

  // the weights, (9 * 64) rows of 64 output channels; waited for with the first slab
  for (int c = tid; c < 9 * C * C_CHUNKS; c += THREADS)
    cp_async16(w_base + swz(c / C_CHUNKS, c % C_CHUNKS, C_CHUNKS), w + c * 8, 16);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int bi = (int)(t / (tiles_h * tiles_w)), rem = (int)(t % (tiles_h * tiles_w));
    const int r0 = (rem / tiles_w) * TR, c0 = (rem % tiles_w) * TC;
    for (int c = tid; c < HR * HC * C_CHUNKS; c += THREADS) {
      const int p = c / C_CHUNKS, ch = c % C_CHUNKS;
      const int ih = r0 - 1 + p / HC, iw = c0 - 1 + p % HC;
      const bool in = ih >= 0 && ih < h && iw >= 0 && iw < wd;
      const __nv_bfloat16* src = in ? x + (((size_t)bi * h + ih) * wd + iw) * C + ch * 8 : x;
      cp_async16(s_base + swz(p, ch, C_CHUNKS), src, in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    const int j8 = lane >> 3;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint32_t wt = w_base + (ky * 3 + kx) * C * C * 2;
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int p = (tr + ky) * HC + i * 16 + (lane & 7) + (j8 & 1) * 8 + kx;
            ldmatrix_x4(a[i], s_base + swz(p, (k0 >> 3) + (j8 >> 1), C_CHUNKS));
          }
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t bf[4];
            load_b(bf, wt, k0, wn + j * 8, C_CHUNKS, lane);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_bf16(acc[i][j], a[i], bf[0], bf[1]);
              mma_bf16(acc[i][j + 1], a[i], bf[2], bf[3]);
            }
          }
        }
      }
    __syncthreads();  // the slab is read; it now holds the y tile, pixel q = row * TC + column
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int q = tr * TC + i * 16 + (lane >> 2), col = wn + j * 8 + (lane & 3) * 2;
        stage_pair(slab, q, col, C_CHUNKS, pack_bf16(acc[i][j][0], acc[i][j][1]));
        stage_pair(slab, q + 8, col, C_CHUNKS, pack_bf16(acc[i][j][2], acc[i][j][3]));
      }
    __syncthreads();
    for (int c = tid; c < TR * TC * C_CHUNKS; c += THREADS) {
      const int q = c / C_CHUNKS, ch = c % C_CHUNKS;
      const int oh = r0 + q / TC, ow = c0 + q % TC;
      if (oh < h && ow < wd)
        *reinterpret_cast<uint4*>(y + (((size_t)bi * h + oh) * wd + ow) * C + ch * 8) =
            *reinterpret_cast<const uint4*>(slab + swz(q, ch, C_CHUNKS));
    }
    __syncthreads();  // the y tile is out; the next slab may land
  }
  cp_async_wait<0>();
}

}  // namespace p2

// Blocks of `kernel` that fit on the card at once (resident per SM times
// SMs), after allowing it `smem` bytes of dynamic shared memory; 0 or less
// is minus a cudaError_t.
template <typename Kernel>
long long resident_blocks(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

extern "C" {

// Blocks sihl_probe_matmul_stats runs for m rows: one per 64-row tile, at
// most as many as are resident at once (each walks its tiles in a loop);
// its statistics' scratch is (blocks, 2, 256) f32.  0 or less is minus a
// cudaError_t.
long long sihl_probe_matmul_blocks(long long m, int stats) {
  const long long resident = stats ? resident_blocks(p4::matmul_stats_kernel<true>, p4::SMEM)
                                   : resident_blocks(p4::matmul_stats_kernel<false>, p4::SMEM);
  if (resident <= 0) return resident;
  const long long tiles = (m + p4::TM - 1) / p4::TM;
  return tiles < resident ? tiles : resident;
}

// x: (m, 64) bf16; w: (64, 256) bf16; y: (m, 256) bf16; with stats,
// partials: (blocks, 2, 256) f32 scratch and sums: (2, 256) f32, the sum and
// the sum of squares of each column of y before rounding.  blocks from
// sihl_probe_matmul_blocks.  One launch (two with stats) on `stream`
// without synchronising; returns the first cudaError_t that is not
// cudaSuccess.
int sihl_probe_matmul_stats(int stats, const void* x, const void* w, long long m, void* y, float* partials,
                            float* sums, long long blocks, void* stream) {
  if (m < 1 || blocks < 1 || blocks > (m + p4::TM - 1) / p4::TM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stats ? p4::launch<true>(x, w, m, y, partials, sums, (int)blocks, st)
               : p4::launch<false>(x, w, m, y, nullptr, nullptr, (int)blocks, st);
}

// Row splits sihl_probe_weight_grad runs for these sizes (about as many
// blocks as are resident at once, at most one split per 64-row chunk); its
// scratch is (splits, ci, co) f32.  0 or less is minus a cudaError_t.
long long sihl_probe_weight_grad_splits(long long m, int ci, int co) {
  const long long resident = resident_blocks(p5::weight_grad_kernel, p5::SMEM);
  if (resident <= 0) return resident;
  const long long tiles = (long long)(ci / p5::TI) * (co / p5::TO), chunks = (m + p5::TK - 1) / p5::TK;
  long long splits = (resident + tiles - 1) / tiles;
  if (splits > chunks) splits = chunks;
  return splits < 1 ? 1 : splits;
}

// x: (m, ci) bf16, dy: (m, co) bf16, ci a multiple of 64 and co of 256;
// partials: (splits, ci, co) f32 scratch; dw: (ci, co) f32 = x^T dy.  Two
// launches on `stream` without synchronising; returns the first cudaError_t
// that is not cudaSuccess.
int sihl_probe_weight_grad(const void* x, const void* dy, long long m, int ci, int co, float* partials, float* dw,
                           long long splits, void* stream) {
  if (m < 1 || ci < p5::TI || co < p5::TO || ci % p5::TI || co % p5::TO || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(p5::weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p5::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ci / p5::TI) * (co / p5::TO), (unsigned)splits);
  p5::weight_grad_kernel<<<grid, THREADS, p5::SMEM, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                          static_cast<const __nv_bfloat16*>(dy), m, ci, co,
                                                          partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return sum_partials(partials, (int)splits, (long long)ci * co, dw, st);
}

// x: (b, h, wd, 64) NHWC bf16; w: (3, 3, 64, 64) HWIO bf16; y: (b, h, wd, 64)
// NHWC bf16, the stride-1 SAME conv.  One launch on `stream` without
// synchronising; returns the first cudaError_t that is not cudaSuccess.
int sihl_probe_conv3x3(const void* x, const void* w, int b, int h, int wd, void* y, void* stream) {
  if (b < 1 || h < 1 || wd < 1) return (int)cudaErrorInvalidValue;
  const long long resident = resident_blocks(p2::conv3x3_kernel, p2::SMEM);
  if (resident <= 0) return (int)-resident;
  const long long tiles = (long long)b * ((h + p2::TR - 1) / p2::TR) * ((wd + p2::TC - 1) / p2::TC);
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  p2::conv3x3_kernel<<<blocks, THREADS, p2::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), b, h, wd,
      static_cast<__nv_bfloat16*>(y));
  return (int)cudaGetLastError();
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
