// Per-row maximum and k-th largest distinct value, for Hopper (sm_90a).
//
// Replaces the TPU kernel sihl_tpu/ops/pallas/topk.py:_kernel (launched by
// _rows_pallas).  For a (G, A) matrix of anchor IoUs it returns, per row,
// the maximum and the value left after k-1 passes that each set every entry
// at or above the current maximum to -1: the k-th largest distinct value,
// the anchor matching's claim threshold.  Outputs are exact (max and
// compares only), so they are bitwise equal to the plain version.
//
// What bounds it on this card: one read of the matrix (G * A * 4 bytes) and
// 2 * G floats written; the k-1 passes cost no device-memory traffic
// because one block holds its whole row in shared memory (A = 8,525 at
// 640 px is 33 KiB) and runs every pass there.  Unfused, each pass is a
// separate read and write of the matrix.  The TPU kernel's zero padding of
// rows and columns to its (8, 128) tiles is not needed.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// max that keeps a NaN, as torch.max and jnp.max do
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// The block's max of v; every thread gets it.
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, offset));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is free (the previous call's readers are done)
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = max_nan(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(THREADS)
row_best_kth_kernel(const float* __restrict__ x, int a, int k, float* __restrict__ best,
                    float* __restrict__ kth) {
  extern __shared__ float row[];
  __shared__ float red[WARPS];
  const float* xr = x + (size_t)blockIdx.x * a;

  float v = -INFINITY;
  for (int i = threadIdx.x; i < a; i += THREADS) {
    const float t = xr[i];
    row[i] = t;
    v = max_nan(v, t);
  }
  float cur = block_max(v, red);
  if (threadIdx.x == 0) best[blockIdx.x] = cur;
  // each pass masks every entry >= the current max and takes the next max;
  // a thread rereads only the entries it wrote, so no barrier is needed
  for (int pass = 0; pass < k - 1; ++pass) {
    v = -INFINITY;
    for (int i = threadIdx.x; i < a; i += THREADS) {
      float t = row[i];
      if (t >= cur) {
        t = -1.f;
        row[i] = t;
      }
      v = max_nan(v, t);
    }
    cur = block_max(v, red);
  }
  if (threadIdx.x == 0) kth[blockIdx.x] = cur;
}

}  // namespace

extern "C" {

// Largest row length the kernel takes (the row must fit in shared memory).
int sihl_row_kth_max_cols() { return (227 * 1024 - 1024) / (int)sizeof(float); }

// x: (g, a) float, row-major, g >= 1, 1 <= a <= sihl_row_kth_max_cols(),
// k >= 1.  Writes best (g) and kth (g).  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch.
int sihl_row_best_kth(const float* x, int g, int a, int k, float* best, float* kth, void* stream) {
  const size_t smem = (size_t)a * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(row_best_kth_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_best_kth_kernel<<<g, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(x, a, k, best, kth);
  return (int)cudaGetLastError();
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
