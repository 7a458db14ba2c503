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
// 2 * G floats written, 0.016 ms at 1,600 x 8,525.  Masking every entry in
// every pass would add three instructions an entry a pass (compare, select,
// max), about as long again at the SMs' issue rate.  So the k-1 passes must
// cost no memory traffic and little else.  One block takes a row and holds
// it in registers, V entries a thread (entry j * THREADS + tid), a template
// instance (THREADS, V) for each range of A (ops/topk.py:row_plan; padding
// entries read as -inf).  A thread keeps the max of its own entries; a pass
// masks only in the threads whose max is at or above the row's (the others
// hold no entry to mask, so their max stands), then reduces within the warp
// by shuffles and across warps through a double-buffered array of warp
// maxima: one __syncthreads a pass.  The TPU kernel's zero padding of rows
// and columns to its (8, 128) tiles is not needed.
//
// NaN: the first maximum keeps a NaN (max_nan, as torch.max and jnp.max
// do).  A row that holds one has NaN as its maximum; no entry is ever at or
// above NaN, so every pass leaves the row as it is and the k-th value is
// NaN too: the passes are skipped.  Otherwise the row holds no NaN, and the
// passes take plain maxima.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// max that keeps a NaN, as torch.max and jnp.max do
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

struct MaxNan {
  __device__ __forceinline__ float operator()(float a, float b) const { return max_nan(a, b); }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// The block's max of each thread's v, through warp shuffles and red[WARPS];
// every thread gets it.
template <int WARPS, typename Op>
__device__ __forceinline__ float block_max(float v, float* red, Op op) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, offset));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = op(m, red[w]);
  return m;
}

// The max of r[0, V), in four interleaved chains where registers allow.
template <int V, typename Op>
__device__ __forceinline__ float thread_max(const float (&r)[V], Op op) {
  constexpr int CHAINS = V > 40 ? 1 : 4;
  float m[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) m[c] = r[0];
#pragma unroll
  for (int j = 1; j < V; ++j) m[j % CHAINS] = op(m[j % CHAINS], r[j]);
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) m[0] = op(m[0], m[c]);
  return m[0];
}

template <int THREADS, int V>
__global__ void __launch_bounds__(THREADS)
row_best_kth_kernel(const float* __restrict__ x, int a, int k, float* __restrict__ best, float* __restrict__ kth) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[2][WARPS];  // pass p reduces through red[p % 2]
  const float* xr = x + (size_t)blockIdx.x * a + threadIdx.x;
  const int left = a - threadIdx.x;  // entry j * THREADS + tid is in the row iff j * THREADS < left
  float r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) r[j] = j * THREADS < left ? __ldg(xr + j * THREADS) : -INFINITY;
  float own = thread_max(r, MaxNan());  // the max of this thread's entries
  float cur = block_max<WARPS>(own, red[0], MaxNan());
  if (threadIdx.x == 0) best[blockIdx.x] = cur;
  if (cur == cur) {
    for (int pass = 1; pass < k; ++pass) {
      if (own >= cur) {  // only a thread that holds an entry at or above the max has one to mask
#pragma unroll
        for (int j = 0; j < V; ++j) r[j] = r[j] >= cur ? -1.f : r[j];
        own = thread_max(r, Max());
      }
      cur = block_max<WARPS>(own, red[pass % 2], Max());
    }
  }
  if (threadIdx.x == 0) kth[blockIdx.x] = cur;
}

template <int THREADS, int V>
int launch(const float* x, int g, int a, int k, float* best, float* kth, cudaStream_t stream) {
  row_best_kth_kernel<THREADS, V><<<g, THREADS, 0, stream>>>(x, a, k, best, kth);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest row length the kernel takes: its widest instance, 1024 x 57.
int sihl_row_kth_max_cols() { return 1024 * 57; }

// x: (g, a) float, row-major, g >= 1, 1 <= a <= threads * values, k >= 1,
// (threads, values) one of the kernel's instances (ops/topk.py:ROW_PLANS).
// Writes best (g) and kth (g).  Launches on `stream` without synchronising
// and returns the cudaError_t of the launch.
int sihl_row_best_kth(const float* x, int g, int a, int k, int threads, int values, float* best, float* kth,
                      void* stream) {
  if (a < 1 || a > threads * values || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads == 256 && values == 8) return launch<256, 8>(x, g, a, k, best, kth, st);
  if (threads == 128 && values == 67) return launch<128, 67>(x, g, a, k, best, kth, st);
  if (threads == 512 && values == 40) return launch<512, 40>(x, g, a, k, best, kth, st);
  if (threads == 1024 && values == 57) return launch<1024, 57>(x, g, a, k, best, kth, st);
  return (int)cudaErrorInvalidValue;
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
