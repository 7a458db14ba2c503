// Fused per-anchor MLP forward for Hopper (sm_90a).
//
// Replaces the TPU kernel sihl_tpu/ops/pallas/mlp.py:_fwd_kernel (launched
// by _fwd_pallas): one MLP of 4 x [Linear -> LayerNorm -> SiLU] hidden
// layers and a bare output Linear over a shared (M, 256) input.
//
// What bounds it on this card: the hidden matmuls, 2 * M * 256 * 256 FLOPs
// per layer, against M * 256 elements read once and M * n_out written.
// Unfused, every hidden activation makes several round trips through
// device memory; here a 64-row tile's activations stay in shared memory
// for all layers, so the kernel reads x once and writes only the outputs.
// One MLP's hidden weights (4 x 128 KiB in bf16) do not fit in shared memory
// beside the tile, so they stream from L2 in chunks, layer by layer.
//
// Two bodies share that layout:
//  * bf16: tensor-core products through nvcuda::wmma (16x16x16, f32
//    accumulators); each of the 8 warps owns a 16 x 128 slab of the
//    64 x 256 layer output.  The accumulators go through shared memory
//    (aliasing the weight chunk) to the LayerNorm step.
//  * f32: f32 FMAs from shared memory, an 8 x 8 register tile per thread
//    (tensor cores have no full-f32 mode).
// wgmma, TMA and overlapping the weight stream with the math are later work.
//
// Numerics follow _fwd_kernel: h is held at the compute type's precision
// between layers; y = h @ W accumulates in f32, plus the bias in f32;
// LayerNorm takes f32 mean and a two-pass variance (eps 1e-5) and applies
// its affine in f32; the result is cast to the compute type, SiLU is
// evaluated in f32 on that value and cast again.  The output layer adds
// its f32 bias to the f32 sum and casts once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 256;        // input and hidden width
constexpr int TILE_M = 64;    // rows per block
constexpr int THREADS = 256;  // 8 warps
constexpr float LN_EPS = 1e-5f;

// f32 body: activation tile stride padded so the output layer's per-row
// reads do not conflict; 32 weight rows staged per step.
constexpr int HS32 = D + 1;
constexpr int KC32 = 32;
constexpr size_t SMEM32 = (size_t)(TILE_M * HS32 + KC32 * D) * sizeof(float);

// bf16 body: strides padded by 16 bytes so wmma's row loads hit distinct
// banks; 128 weight rows staged per step; the f32 accumulator tile reuses
// the weight chunk's space once a layer's products are done.
constexpr int HB = D + 8;
constexpr int YS = D + 4;
constexpr int KCB = 128;
constexpr size_t TILE_BYTES = (size_t)TILE_M * HB * sizeof(bf16);
constexpr size_t CHUNK_BYTES = (size_t)KCB * HB * sizeof(bf16);
constexpr size_t ACC_BYTES = (size_t)TILE_M * YS * sizeof(float);
constexpr size_t SMEM16 = TILE_BYTES + (CHUNK_BYTES > ACC_BYTES ? CHUNK_BYTES : ACC_BYTES);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

// Round an f32 value to the compute type's precision and widen it back.
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// Thread (ty, tx) owns rows ty*8 .. ty*8+7 of the tile for LayerNorm and
// columns tx*4 .. tx*4+3 and 128+tx*4 .. 128+tx*4+3; one warp owns whole
// rows, so the LayerNorm reductions are warp shuffles.
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 128) + tx * 4 + (j & 3); }

// y (8 values of one row, bias not yet added) -> SiLU(LayerNorm(y + b)),
// rounded to T, written to the row of the activation tile.
template <typename T, typename H>
__device__ __forceinline__ void bias_norm_silu(float (&y)[8], int tx, const float* bias,
                                               const float* scale, const float* shift, H* hrow) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    y[j] += bias[col_of(tx, j)];
    s += y[j];
  }
  const float mu = warp_sum(s) * (1.f / D);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = y[j] - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) * (1.f / D) + LN_EPS);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col_of(tx, j);
    const float z = round_to((y[j] - mu) * rstd * scale[c] + shift[c], T());
    store(hrow + c, z * (1.f / (1.f + expf(-z))));
  }
}

// out[row0 + r, o] = h[r] . wo[:, o] + bo[o] for the tile's valid rows.
template <typename T, typename H, int STRIDE>
__device__ __forceinline__ void output_layer(const H* hs, int rows, int row0, const T* wo,
                                             const float* bo, int n_out, T* out) {
  for (int idx = threadIdx.x; idx < rows * n_out; idx += THREADS) {
    const int r = idx / n_out, o = idx % n_out;
    const H* hrow = hs + r * STRIDE;
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = fmaf(to_float(hrow[k]), to_float(wo[k * n_out + o]), s);
    store(out + (size_t)(row0 + r) * n_out + o, s + bo[o]);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
fused_mlp_fwd_f32_kernel(const float* __restrict__ x, int m,
                         const float* __restrict__ wh,  // (L, D, D) as [layer][in][out]
                         const float* __restrict__ bh,  // (L, D)
                         const float* __restrict__ sc,  // (L, D) LayerNorm scale
                         const float* __restrict__ bi,  // (L, D) LayerNorm bias
                         int num_layers,
                         const float* __restrict__ wo,  // (D, n_out) as [in][out]
                         const float* __restrict__ bo,  // (n_out)
                         int n_out,
                         float* __restrict__ out) {     // (m, n_out)
  extern __shared__ __align__(128) float smem[];
  float* hs = smem;                  // TILE_M x HS32 activation tile
  float* ws = smem + TILE_M * HS32;  // KC32 x D weight chunk

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.x * TILE_M;
  const int rows = min(TILE_M, m - row0);

  // Rows past m are zeros; they run through the layers and are never stored.
  for (int i = tid; i < TILE_M * D; i += THREADS) {
    const int r = i / D, c = i % D;
    hs[r * HS32 + c] = r < rows ? x[(size_t)(row0 + r) * D + c] : 0.f;
  }

  for (int l = 0; l < num_layers; ++l) {
    const float* w = wh + (size_t)l * D * D;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC32) {
      __syncthreads();  // the previous chunk is consumed and hs is written
      for (int i = tid; i < KC32 * D; i += THREADS) ws[i] = w[(size_t)k0 * D + i];
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC32; ++kk) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = hs[(ty * 8 + i) * HS32 + k0 + kk];
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk * D + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk * D + 128 + tx * 4]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // every warp has finished reading hs for this layer
#pragma unroll
    for (int i = 0; i < 8; ++i)
      bias_norm_silu<float>(acc[i], tx, bh + l * D, sc + l * D, bi + l * D, hs + (ty * 8 + i) * HS32);
  }
  __syncthreads();  // hs holds the last hidden layer
  output_layer<float, float, HS32>(hs, rows, row0, wo, bo, n_out, out);
}

__global__ void __launch_bounds__(THREADS, 2)
fused_mlp_fwd_bf16_kernel(const bf16* __restrict__ x, int m,
                          const bf16* __restrict__ wh,   // (L, D, D) as [layer][in][out]
                          const float* __restrict__ bh,  // (L, D)
                          const float* __restrict__ sc,  // (L, D) LayerNorm scale
                          const float* __restrict__ bi,  // (L, D) LayerNorm bias
                          int num_layers,
                          const bf16* __restrict__ wo,   // (D, n_out) as [in][out]
                          const float* __restrict__ bo,  // (n_out)
                          int n_out,
                          bf16* __restrict__ out) {      // (m, n_out)
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);               // TILE_M x HB activation tile
  bf16* ws = reinterpret_cast<bf16*>(smem_raw + TILE_BYTES);  // KCB x HB weight chunk
  float* ys = reinterpret_cast<float*>(smem_raw + TILE_BYTES);  // TILE_M x YS, aliases ws

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int slab_row = (ty & 3) * 16;    // this warp's 16 rows of the layer output
  const int slab_col = (ty >> 2) * 128;  // and its 128 columns
  const int row0 = blockIdx.x * TILE_M;
  const int rows = min(TILE_M, m - row0);
  constexpr int VEC = 8;  // bf16 per 16-byte copy

  // Rows past m are zeros; they run through the layers and are never stored.
  for (int i = tid; i < TILE_M * D / VEC; i += THREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(hs + r * HB + c) = v;
  }

  for (int l = 0; l < num_layers; ++l) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

    for (int k0 = 0; k0 < D; k0 += KCB) {
      __syncthreads();  // the chunk space is free (last chunk or ys read) and hs is written
      const bf16* w = wh + ((size_t)l * D + k0) * D;
      for (int i = tid; i < KCB * D / VEC; i += THREADS) {
        const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
        *reinterpret_cast<uint4*>(ws + r * HB + c) =
            *reinterpret_cast<const uint4*>(w + (size_t)r * D + c);
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < KCB; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, hs + slab_row * HB + k0 + kk, HB);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + kk * HB + slab_col + j * 16, HB);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();  // every warp is done with hs and the chunk space
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wmma::store_matrix_sync(ys + slab_row * YS + slab_col + j * 16, acc[j], YS, wmma::mem_row_major);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const float* yrow = ys + (ty * 8 + i) * YS;
      const float4 a0 = *reinterpret_cast<const float4*>(yrow + tx * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(yrow + 128 + tx * 4);
      float y[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      bias_norm_silu<bf16>(y, tx, bh + l * D, sc + l * D, bi + l * D, hs + (ty * 8 + i) * HB);
    }
  }
  __syncthreads();  // hs holds the last hidden layer
  output_layer<bf16, bf16, HB>(hs, rows, row0, wo, bo, n_out, out);
}

template <typename Kernel, typename T>
int launch(Kernel kernel, size_t smem, const void* x, int m, const void* wh, const float* bh,
           const float* sc, const float* bi, int num_layers, const void* wo, const float* bo,
           int n_out, void* out, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + TILE_M - 1) / TILE_M);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), m, static_cast<const T*>(wh),
                                          bh, sc, bi, num_layers, static_cast<const T*>(wo), bo,
                                          n_out, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The feature width the kernel is compiled for.
int sihl_fused_mlp_width() { return D; }

// One MLP over m rows; is_bf16 selects __nv_bfloat16 for x, the weights and
// out, else float.  Biases and LayerNorm parameters are float.  x and the
// hidden weights must be 16-byte aligned.  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch.
int sihl_fused_mlp_fwd(int is_bf16, const void* x, int m, const void* wh, const float* bh,
                       const float* sc, const float* bi, int num_layers, const void* wo,
                       const float* bo, int n_out, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<decltype(&fused_mlp_fwd_bf16_kernel), bf16>(
        fused_mlp_fwd_bf16_kernel, SMEM16, x, m, wh, bh, sc, bi, num_layers, wo, bo, n_out, out, s);
  return launch<decltype(&fused_mlp_fwd_f32_kernel), float>(
      fused_mlp_fwd_f32_kernel, SMEM32, x, m, wh, bh, sc, bi, num_layers, wo, bo, n_out, out, s);
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
