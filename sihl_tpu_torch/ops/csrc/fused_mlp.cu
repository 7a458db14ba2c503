// Fused per-anchor MLP, forward (K1f) and backward (K1b), for Hopper (sm_90a).
//
// Replaces the TPU kernels of sihl_tpu/ops/pallas/mlp.py: _fwd_kernel
// (launched by _fwd_pallas) and _bwd_kernel (launched by _bwd_pallas).  One
// MLP is 4 x [Linear -> LayerNorm -> SiLU] hidden layers and a bare output
// Linear over a shared (M, 256) input.
//
// What bounds it on this card: the hidden matmuls, 2 * M * 256 * 256 FLOPs
// per layer (three times that in the backward: recompute, dx and dW),
// against M * 256 elements read once and M * n_out written.  Unfused, every
// hidden activation makes several round trips through device memory; here a
// 64-row tile's activations stay in shared memory for all layers.  One MLP's
// hidden weights (4 x 128 KiB in bf16) do not fit in shared memory beside
// the tile, so they stream from L2 in chunks, layer by layer.
//
// Two bodies share that layout:
//  * bf16: tensor-core products through nvcuda::wmma (16x16x16, f32
//    accumulators); each of the 8 warps owns a 16 x 128 slab of the
//    64 x 256 layer output.  The accumulators go through shared memory
//    (aliasing the weight chunk) to the row-wise LayerNorm step.
//  * f32: f32 FMAs from shared memory, an 8 x 8 register tile per thread
//    (tensor cores have no full-f32 mode).
// wgmma, TMA and overlapping the weight stream with the math are later work.
//
// Forward numerics follow _fwd_kernel: h is held at the compute type's
// precision between layers; y = h @ W accumulates in f32, plus the bias in
// f32; LayerNorm takes f32 mean and a two-pass variance (eps 1e-5) and
// applies its affine in f32; the result is cast to the compute type, SiLU
// is evaluated in f32 on that value and cast again.  The output layer adds
// its f32 bias to the f32 sum and casts once.
//
// Backward.  The TPU kernel sums the weight gradients over a sequential grid
// in VMEM; here blocks run at once and one MLP's weight gradient (1 MiB in
// f32) does not fit in a block, so the backward is a tile kernel plus a
// split-M weight-gradient kernel, both hand-written:
//  1. fused_mlp_bwd_tile_kernel, per 64-row tile: recomputes the hidden
//     layers, stashing each layer's input h, z = LN affine output, the
//     normalised n (in the compute type, as _bwd_kernel stashes n in bf16)
//     and the row's 1/std in device memory; then backpropagates through
//     SiLU, LayerNorm and the Linears, with dh = dy @ W^T as a tile product
//     like the forward's (dy rounded to the compute type, as _bwd_kernel
//     does), stashing dy.  Column sums over the tile's rows (dscale = sum
//     dz * n, dshift = sum dz, dbias = sum dy, dbo = sum g) go to per-tile
//     partials; dx (f32, summed over the MLPs of a call through dx_in /
//     dx_acc) is written in the compute type by the last MLP.
//  2. dW_l = h_l^T dy_l over chunks of rows (split M): wmma in bf16, FMAs
//     in f32, and FMAs for the narrow output layer (h^T g); each chunk
//     writes its own partial.
//  3. reduce_partials_kernel sums every set of partials in a fixed order,
//     so the gradients are deterministic.

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

// backward, f32 body: the tile, the weight chunk and a separate f32 result tile
constexpr size_t HS32_BYTES = (size_t)TILE_M * HS32 * sizeof(float);
constexpr size_t WS32_BYTES = (size_t)KC32 * D * sizeof(float);
constexpr size_t SMEM32_BWD = HS32_BYTES + WS32_BYTES + ACC_BYTES;

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

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// Thread (ty, tx) owns rows ty*8 .. ty*8+7 of the tile for the row-wise
// steps and columns tx*4 .. tx*4+3 and 128+tx*4 .. 128+tx*4+3; one warp owns
// whole rows, so the LayerNorm reductions are warp shuffles.
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 128) + tx * 4 + (j & 3); }

// The 8 values of one row that thread tx owns in an f32 tile of stride YS.
__device__ __forceinline__ void read_row(const float* yrow, int tx, float (&y)[8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(yrow + tx * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(yrow + 128 + tx * 4);
  y[0] = a0.x; y[1] = a0.y; y[2] = a0.z; y[3] = a0.w;
  y[4] = a1.x; y[5] = a1.y; y[6] = a1.z; y[7] = a1.w;
}

// y (8 values of one row, bias not yet added) -> z = LN(y + b) * scale +
// shift rounded to T, n = the normalised value, and the row's 1/std.
template <typename T>
__device__ __forceinline__ float layer_norm(float (&y)[8], int tx, const float* bias,
                                            const float* scale, const float* shift, float (&z)[8],
                                            float (&n)[8]) {
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
    n[j] = (y[j] - mu) * rstd;
    z[j] = round_to(n[j] * scale[c] + shift[c], T());
  }
  return rstd;
}

// y (8 values of one row, bias not yet added) -> SiLU(LayerNorm(y + b)),
// rounded to T, written to the row of the activation tile.
template <typename T, typename H>
__device__ __forceinline__ void bias_norm_silu(float (&y)[8], int tx, const float* bias,
                                               const float* scale, const float* shift, H* hrow) {
  float z[8], n[8];
  layer_norm<T>(y, tx, bias, scale, shift, z, n);
#pragma unroll
  for (int j = 0; j < 8; ++j) store(hrow + col_of(tx, j), z[j] * sigmoid(z[j]));
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

// acc = hs (TILE_M x D f32, stride HS32) . w (D x D, [k][n], global) with
// FMAs, thread (ty, tx) holding rows ty*8+i and columns col_of(tx, j).
// Starts with a barrier (hs is written, ws is free) and ends with one (every
// warp is done reading hs and ws).
__device__ __forceinline__ void tile_product_f32(const float* hs, const float* __restrict__ w,
                                                 float* ws, float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
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
  __syncthreads();  // every warp has finished reading hs and ws
}

// ys (TILE_M x YS f32, aliasing the chunk space ws) = hs (TILE_M x HB bf16)
// . w (D x D, [k][n], global) on tensor cores.  Starts with a barrier (hs is
// written, the chunk space is free) and ends with one (ys is complete).
__device__ __forceinline__ void tile_product_bf16(const bf16* hs, const bf16* __restrict__ w,
                                                  bf16* ws, float* ys) {
  namespace wmma = nvcuda::wmma;
  const int tid = threadIdx.x, ty = tid >> 5;
  const int slab_row = (ty & 3) * 16;    // this warp's 16 rows of the output
  const int slab_col = (ty >> 2) * 128;  // and its 128 columns
  constexpr int VEC = 8;                 // bf16 per 16-byte copy
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < D; k0 += KCB) {
    __syncthreads();  // the chunk space is free (last chunk or ys read) and hs is written
    const bf16* wk = w + (size_t)k0 * D;
    for (int i = tid; i < KCB * D / VEC; i += THREADS) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      *reinterpret_cast<uint4*>(ws + r * HB + c) =
          *reinterpret_cast<const uint4*>(wk + (size_t)r * D + c);
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
}

// Load rows row0 .. row0+rows-1 of x (m x D) into the tile; rows past m are zeros.
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int row0, int rows, float* hs) {
  for (int i = threadIdx.x; i < TILE_M * D; i += THREADS) {
    const int r = i / D, c = i % D;
    hs[r * HS32 + c] = r < rows ? x[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

__device__ __forceinline__ void load_tile(const bf16* __restrict__ x, int row0, int rows, bf16* hs) {
  constexpr int VEC = 8;
  for (int i = threadIdx.x; i < TILE_M * D / VEC; i += THREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(hs + r * HB + c) = v;
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

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TILE_M;
  const int rows = min(TILE_M, m - row0);
  load_tile(x, row0, rows, hs);

  for (int l = 0; l < num_layers; ++l) {
    float acc[8][8];
    tile_product_f32(hs, wh + (size_t)l * D * D, ws, acc);
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
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);               // TILE_M x HB activation tile
  bf16* ws = reinterpret_cast<bf16*>(smem_raw + TILE_BYTES);  // KCB x HB weight chunk
  float* ys = reinterpret_cast<float*>(smem_raw + TILE_BYTES);  // TILE_M x YS, aliases ws

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TILE_M;
  const int rows = min(TILE_M, m - row0);
  load_tile(x, row0, rows, hs);

  for (int l = 0; l < num_layers; ++l) {
    tile_product_bf16(hs, wh + (size_t)l * D * D, ws, ys);
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      float y[8];
      read_row(ys + (ty * 8 + i) * YS, tx, y);
      bias_norm_silu<bf16>(y, tx, bh + l * D, sc + l * D, bi + l * D, hs + (ty * 8 + i) * HB);
    }
  }
  __syncthreads();  // hs holds the last hidden layer
  output_layer<bf16, bf16, HB>(hs, rows, row0, wo, bo, n_out, out);
}

// -- backward ------------------------------------------------------------------

// Shared-memory layout of the backward tile kernel per compute type: the
// activation tile hs (the A operand of every product), and ys, the f32
// result of the last tile product, read row by row.
template <typename T> struct BwdTile;

template <> struct BwdTile<bf16> {
  static constexpr int STRIDE = HB;
  static constexpr size_t BYTES = SMEM16;
  __device__ static bf16* hs(unsigned char* s) { return reinterpret_cast<bf16*>(s); }
  __device__ static float* ys(unsigned char* s) { return reinterpret_cast<float*>(s + TILE_BYTES); }
  __device__ static void product(unsigned char* s, const bf16* w) {
    tile_product_bf16(hs(s), w, reinterpret_cast<bf16*>(s + TILE_BYTES), ys(s));
  }
};

template <> struct BwdTile<float> {
  static constexpr int STRIDE = HS32;
  static constexpr size_t BYTES = SMEM32_BWD;
  __device__ static float* hs(unsigned char* s) { return reinterpret_cast<float*>(s); }
  __device__ static float* ys(unsigned char* s) {
    return reinterpret_cast<float*>(s + HS32_BYTES + WS32_BYTES);
  }
  __device__ static void product(unsigned char* s, const float* w) {
    float acc[8][8];
    tile_product_f32(hs(s), w, reinterpret_cast<float*>(s + HS32_BYTES), acc);
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float* y = ys(s);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) y[(ty * 8 + i) * YS + col_of(tx, j)] = acc[i][j];
    __syncthreads();
  }
};

// Per tile: recompute the hidden layers (stashing h, z, n and 1/std), then
// backpropagate to dx, stashing dy and writing per-tile column sums.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_bwd_tile_kernel(const T* __restrict__ x, int m,
                          const T* __restrict__ wh,      // (L, D, D) as [layer][in][out]
                          const T* __restrict__ wht,     // (L, D, D) as [layer][out][in]
                          const float* __restrict__ bh,  // (L, D)
                          const float* __restrict__ sc,  // (L, D) LayerNorm scale
                          const float* __restrict__ bi,  // (L, D) LayerNorm bias
                          int num_layers,
                          const T* __restrict__ wo,      // (D, n_out) as [in][out]
                          int n_out,
                          const T* __restrict__ g,       // (m, n_out) output cotangent
                          T* __restrict__ h_stash,       // (L, m, D) output of hidden layer l
                          T* __restrict__ z_stash,       // (L, m, D)
                          T* __restrict__ n_stash,       // (L, m, D)
                          float* __restrict__ r_stash,   // (L, m)
                          T* __restrict__ dy_stash,      // (L, m, D)
                          float* __restrict__ col_part,  // (tiles, L, 3, D): sum dz*n, dz, dy
                          float* __restrict__ bo_part,   // (tiles, n_out): sum g
                          const float* dx_in,            // (m, D) f32 or null
                          float* dx_acc,                 // (m, D) f32 or null
                          T* __restrict__ dx_out) {      // (m, D) or null
  using Tile = BwdTile<T>;
  constexpr int S = Tile::STRIDE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* hs = Tile::hs(smem_raw);
  float* ys = Tile::ys(smem_raw);

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.x * TILE_M;
  const int rows = min(TILE_M, m - row0);
  load_tile(x, row0, rows, hs);

  // forward recompute
  for (int l = 0; l < num_layers; ++l) {
    Tile::product(smem_raw, wh + (size_t)l * D * D);
    const size_t base = (size_t)l * m * D;
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      float y[8], z[8], n[8];
      read_row(ys + r * YS, tx, y);
      const float rstd = layer_norm<T>(y, tx, bh + l * D, sc + l * D, bi + l * D, z, n);
      const size_t off = base + (size_t)(row0 + r) * D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col_of(tx, j);
        const float h = round_to(z[j] * sigmoid(z[j]), T());
        store(hs + r * S + c, h);
        if (r < rows) {
          store(h_stash + off + c, h);
          store(z_stash + off + c, z[j]);
          store(n_stash + off + c, n[j]);
        }
      }
      if (r < rows && tx == 0) r_stash[(size_t)l * m + row0 + r] = rstd;
    }
  }

  __syncthreads();  // the stash (1/std is written by one lane per row) is visible to the block

  // the tile's sum of g (the output bias gradient)
  for (int o = tid; o < n_out; o += THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += to_float(g[(size_t)(row0 + r) * n_out + o]);
    bo_part[(size_t)blockIdx.x * n_out + o] = s;
  }

  for (int l = num_layers - 1; l >= 0; --l) {
    float dsc[8], dbi[8], dbh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dsc[j] = dbi[j] = dbh[j] = 0.f;
    const size_t base = (size_t)l * m * D;
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      const bool valid = r < rows;
      float dh[8], zf[8], nf[8];
      if (l == num_layers - 1) {  // the output layer: dh = g . wo^T
#pragma unroll
        for (int j = 0; j < 8; ++j) dh[j] = 0.f;
        if (valid) {
          const T* grow = g + (size_t)(row0 + r) * n_out;
          for (int o = 0; o < n_out; ++o) {
            const float gv = to_float(grow[o]);
#pragma unroll
            for (int j = 0; j < 8; ++j) dh[j] = fmaf(gv, to_float(wo[col_of(tx, j) * n_out + o]), dh[j]);
          }
        }
      } else {
        read_row(ys + r * YS, tx, dh);
      }
      float rstd = 0.f;
      const size_t off = base + (size_t)(row0 + r) * D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col_of(tx, j);
        zf[j] = valid ? to_float(z_stash[off + c]) : 0.f;
        nf[j] = valid ? to_float(n_stash[off + c]) : 0.f;
      }
      if (valid) rstd = r_stash[(size_t)l * m + row0 + r];
      float dn[8], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sig = sigmoid(zf[j]);
        const float dz = valid ? dh[j] * (sig * (1.f + zf[j] * (1.f - sig))) : 0.f;
        dsc[j] += dz * nf[j];
        dbi[j] += dz;
        dn[j] = dz * sc[l * D + col_of(tx, j)];
        s1 += dn[j];
        s2 += dn[j] * nf[j];
      }
      const float mean_dn = warp_sum(s1) * (1.f / D);
      const float mean_dnn = warp_sum(s2) * (1.f / D);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col_of(tx, j);
        const float dy = rstd * (dn[j] - mean_dn - nf[j] * mean_dnn);
        dbh[j] += dy;
        store(hs + r * S + c, dy);  // rounded to T: the A operand of dh = dy . W^T
        if (valid) store(dy_stash + off + c, dy);
      }
    }
    // the tile's column sums, warp partials summed in a fixed order
    __syncthreads();  // every warp is done reading ys
    float* red = ys;  // 3 x 8 x D
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col_of(tx, j);
      red[(0 * 8 + ty) * D + c] = dsc[j];
      red[(1 * 8 + ty) * D + c] = dbi[j];
      red[(2 * 8 + ty) * D + c] = dbh[j];
    }
    __syncthreads();
    for (int idx = tid; idx < 3 * D; idx += THREADS) {
      const int q = idx / D, c = idx % D;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[(q * 8 + w) * D + c];
      col_part[(((size_t)blockIdx.x * num_layers + l) * 3 + q) * D + c] = s;
    }
    Tile::product(smem_raw, wht + (size_t)l * D * D);  // dh of the layer below, or dx
  }

  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= rows) continue;
    float v[8];
    read_row(ys + r * YS, tx, v);
    const size_t off = (size_t)(row0 + r) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col_of(tx, j);
      float s = v[j];
      if (dx_in) s += dx_in[off + c];
      if (dx_acc) dx_acc[off + c] = s;
      if (dx_out) store(dx_out + off + c, s);
    }
  }
}

// part[s][l][i][j] = sum over rows k of chunk s of a_l[k][i] * b_l[k][j],
// with a_0 = a_first, a_l = a_rest + (l-1) * m * D and b_l = b + l * m * D:
// the hidden layers' weight gradients h_l^T dy_l on tensor cores.  A block
// computes 64 x 256 outputs of one layer (4 blocks per layer) over one chunk.
constexpr int DW_K = 64;             // rows staged per step
constexpr int DW_LDA = 64 + 8;       // a stage: DW_K x 64, [k][i]
constexpr int DW_LDB = D + 8;        // b stage: DW_K x D, [k][j]
constexpr size_t DW_SMEM = (size_t)DW_K * (DW_LDA + DW_LDB) * sizeof(bf16);

__global__ void __launch_bounds__(THREADS)
dw_bf16_kernel(const bf16* __restrict__ a_first, const bf16* __restrict__ a_rest,
               const bf16* __restrict__ b, int m, int chunk, float* __restrict__ part) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);
  bf16* bs = as + DW_K * DW_LDA;
  const int tid = threadIdx.x, ty = tid >> 5;
  const int i0 = blockIdx.x * 64, l = blockIdx.y, s = blockIdx.z;
  const int num_layers = gridDim.y;
  const bf16* a = l == 0 ? a_first : a_rest + (size_t)(l - 1) * m * D;
  const bf16* bl = b + (size_t)l * m * D;
  const int k_begin = s * chunk, k_end = min(m, k_begin + chunk);
  const int slab_row = (ty & 3) * 16, slab_col = (ty >> 2) * 128;
  constexpr int VEC = 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += DW_K) {
    __syncthreads();  // the previous stage is consumed
    for (int idx = tid; idx < DW_K * 64 / VEC; idx += THREADS) {
      const int r = idx / (64 / VEC), c = (idx % (64 / VEC)) * VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k_end) v = *reinterpret_cast<const uint4*>(a + (size_t)(k0 + r) * D + i0 + c);
      *reinterpret_cast<uint4*>(as + r * DW_LDA + c) = v;
    }
    for (int idx = tid; idx < DW_K * D / VEC; idx += THREADS) {
      const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < k_end) v = *reinterpret_cast<const uint4*>(bl + (size_t)(k0 + r) * D + c);
      *reinterpret_cast<uint4*>(bs + r * DW_LDB + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DW_K; kk += 16) {
      // a^T: element (i, k) sits at as[k][i], a column-major 16 x 16 tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, as + kk * DW_LDA + slab_row, DW_LDA);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + kk * DW_LDB + slab_col + j * 16, DW_LDB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  float* out = part + (((size_t)s * num_layers + l) * D + i0 + slab_row) * D + slab_col;
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::store_matrix_sync(out + j * 16, acc[j], D, wmma::mem_row_major);
}

// The same partial sums with FMAs, for f32 and for narrow b (the output
// layer's h^T g): part[s][l][i][j] for i < D, j < nb; b_l = b + l * m * nb.
// A block computes 64 x 64 outputs; thread (tid / 16, tid % 16) holds 4 x 4.
constexpr int DWF_K = 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_fma_kernel(const T* __restrict__ a_first, const T* __restrict__ a_rest,
              const T* __restrict__ b, int nb, int m, int chunk, int num_layers,
              float* __restrict__ part) {
  __shared__ __align__(16) float as[DWF_K][64];
  __shared__ __align__(16) float bs[DWF_K][64];
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * 64;
  const int l = blockIdx.z % num_layers, s = blockIdx.z / num_layers;
  const T* a = l == 0 ? a_first : a_rest + (size_t)(l - 1) * m * D;
  const T* bl = b + (size_t)l * m * nb;
  const int k_begin = s * chunk, k_end = min(m, k_begin + chunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += DWF_K) {
    __syncthreads();
    for (int idx = tid; idx < DWF_K * 64; idx += THREADS) {
      const int r = idx / 64, c = idx % 64;
      const bool in = k0 + r < k_end;
      as[r][c] = in ? to_float(a[(size_t)(k0 + r) * D + i0 + c]) : 0.f;
      bs[r][c] = in && j0 + c < nb ? to_float(bl[(size_t)(k0 + r) * nb + j0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < DWF_K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&as[k][ti * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tj * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  float* out = part + ((size_t)s * num_layers + l) * D * nb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tj * 4 + j;
      if (c < nb) out[(size_t)(i0 + ti * 4 + i) * nb + c] = acc[i][j];
    }
}

// out[i] = sum over s < num_parts of part[s * n + i], in order of s.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int num_parts, int n,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < num_parts; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
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

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

// Rows per chunk of the split-M weight-gradient kernels: at most 16 chunks,
// each a multiple of 64 rows.
int dw_chunk(int m) {
  const int c = (m + 15) / 16;
  return c < 64 ? 64 : (c + 63) / 64 * 64;
}

// The backward's scratch, carved from one workspace in this order.
struct BwdWorkspace {
  void* h;
  void* z;
  void* n;
  void* dy;
  float* r;
  float* col_part;
  float* bo_part;
  float* dw_part;
  float* dwo_part;
  size_t bytes;

  BwdWorkspace(char* base, size_t elem, int m, int num_layers, int n_out) {
    const int tiles = (m + TILE_M - 1) / TILE_M;
    const int chunks = (m + dw_chunk(m) - 1) / dw_chunk(m);
    const size_t stash = align_up((size_t)num_layers * m * D * elem);
    size_t off = 0;
    auto take = [&](size_t len) {
      char* p = base ? base + off : nullptr;
      off += align_up(len);
      return p;
    };
    h = take(stash);
    z = take(stash);
    n = take(stash);
    dy = take(stash);
    r = reinterpret_cast<float*>(take((size_t)num_layers * m * sizeof(float)));
    col_part = reinterpret_cast<float*>(take((size_t)tiles * num_layers * 3 * D * sizeof(float)));
    bo_part = reinterpret_cast<float*>(take((size_t)tiles * n_out * sizeof(float)));
    dw_part = reinterpret_cast<float*>(take((size_t)chunks * num_layers * D * D * sizeof(float)));
    dwo_part = reinterpret_cast<float*>(take((size_t)chunks * D * n_out * sizeof(float)));
    bytes = off;
  }
};

int reduce_parts(const float* part, int num_parts, int n, float* out, cudaStream_t stream) {
  reduce_partials_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(part, num_parts, n, out);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* x_, int m, const void* wh_, const void* wht_, const float* bh,
             const float* sc, const float* bi, int num_layers, const void* wo_, int n_out,
             const void* g_, void* workspace, float* dwh, float* dcols, float* dwo, float* dbo,
             const float* dx_in, float* dx_acc, void* dx_out, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  BwdWorkspace ws(static_cast<char*>(workspace), sizeof(T), m, num_layers, n_out);
  const int tiles = (m + TILE_M - 1) / TILE_M;
  const int chunk = dw_chunk(m), chunks = (m + chunk - 1) / chunk;

  auto tile_kernel = fused_mlp_bwd_tile_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)BwdTile<T>::BYTES);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<tiles, THREADS, BwdTile<T>::BYTES, stream>>>(
      x, m, static_cast<const T*>(wh_), static_cast<const T*>(wht_), bh, sc, bi, num_layers,
      static_cast<const T*>(wo_), n_out, g, static_cast<T*>(ws.h), static_cast<T*>(ws.z),
      static_cast<T*>(ws.n), ws.r, static_cast<T*>(ws.dy), ws.col_part, ws.bo_part, dx_in, dx_acc,
      static_cast<T*>(dx_out));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const T* h = static_cast<const T*>(ws.h);
  if constexpr (sizeof(T) == 2) {
    err = cudaFuncSetAttribute(dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
    if (err != cudaSuccess) return (int)err;
    dw_bf16_kernel<<<dim3(D / 64, num_layers, chunks), THREADS, DW_SMEM, stream>>>(
        x, h, static_cast<const T*>(ws.dy), m, chunk, ws.dw_part);
  } else {
    dw_fma_kernel<T><<<dim3(D / 64, D / 64, num_layers * chunks), THREADS, 0, stream>>>(
        x, h, static_cast<const T*>(ws.dy), D, m, chunk, num_layers, ws.dw_part);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // the output layer: a = the last hidden output, b = g
  const T* h_last = h + (size_t)(num_layers - 1) * m * D;
  dw_fma_kernel<T><<<dim3(D / 64, (n_out + 63) / 64, chunks), THREADS, 0, stream>>>(
      h_last, h_last, g, n_out, m, chunk, 1, ws.dwo_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  int e;
  if ((e = reduce_parts(ws.dw_part, chunks, num_layers * D * D, dwh, stream))) return e;
  if ((e = reduce_parts(ws.col_part, tiles, num_layers * 3 * D, dcols, stream))) return e;
  if ((e = reduce_parts(ws.dwo_part, chunks, D * n_out, dwo, stream))) return e;
  return reduce_parts(ws.bo_part, tiles, n_out, dbo, stream);
}

}  // namespace

extern "C" {

// The feature width the kernels are compiled for.
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

// Bytes of device scratch that sihl_fused_mlp_bwd needs for these sizes.
size_t sihl_fused_mlp_bwd_workspace(int is_bf16, int m, int num_layers, int n_out) {
  return BwdWorkspace(nullptr, is_bf16 ? 2 : 4, m, num_layers, n_out).bytes;
}

// The backward of one MLP over m >= 1 rows, given its output cotangent g
// (m, n_out) in the compute type.  wh is (L, D, D) as [in][out] and wht the
// same weights as [out][in].  Writes f32 dwh (L, D, D) as [in][out], dcols
// (L, 3, D) = the LayerNorm scale, LayerNorm shift and hidden-bias
// gradients, dwo (D, n_out) and dbo (n_out).  dx: the f32 sum of this MLP's
// dx and dx_in (if not null) goes to dx_acc (if not null) and, in the
// compute type, to dx_out (if not null).  workspace holds
// sihl_fused_mlp_bwd_workspace bytes, 256-byte aligned.  Launches on
// `stream` without synchronising and returns the first cudaError_t.
int sihl_fused_mlp_bwd(int is_bf16, const void* x, int m, const void* wh, const void* wht,
                       const float* bh, const float* sc, const float* bi, int num_layers,
                       const void* wo, int n_out, const void* g, void* workspace, float* dwh,
                       float* dcols, float* dwo, float* dbo, const float* dx_in, float* dx_acc,
                       void* dx_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return backward<bf16>(x, m, wh, wht, bh, sc, bi, num_layers, wo, n_out, g, workspace, dwh,
                          dcols, dwo, dbo, dx_in, dx_acc, dx_out, s);
  return backward<float>(x, m, wh, wht, bh, sc, bi, num_layers, wo, n_out, g, workspace, dwh,
                         dcols, dwo, dbo, dx_in, dx_acc, dx_out, s);
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
