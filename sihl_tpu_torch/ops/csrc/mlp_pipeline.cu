// The fused-MLP forward in four restructured modes, for Hopper (sm_90a).
//
// Replaces the TPU probe tools/probe_mlp_pipeline.py:build (its kernel body
// kernel_base), which times variants of the fused-MLP forward to split its
// time between the products and the row-wise LayerNorm/SiLU math.  Its mode
// "base" is the shipped forward, K1f (fused_mlp_fwd_bf16_kernel, called
// unchanged by ops/mlp_pipeline.py); this file holds the other four, as the
// compile-time modes of one template built from K1f's own device code (this
// file includes fused_mlp.cu and reuses its Ring, product_kmajor,
// layer_norm_rows, affine_silu_rows, store_rows and output_rows), so that a
// variant differs from K1f only where the JAX variant differs from base.
// The layout is K1f's at this size: a (row tile, MLP) grid, two warpgroups
// of 64 whole rows per block (the NWG = 2 instantiation), the four-stage
// weight ring of one layer, no stash.
//
//  * nops: after the products, y + bias rounded to bf16 is the next h; no
//    LayerNorm or SiLU.  The products' floor.
//  * mxured: LayerNorm's row sum and sum of squares are wgmma products of y
//    and of y * y against a ones column (a 256 x 8 bf16 ones tile, 4 KiB of
//    shared memory, m64n8k16), with A from registers: the accumulator
//    layout of 16 columns is the A fragment of one k-step, as
//    FlashAttention-3 feeds P.  Then var = E[y^2] - mean^2 (one pass,
//    unclipped), as _ln_silu_mxu computes it.  The A operands round y and
//    y * y to bf16 once (no hi + lo split), as a bf16 matrix unit takes an
//    f32 operand, and the plain version (ops/mlp_pipeline.py) sums the same
//    bf16 values.  The rounding moves a row's sums by about 2^-9 / sqrt(256)
//    relative: far below the bf16 step of z, yet over a row's 4 x 256 z
//    enough to move many outputs by a step against f32 sums, all within
//    the probe's 2e-2 of base.  Each 64-column chunk is converted and
//    multiplied before the next (32 fragment registers, not 128).
//  * pingpong: the block's two warpgroups take the tensor cores in turn.
//    WG 0 multiplies layer l while WG 1 waits; then WG 1 multiplies layer l
//    while WG 0 runs layer l's LayerNorm/SiLU and stores its next A tile;
//    then WG 0 multiplies layer l + 1 while WG 1 runs its row-wise math, and
//    so on.  The turns are two named barriers over the block's 256 threads
//    (ids 3 and 4; K1f's wg_bar uses 1 and 2): a warpgroup waits on its own
//    id before its products and, once they have completed, arrives on the
//    other's.  This is the Hopper form of the JAX probe's half-tile split:
//    a wgmma tile is at least 64 rows, and two m64n256 f32 accumulators do
//    not fit one warpgroup's registers, so the halves are the warpgroups.
//    Each row's arithmetic is K1f's, so the output is bitwise K1f's.
//  * pp+mxured: both; bitwise mxured's.
//
// Why the turns cannot deadlock on the ring.  The ring's four stages hold
// one layer, and a stage refills only after all 8 warps have released it.
// WG 0's products of layer l + 1 need the refills of layer l's stages, which
// need WG 1's products of layer l; WG 0 waits for its turn until exactly
// those have completed, and WG 1's products of layer l need nothing from
// WG 0 beyond its arrival after its own products of layer l.  Every
// warpgroup, including one whose rows all lie past m in the ragged last
// tile, runs every layer on zero rows and takes part in every turn.  The
// turns inside the layer loop are unconditional (a barrier in a branch there
// made ptxas serialise the wgmma of pp+mxured and spill 112-120 bytes in
// both pingpong modes); WG 1 arrives once on WG 0's barrier before the loop
// and WG 0 waits once on it after, so the arrivals and waits of each barrier
// match.
//
// What bounds it on this card: as K1f, the products (2 M D (L D + n_out)
// FLOPs per MLP), against M D input elements read once.

#include "fused_mlp.cu"

namespace {

enum PipelineMode : int { NOPS = 1, MXURED = 2, PINGPONG = 3, PP_MXURED = 4 };

constexpr int PIPE_NWG = 2;                                    // warpgroups of a block
constexpr uint32_t ONES_BYTES = D * 8 * 2;                     // the ones column: 256 x 8 bf16
constexpr uint32_t ONES_OFF = PIPE_NWG * TILE_BYTES + RING_STAGES * CHUNK_BYTES + 128;  // past the ring's barriers

constexpr size_t pipeline_smem(bool ones) { return 1024 + ONES_OFF + (ones ? ONES_BYTES : 0); }

// A shared-memory matrix descriptor without swizzle (for the ones tile,
// whose every element is 1, so only the bounds of what it reads matter).
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// d += A . B for one 64 x 8 x 16 step, A from registers (the warp's 16 rows
// in the mma.sync m16n8k16 A layout), B K-major from shared memory.
__device__ __forceinline__ void wgmma_n8_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_regs(float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A warpgroup waits for its turn on the tensor cores (named barrier 3 + wg
// over the block's two warpgroups) ...
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "r"(PIPE_NWG * WG) : "memory");
}

// ... and, its products done, hands the turn to the other.  ptxas sinks a
// bare bar.arrive to the next barrier, past the row-wise math, and so
// serialises the warpgroups (pingpong then ran slower than K1f); the
// block-scope fence after it keeps it ahead of that math.
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 - wg), "r"(PIPE_NWG * WG) : "memory");
  __threadfence_block();
}

// nops: h = bf16(y + bias), in place.
__device__ __forceinline__ void bias_round_rows(float (&y)[4][32], const float* bias, int q) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col_of(c, i, q)));
#pragma unroll
      for (int j = 0; j < 4; ++j) y[c][i * 4 + j] = round_bf16(y[c][i * 4 + j] + (j & 1 ? b.y : b.x));
    }
}

// mxured: adds the bias to y and returns each row's mean and 1/std, the row
// sums of y and y * y taken as wgmma products with the ones tile at shared
// address ones.  In the accumulator layout, 8-column groups 2 k and 2 k + 1
// of chunk c are the A fragment of k-step k (rows r0 and r0 + 8, columns
// 2 q, 2 q + 1 and 8 + 2 q, 9 + 2 q of the step); every column of the 64 x 8
// result is the row's sum, so lane q reads its rows' sums in d[0] and d[2].
__device__ __forceinline__ void layer_norm_rows_mxu(float (&y)[4][32], const float* bias, int q, uint32_t ones,
                                                    float (&mu)[2], float (&rstd)[2]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col_of(c, i, q)));
#pragma unroll
      for (int j = 0; j < 4; ++j) y[c][i * 4 + j] += j & 1 ? b.y : b.x;
    }
  float s[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t a[4][4], a2[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r: 8-column group 2 k + r / 2, row r0 + 8 (r % 2)
        const float v0 = y[c][(2 * k + (r >> 1)) * 4 + (r & 1) * 2], v1 = y[c][(2 * k + (r >> 1)) * 4 + (r & 1) * 2 + 1];
        a[k][r] = pack_bf16(v0, v1);
        a2[k][r] = pack_bf16(v0 * v0, v1 * v1);
      }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // rows 16 (4 c + k) .. + 15 of the column: two 8 x 8 core matrices,
      // 128 bytes apart whichever offset the hardware reads as the K step
      const uint64_t db = plain_desc(ones + (c * 4 + k) * 256, 128, 128);
      wgmma_n8_rs(s, a[k], db);
      wgmma_n8_rs(ss, a2[k], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(ss);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mu[r] = s[2 * r] * (1.f / D);
    rstd[r] = rsqrtf(ss[2 * r] * (1.f / D) - mu[r] * mu[r] + LN_EPS);
  }
}

// Block (tile, mlp): K1f's forward (fused_mlp_fwd_bf16_kernel<2, false>, no stash)
// in mode MODE.
template <int MODE>
__global__ void __launch_bounds__(PIPE_NWG * WG, 1) mlp_pipeline_kernel(const __grid_constant__ Call a) {
  constexpr bool MXU = MODE == MXURED || MODE == PP_MXURED;
  constexpr bool PP = MODE == PINGPONG || MODE == PP_MXURED;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t base = smem_addr(sm);
  const uint32_t ring_base = base + PIPE_NWG * TILE_BYTES;
  const uint32_t bars = ring_base + RING_STAGES * CHUNK_BYTES;
  const Mlp& p = a.mlp[blockIdx.y];
  const int num_layers = a.num_layers;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ int released[RING_STAGES];
  Ring ring{ring_base, bars, released, static_cast<const unsigned char*>(p.w), num_layers, num_layers * CHUNKS,
            false, 4 * PIPE_NWG, 0};
  if constexpr (MXU) {  // 256 threads x 16 bytes of bf16 ones
    *reinterpret_cast<uint4*>(sm + ONES_OFF + threadIdx.x * 16) =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    fence_proxy_async();
  }
  if (threadIdx.x == 0) init_ring(bars, released);
  __syncthreads();
  if (threadIdx.x == 0) ring.start();

  const int wg = warp >> 2, tid = threadIdx.x & (WG - 1), q = lane & 3;
  const int row0 = blockIdx.x * (PIPE_NWG * WG_ROWS) + wg * WG_ROWS;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const RowTotals whole_rows{nullptr, 0, r0, q};
  unsigned char* tile = sm + wg * TILE_BYTES;
  load_rows<WG>(smem_addr(tile), static_cast<const bf16*>(a.x), row0, a.m - row0, tid);
  cp_async_wait_all();
  fence_proxy_async();
  wg_bar(wg);

  float acc[4][32], mu[2], rstd[2];
  uint32_t unused[2][64];
  if (PP && wg == 1) turn_pass(wg);  // WG 0 takes the first turn
  for (int l = 0; l < num_layers; ++l) {
    if constexpr (PP) turn_wait(wg);
    product_kmajor(acc, smem_addr(tile), ring, 0);
    if constexpr (PP) turn_pass(wg);
    if constexpr (MODE == NOPS) {
      bias_round_rows(acc, p.bh + l * D, q);
    } else {
      if constexpr (MXU)
        layer_norm_rows_mxu(acc, p.bh + l * D, q, base + ONES_OFF, mu, rstd);
      else
        layer_norm_rows(acc, p.bh + l * D, q, whole_rows, mu, rstd);
      affine_silu_rows<4, false, true>(acc, p.sc + l * D, p.bi + l * D, q, mu, rstd, unused);
    }
    if (l + 1 < num_layers) {
      wg_bar(wg);  // every warp's products have read the tile
      store_rows(acc, tile, r0, q, 0);
      fence_proxy_async();
      wg_bar(wg);
    }
  }
  if (PP && wg == 0) turn_wait(wg);  // WG 1's last pass
  output_rows(acc, p, q, row0 + r0, row0 + r0 + 8, a.m);
}

template <int MODE>
int launch_pipeline(const Call& c, cudaStream_t stream) {
  constexpr size_t smem = pipeline_smem(MODE == MXURED || MODE == PP_MXURED);
  const cudaError_t err = allow_smem(mlp_pipeline_kernel<MODE>, smem);
  if (err) return (int)err;
  const int blocks = (c.m + PIPE_NWG * WG_ROWS - 1) / (PIPE_NWG * WG_ROWS);
  mlp_pipeline_kernel<MODE><<<dim3(blocks, c.num_mlps), PIPE_NWG * WG, smem, stream>>>(c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Mode `mode` (1 nops, 2 mxured, 3 pingpong, 4 pp+mxured) of the bf16
// forward of num_mlps MLPs over m >= 1 rows of x (m, D), in one launch.
// ptrs and n_outs as for sihl_fused_mlp_fwd (w the packed hidden-weight
// image; the wt and h slots are not read).  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch.
int sihl_mlp_pipeline_fwd(int mode, const void* x, int m, int num_layers, int num_mlps, const long long* ptrs,
                          const int* n_outs, void* stream) {
  const Call c = make_call(x, nullptr, m, num_layers, num_mlps, ptrs, n_outs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case NOPS: return launch_pipeline<NOPS>(c, s);
    case MXURED: return launch_pipeline<MXURED>(c, s);
    case PINGPONG: return launch_pipeline<PINGPONG>(c, s);
    case PP_MXURED: return launch_pipeline<PP_MXURED>(c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
