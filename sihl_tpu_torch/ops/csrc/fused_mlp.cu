// Fused per-anchor MLP, forward (K1f) and backward (K1b), for Hopper (sm_90a).
//
// Replaces the TPU kernels of sihl_tpu/ops/pallas/mlp.py: _fwd_kernel
// (launched by _fwd_pallas) and _bwd_kernel (launched by _bwd_pallas).  One
// MLP is L x [Linear -> LayerNorm -> SiLU] hidden layers of width D = 256 and
// a bare output Linear; one launch runs every MLP of a call over their shared
// (M, D) input, on a grid of (row tile, MLP).
//
// What bounds it on this card: the hidden products, 2 * M * D * D FLOPs per
// layer and MLP (the backward adds three per layer: the recompute of y before
// each LayerNorm backward, dh = dy W and dW), against M * D input elements
// read once, so the tensor cores bound it.  What keeps it from that bound is
// the work around the products, and the design answers each part:
//
//  * Products on wgmma (inline PTX): a warpgroup's 64 rows times 256 columns
//    (m64n256k16, a 128-register f32 accumulator; in the backward 64 columns,
//    m64n64k16).  Lane quad q = lane & 3 of a row holds its columns
//    8 i + 2 q and 8 i + 2 q + 1.  The forward runs two warpgroups of 64 rows
//    per block where that still fills the card, else one.
//  * Weights through an asynchronous ring.  Each layer's weights arrive in
//    four 32 KiB K-chunks by cp.async.bulk into a four-stage ring (one
//    layer) with full mbarriers, so the next layer's copy overlaps this
//    layer's math.  The last warp to release a stage refills it, so no warp
//    is set aside as a producer: ptxas budgets a block with one as whole
//    warpgroups, which capped the consumers at 168 registers and spilled.
//    The wrapper packs each hidden weight once per weight version into the
//    exact image the descriptors read: chunk kc holds W[n][64 kc .. +63] for
//    all 256 n, one 128-byte row per n, its 16-byte units swizzled (unit u of
//    row n at u ^ (n & 7)).  The same image is K-major B for y = h W^T and
//    MN-major B for dh = dy W: no transposed copy.
//  * LayerNorm and SiLU in registers: the row mean, the two-pass variance
//    and the backward's mean(dn) and mean(dn * n) are sums over a lane quad
//    (and, where warpgroups split a row, over the parts through shared
//    memory in a fixed order).  The next layer's A operand is written once
//    to a swizzled tile in shared memory.
//  * The output Linear, narrow (n_out 1 .. 256), runs from registers: per
//    output, a dot product of the thread's values with the weight's row,
//    summed over the quad; its backward the same way, g from a tile image.
//  * A wide output Linear (n_out > 256, any width; the keypoint head's
//    kernel MLP has 2,737 outputs) runs on wgmma in blocks of 256 outputs.
//    The wrapper packs wo, padded with zero rows to whole blocks, into the
//    weight image after the hidden layers, each block laid out as a hidden
//    layer, so the same ring streams it: the forward takes out = h_{L-1}
//    wo^T + bo block by block from the last hidden tile (K-major B, as
//    y = h W^T); the backward takes dh_{L-1} = g wo as the sum over blocks
//    of the cotangent's 256-column tile image times the block read MN-major
//    (as dh = dy W), and dWo = g^T h_{L-1} through the dW GEMM.
//  * K1b keeps a small stash and spreads the row-wise work.  The training
//    forward (K1f with a stash) writes x and h_0 .. h_{L-1} as swizzled
//    64-row tile images, the one copy of the forward that the backward
//    reads; the backward writes dy_l as images for dW.  z and n are never
//    stored in device memory: the sweep recomputes y_l = h_{l-1} W_l^T from
//    the stashed h tile (cp.async) and keeps z and n of the layer in flight
//    in registers.  Four warpgroups share a 64-row tile, 64 columns each, so
//    16 warps hide each other's latency in the row-wise steps.  Column sums
//    (the LayerNorm and bias gradients) reduce over the tile's rows by
//    shuffles in a fixed order into per-tile partials.
//  * dW_l = dy_l^T h_{l-1} is a split-M wgmma GEMM over those images (both
//    operands MN-major) behind its own ring with a producer warp; each chunk
//    of rows writes one partial, and reduce_partials_kernel sums partials in
//    a fixed order, so the gradients are deterministic (no atomics on data).
//
// Numerics follow _fwd_kernel and _bwd_kernel: h is held in the compute type
// between layers; y = h W^T accumulates in f32, plus the f32 bias; LayerNorm
// takes an f32 mean and a two-pass variance (eps 1e-5) and applies its
// affine in f32; z is rounded to the compute type and SiLU is evaluated in
// f32 on that value (bf16 body: the hardware exp2 and reciprocal), then
// rounded.  The output layer adds its f32 bias to the f32 sum and rounds
// once.  In the backward, dh is f32, the recomputed n is rounded to the
// compute type (as _bwd_kernel stashes n in bf16), and dy is rounded to the
// compute type before it feeds dh = dy W and dW.  dx is the f32 sum over the
// MLPs, in MLP order, rounded once.
//
// The f32 body (parity checks only: tensor cores have no full-f32 mode)
// keeps FMA products from shared memory, an 8 x 8 register tile per thread,
// and its own forward recompute, but follows the same algorithm otherwise:
// one launch over (tile, MLP), h and dy stashed, z and n recomputed, dW as
// split-M partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 256;          // input and hidden width
constexpr int MAX_MLPS = 4;     // MLPs of one call
constexpr int NARROW_OUT = 256; // widest output layer of the register path
constexpr int OUT_BLOCK = 256;  // outputs of one block of a wide output layer
constexpr float LN_EPS = 1e-5f;

// -- bf16 body: shapes of the shared-memory images --------------------------
constexpr int WG = 128;                            // threads of a warpgroup
constexpr int WG_ROWS = 64;                        // rows of a warpgroup's tile
constexpr uint32_t KC_BYTES = 8192;                // 64 rows x 128 bytes: one K-chunk of a tile
constexpr uint32_t TILE_BYTES = WG_ROWS * D * 2;   // a 64-row tile image, 32 KiB
constexpr uint32_t CHUNK_BYTES = D * 64 * 2;       // one weight K-chunk, 32 KiB
constexpr int CHUNKS = D / 64;                     // K-chunks per layer

// -- f32 body ----------------------------------------------------------------
constexpr int TILE_M = 64;    // rows per block
constexpr int THREADS = 256;  // 8 warps
constexpr int HS32 = D + 1;   // activation tile stride
constexpr int KC32 = 32;      // weight rows staged per step
constexpr size_t SMEM32 = (size_t)(TILE_M * HS32 + KC32 * D) * sizeof(float);
constexpr size_t SMEM32_BWD = SMEM32 + (size_t)3 * 8 * D * sizeof(float);  // + per-warp column sums

// Blocks of a wide output layer (0 for a narrow one): its image's "layers".
__host__ __device__ constexpr int out_blocks(int n_out) {
  return n_out > NARROW_OUT ? (n_out + OUT_BLOCK - 1) / OUT_BLOCK : 0;
}
// 64-column blocks of the cotangent's tile images: a wide layer's whole
// output blocks.
__host__ __device__ constexpr int g_col_blocks(int n_out) {
  return n_out > NARROW_OUT ? 4 * out_blocks(n_out) : (n_out + 63) / 64;
}
// Blocks of the dW GEMM over `rows` output rows, 128 rows (two warpgroups) each.
__host__ __device__ constexpr int dw_pairs(int rows) { return ((rows + 63) / 64 + 1) / 2; }

// One MLP of a call.  bf16: w is the packed weight image ((L + out_blocks)
// x CHUNKS x CHUNK_BYTES: the hidden layers, then a wide output layer's
// blocks), wt unused.  f32: w is (L, D, D) as [in][out], wt the same as
// [out][in].  wo is (n_out, D), the output Linear's own layout.  io is the
// output (forward) or the output cotangent (backward), (m, n_out).  h and dy
// are the backward's stashes: bf16 tile images (L of each, tiles x
// TILE_BYTES per layer; h written by the training forward) and the cotangent
// image g_img (tiles x ncb x KC_BYTES); f32 row-major (L, m, D).
struct Mlp {
  const void* w;
  const void* wt;
  const float* bh;
  const float* sc;
  const float* bi;
  const void* wo;
  const float* bo;
  void* io;
  int n_out;
  unsigned char* h;
  unsigned char* dy;
  unsigned char* g_img;
  int dw_row0;             // the MLP's first row of dw: L x D hidden rows, then n_out
};

struct Call {
  const void* x;           // (m, D)
  int m;
  int num_layers;
  int num_mlps;
  Mlp mlp[MAX_MLPS];
  unsigned char* x_img;    // bf16: x as tile images, written by the training forward
  float* col_part;         // (tiles, mlps, L, 3, D): sum dz * n, dz, dy per tile
  float* bo_part;          // (tiles, mlps, bo_stride): sum g per tile
  int bo_stride;           // the widest n_out of the call
  int dw_rows;             // rows of dw: over the MLPs, L x D + n_out each
  float* dx_part;          // (mlps, m, D) f32 per-MLP dx, or null for one MLP
  void* dx;                // (m, D) compute type, written by the tile kernel for one MLP
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }
// The bf16 body's sigmoid: the hardware exp2 and reciprocal (a few ulp of f32,
// far below the bf16 rounding that follows every use).
__device__ __forceinline__ float sigmoid_fast(float z) { return __fdividef(1.f, 1.f + __expf(-z)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// -- PTX: shared-memory addresses, mbarriers, bulk and async copies, wgmma ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, reported to bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// 16 bytes from global src to shared dst, zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// generic-proxy writes to shared memory become visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the barrier of one warpgroup's 128 threads (named barrier 1 + wg)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across wgmma
// issue and wait (it does not see the asynchronous writes).
template <int NC>
__device__ __forceinline__ void fence_acc(float (&d)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[c][i])::"memory");
}

// A shared-memory matrix descriptor, 128-byte swizzle.  lbo: bytes between
// 64-element atoms along MN (MN-major operands); sbo: bytes between groups of
// 8 rows (K-major) or of 8 K (MN-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// Byte offset of element (row, col) of a 64-row tile image: four K-chunks of
// 64 columns, each 64 rows of 128 bytes with 16-byte units swizzled.
__device__ __forceinline__ uint32_t img_off(int row, int col) {
  return (uint32_t)(col >> 6) * KC_BYTES + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// d (+)= A . B for one 64 x 256 x 16 step; A and B from shared memory through
// their descriptors, TA / TB = 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[4][32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]), "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]), "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
        "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]), "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]),
        "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]), "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15]),
        "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]), "+f"(d[3][19]), "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]),
        "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]), "+f"(d[3][28]), "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (+)= A . B for one 64 x 64 x 16 step; A K-major, B MN-major if TB = 1.
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// -- bf16 body: the weight ring -------------------------------------------------

// The producer of the dW GEMM's ring.  The stages of a ring sit at `stages`,
// stage_bytes apart; its barriers at `bars`: full[0 .. n) then empty[0 .. n),
// 8 bytes each.  The t-th stage filled (and taken) is stage t % n, in phase
// (t / n) & 1.
struct Producer {
  uint32_t stages, bars, stage_bytes;
  int n, t;
  // Waits until the next stage is free and arms its full barrier for bytes.
  __device__ uint32_t acquire(uint32_t bytes, uint32_t& full) {
    const int s = t % n;
    const uint32_t parity = (t / n) & 1;
    ++t;
    mbar_wait(bars + 8 * (n + s), parity ^ 1);  // the first round passes at once
    full = bars + 8 * s;
    mbar_expect_tx(full, bytes);
    return stages + s * stage_bytes;
  }
};

// The weight ring of the tile kernels: four 32 KiB stages, one layer.  The
// consumers take K-chunks in the order of a fixed sequence of layers of the
// image (sequence position p is chunk p % 4 of layer layer_at(p / 4); a wide
// output layer's blocks are the image's layers L, L + 1, ...).  Thread 0
// fills the first four positions; afterwards the last consumer warp to
// release position p (a shared-memory count per stage) loads position p + 4
// into the stage.  So no warp is set aside for copies and none waits to
// issue one: a block is only its consumer warpgroups.
constexpr int RING_STAGES = 4;

struct Ring {
  uint32_t stages, bars;  // shared addresses: the stages, then full[4]
  int* released;          // per stage, the consumer warps that released it this round
  const unsigned char* w; // the packed hidden-weight image
  int num_layers, total;  // total: positions in the sequence
  bool backward;          // which sequence
  int warps;              // consumer warps
  int t;                  // positions taken
  int out_blocks = 0;     // blocks of a wide output layer

  // forward: W_0 .. W_{L-1}, then the output blocks; backward: W_{L-1}, the
  // output blocks, then for l = L-2 .. 0 W_l and W_{l+1}, then W_0
  __device__ int layer_at(int k) const {
    if (!backward) return k;
    if (k == 0) return num_layers - 1;
    if (k <= out_blocks) return num_layers + k - 1;
    k -= 1 + out_blocks;
    if (k < 2 * (num_layers - 1)) return num_layers - 2 - k / 2 + (k & 1);
    return 0;
  }
  __device__ void fill(int p) const {
    if (p >= total) return;
    const uint32_t full = bars + 8 * (p % RING_STAGES);
    mbar_expect_tx(full, CHUNK_BYTES);
    bulk_load(stages + (p % RING_STAGES) * CHUNK_BYTES,
              w + ((size_t)layer_at(p / CHUNKS) * CHUNKS + p % CHUNKS) * CHUNK_BYTES, CHUNK_BYTES, full);
  }
  // Thread 0, once the barriers' initialisation is visible to the block.
  __device__ void start() const {
    for (int p = 0; p < RING_STAGES; ++p) fill(p);
  }
  // The next position: waits until its chunk has arrived.
  __device__ int take() {
    const int p = t++;
    mbar_wait(bars + 8 * (p % RING_STAGES), (p / RING_STAGES) & 1);
    return p;
  }
  __device__ uint32_t stage(int p) const { return stages + (p % RING_STAGES) * CHUNK_BYTES; }
  // Each consumer warp, once its products have read position p (its wgmma
  // group has completed); the last of them refills the stage.
  __device__ void release(int p) const {
    if ((threadIdx.x & 31) == 0) {
      int* count = released + p % RING_STAGES;
      if (atomicAdd(count, 1) == warps - 1) {
        *count = 0;
        fill(p + RING_STAGES);
      }
    }
  }
};

__device__ __forceinline__ void init_ring(uint32_t bars, int* released) {
  for (int s = 0; s < RING_STAGES; ++s) {
    mbar_init(bars + 8 * s, 1);
    released[s] = 0;
  }
  mbar_init_fence();
}

template <int NC>
__device__ __forceinline__ void zero_acc(float (&d)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[c][i] = 0.f;
  fence_acc(d);
}

// acc = A . W^T over the warpgroup's 64 rows and 64 NC columns from col0:
// A a 64 x 256 tile image at shared address a, W the next layer of the ring
// (K-major B).  The products of one chunk overlap the wait for the next.
template <int NC>
__device__ __forceinline__ void product_kmajor(float (&acc)[NC][32], uint32_t a, Ring& ring, int col0) {
  zero_acc(acc);
  int prev = -1;
#pragma unroll 1
  for (int kc = 0; kc < CHUNKS; ++kc) {
    const int s = ring.take();
    const uint32_t b = ring.stage(s) + col0 * 128;  // B rows n = col0 .. col0 + 64 NC - 1
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(a + kc * KC_BYTES + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(b + kk * 32, 16, 1024);
      if constexpr (NC == 4)
        wgmma_n256<0, 0>(acc, da, db);
      else
        wgmma_n64<0>(acc[0], da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) ring.release(prev);
    prev = s;
  }
  wgmma_wait<0>();
  ring.release(prev);
  fence_acc(acc);
}

// acc (+)= A . W over the 64 NC columns from col0: A a 64 x 256 tile image
// (the reduction runs over its columns), W the next layer of the ring read
// MN-major: chunk kc gives output columns 64 kc .. 64 kc + 63, so this
// warpgroup multiplies by NC of the four chunks and passes the others on.
template <int NC, bool ACCUMULATE = false>
__device__ __forceinline__ void product_mnmajor(float (&acc)[NC][32], uint32_t a, Ring& ring, int col0) {
  if constexpr (!ACCUMULATE) zero_acc(acc);
#pragma unroll
  for (int kc = 0; kc < CHUNKS; ++kc) {
    const int s = ring.take();
    if (kc / NC == col0 / (64 * NC)) {
      const uint32_t b = ring.stage(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 16; ++ks)
        wgmma_n64<1>(acc[kc % NC], sw128_desc(a + (ks >> 2) * KC_BYTES + (ks & 3) * 32, 16, 1024),
                     sw128_desc(b + ks * 2048, KC_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<0>();
    }
    ring.release(s);
  }
  fence_acc(acc);
}

// -- bf16 body: row-wise steps in the accumulator layout ------------------------
//
// Thread tid of a warpgroup holds rows r0 = 16 (tid / 32 % 4) + (tid % 32) / 4
// and r0 + 8 of its 64-row tile: acc[c][4 i + j] is row r0 + 8 (j / 2), column
// col0 + 64 c + 8 i + 2 q + j % 2 with q = tid % 4.  A warpgroup holds whole
// rows (NC = 4, col0 = 0) or, in the backward, a quarter of each row (NC = 1,
// col0 = 64 w: four warpgroups share the tile).

__device__ __forceinline__ int col_of(int c, int i, int q) { return c * 64 + i * 8 + q * 2; }

// Per-row totals over the columns a row's values are spread across: the
// lane quad's, plus, where four warpgroups split the columns, the other parts
// (through xch, in a fixed order, so every part gets the same bits).
struct RowTotals {
  float* xch;  // null: whole rows in one warpgroup; else 4 slots x 4 parts x 64 rows
  int part, r0, q;
  __device__ void operator()(float& a, float& b, int slot) const {
    a = quad_sum(a);
    b = quad_sum(b);
    if (!xch) return;
    float* s = xch + slot * 4 * WG_ROWS;
    if (q == 0) {
      s[part * WG_ROWS + r0] = a;
      s[part * WG_ROWS + r0 + 8] = b;
    }
    asm volatile("bar.sync 1, 512;\n" ::: "memory");  // the four warpgroups of the tile
    a = (s[r0] + s[WG_ROWS + r0]) + (s[2 * WG_ROWS + r0] + s[3 * WG_ROWS + r0]);
    b = (s[r0 + 8] + s[WG_ROWS + r0 + 8]) + (s[2 * WG_ROWS + r0 + 8] + s[3 * WG_ROWS + r0 + 8]);
  }
};

// Adds the bias (from col0) to y and returns each row's mean and 1/std.
template <int NC>
__device__ __forceinline__ void layer_norm_rows(float (&y)[NC][32], const float* bias, int q, const RowTotals& rt,
                                                float (&mu)[2], float (&rstd)[2]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col_of(c, i, q)));
      y[c][i * 4 + 0] += b.x;
      y[c][i * 4 + 1] += b.y;
      y[c][i * 4 + 2] += b.x;
      y[c][i * 4 + 3] += b.y;
      s0 += y[c][i * 4 + 0] + y[c][i * 4 + 1];
      s1 += y[c][i * 4 + 2] + y[c][i * 4 + 3];
    }
  rt(s0, s1, 0);
  mu[0] = s0 * (1.f / D);
  mu[1] = s1 * (1.f / D);
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a0 = y[c][i * 4 + 0] - mu[0], a1 = y[c][i * 4 + 1] - mu[0];
      const float b0 = y[c][i * 4 + 2] - mu[1], b1 = y[c][i * 4 + 3] - mu[1];
      v0 += a0 * a0 + a1 * a1;
      v1 += b0 * b0 + b1 * b1;
    }
  rt(v0, v1, 1);
  rstd[0] = rsqrtf(v0 * (1.f / D) + LN_EPS);
  rstd[1] = rsqrtf(v1 * (1.f / D) + LN_EPS);
}

// n = (y - mu) rstd and z = n sc + bi rounded to bf16 (sc, bi from col0);
// with ZN, z and n (n rounded to bf16) are kept in zn[0] and zn[1]; with H, y
// becomes h = SiLU(z) rounded to bf16.
template <int NC, bool ZN, bool H>
__device__ __forceinline__ void affine_silu_rows(float (&y)[NC][32], const float* sc, const float* bi, int q,
                                                 const float (&mu)[2], const float (&rstd)[2],
                                                 uint32_t (&zn)[2][NC * 16]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 s = __ldg(reinterpret_cast<const float2*>(sc + col_of(c, i, q)));
      const float2 b = __ldg(reinterpret_cast<const float2*>(bi + col_of(c, i, q)));
      float z[4], n[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        n[j] = (y[c][i * 4 + j] - mu[j >> 1]) * rstd[j >> 1];
        z[j] = round_bf16(n[j] * (j & 1 ? s.y : s.x) + (j & 1 ? b.y : b.x));
      }
      if constexpr (ZN) {
        const int k = (c * 8 + i) * 2;
        zn[0][k] = pack_bf16(z[0], z[1]);
        zn[0][k + 1] = pack_bf16(z[2], z[3]);
        zn[1][k] = pack_bf16(n[0], n[1]);
        zn[1][k + 1] = pack_bf16(n[2], n[3]);
      }
      if constexpr (H) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[c][i * 4 + j] = round_bf16(z[j] * sigmoid_fast(z[j]));
      }
    }
}

// The thread's values, rounded to bf16, into a 64-row tile image from col0.
template <int NC>
__device__ __forceinline__ void store_rows(const float (&y)[NC][32], unsigned char* tile, int r0, int q, int col0) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = col0 + col_of(c, i, q);
      *reinterpret_cast<uint32_t*>(tile + img_off(r0, col)) = pack_bf16(y[c][i * 4 + 0], y[c][i * 4 + 1]);
      *reinterpret_cast<uint32_t*>(tile + img_off(r0 + 8, col)) = pack_bf16(y[c][i * 4 + 2], y[c][i * 4 + 3]);
    }
}

// Rows row0 .. row0 + rows - 1 of x (m x D) into a tile image with cp.async by
// NT threads, zeros past them; the caller waits.
template <int NT>
__device__ __forceinline__ void load_rows(uint32_t tile, const bf16* x, int row0, int rows, int tid) {
#pragma unroll 4
  for (int k = 0; k < WG_ROWS * D / 8 / NT; ++k) {
    const int unit = tid + k * NT, r = unit >> 5, col = (unit & 31) * 8;
    const bool in = r < rows;
    cp_async16(tile + img_off(r, col), in ? x + (size_t)(row0 + r) * D + col : x, in ? 16 : 0);
  }
  cp_async_commit();
}

// A tile image to device memory by NT threads, and back with cp.async: each
// thread moves the same 16-byte units both ways, so its own stores order its
// reloads.
template <int NT>
__device__ __forceinline__ void save_tile(const unsigned char* tile, unsigned char* dst, uint32_t bytes, int tid) {
#pragma unroll 4
  for (uint32_t off = tid * 16; off < bytes; off += NT * 16)
    *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(tile + off);
}

template <int NT>
__device__ __forceinline__ void reload_tile(uint32_t tile, const unsigned char* src, int tid) {
#pragma unroll 4
  for (uint32_t off = tid * 16; off < TILE_BYTES; off += NT * 16) cp_async16(tile + off, src + off, 16);
  cp_async_commit();
}

// The output Linear from registers: out[row][o] = h[row] . wo[o] + bo[o] for
// the thread's valid rows; lane q of a quad writes outputs o = q mod 4.
__device__ __forceinline__ void output_rows(const float (&h)[4][32], const Mlp& p, int q, int row_a, int row_b,
                                            int m) {
  const bf16* wo = static_cast<const bf16*>(p.wo);
  bf16* out = static_cast<bf16*>(p.io);
  const int n_out = p.n_out;
#pragma unroll 1
  for (int o = 0; o < n_out; ++o) {
    const bf16* w = wo + (size_t)o * D;
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + col_of(c, i, q)));
        t0 = fmaf(h[c][i * 4 + 0], wv.x, fmaf(h[c][i * 4 + 1], wv.y, t0));
        t1 = fmaf(h[c][i * 4 + 2], wv.x, fmaf(h[c][i * 4 + 3], wv.y, t1));
      }
    t0 = quad_sum(t0);
    t1 = quad_sum(t1);
    if (q == (o & 3)) {
      if (row_a < m) out[(size_t)row_a * n_out + o] = __float2bfloat16(t0 + p.bo[o]);
      if (row_b < m) out[(size_t)row_b * n_out + o] = __float2bfloat16(t1 + p.bo[o]);
    }
  }
}

// The wide output Linear on wgmma: out = h . wo^T + bo for the warpgroup's
// valid rows, h its 64-row tile image at shared address `tile`, wo's blocks
// of 256 outputs the next layers of the ring.
__device__ __forceinline__ void output_blocks(float (&acc)[4][32], uint32_t tile, Ring& ring, const Mlp& p, int q,
                                              int row_a, int m) {
  bf16* out = static_cast<bf16*>(p.io);
  const int n_out = p.n_out, row_b = row_a + 8;
#pragma unroll 1
  for (int b = 0; b < out_blocks(n_out); ++b) {
    product_kmajor(acc, tile, ring, 0);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = b * OUT_BLOCK + col_of(c, i, q) + (j & 1), row = j < 2 ? row_a : row_b;
          if (o < n_out && row < m) out[(size_t)row * n_out + o] = __float2bfloat16(acc[c][i * 4 + j] + p.bo[o]);
        }
  }
}

// dh = g . wo (wo as (n_out, D)) for the thread's rows and the 64 NC columns
// from col0, from registers; g from its tile image (zero past the input).
template <int NC>
__device__ __forceinline__ void output_backward(float (&a)[NC][32], const bf16* wo, int n_out,
                                                const unsigned char* gimg, int r0, int q, int col0) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) a[c][i] = 0.f;
#pragma unroll 2
  for (int o = 0; o < n_out; ++o) {
    const float g0 = __bfloat162float(*reinterpret_cast<const bf16*>(gimg + img_off(r0, o)));
    const float g1 = __bfloat162float(*reinterpret_cast<const bf16*>(gimg + img_off(r0 + 8, o)));
    const bf16* w = wo + (size_t)o * D + col0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + col_of(c, i, q)));
        a[c][i * 4 + 0] = fmaf(g0, wv.x, a[c][i * 4 + 0]);
        a[c][i * 4 + 1] = fmaf(g0, wv.y, a[c][i * 4 + 1]);
        a[c][i * 4 + 2] = fmaf(g1, wv.x, a[c][i * 4 + 2]);
        a[c][i * 4 + 3] = fmaf(g1, wv.y, a[c][i * 4 + 3]);
      }
  }
}

// Sums v (this thread's partial sums for columns 64 c + 8 (k / 2) + 2 q + k % 2
// over its rows) over the warp's 16 rows by a reduce-scatter in three xor
// steps, in a fixed order; returns the sums for columns 64 c + 8 ii + 2 q and
// + 1, with ii = column_slot(lane).
__device__ __forceinline__ int column_slot(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

__device__ __forceinline__ float2 column_sums(const float (&v)[16], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float u[8], w[4], x[2];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    u[k] = (b4 ? v[8 + k] : v[k]) + __shfl_xor_sync(0xffffffffu, b4 ? v[k] : v[8 + k], 16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (b3 ? u[4 + k] : u[k]) + __shfl_xor_sync(0xffffffffu, b3 ? u[k] : u[4 + k], 8);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    x[k] = (b2 ? w[2 + k] : w[k]) + __shfl_xor_sync(0xffffffffu, b2 ? w[k] : w[2 + k], 4);
  return make_float2(x[0], x[1]);
}

// The backward of SiLU and LayerNorm for the thread's rows and the 64 NC
// columns from col0: a holds dh in and dy (f32) out; zn this layer's z and n.
// Rows past the input (va, vb false) get dz = 0.  The column sums of dz * n,
// dz and dy over each warp's 16 rows go to red[rows 16 w .. 16 w + 15][0 .. 2][D].
template <int NC>
__device__ __forceinline__ void ln_silu_backward(float (&a)[NC][32], const uint32_t (&zn)[2][NC * 16],
                                                 const float* sc, const float (&rstd)[2], bool va, bool vb,
                                                 float* red, int lane, int warp, int col0, const RowTotals& rt) {
  const int q = lane & 3;
  float* rw = red + (warp & 3) * 3 * D + col0;
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float dsc[16], dbi[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = (c * 8 + i) * 2;
      const float2 za = unpack_bf16(zn[0][k]), zb = unpack_bf16(zn[0][k + 1]);
      const float2 na = unpack_bf16(zn[1][k]), nb = unpack_bf16(zn[1][k + 1]);
      const float z[4] = {za.x, za.y, zb.x, zb.y}, n[4] = {na.x, na.y, nb.x, nb.y};
      const float2 s = __ldg(reinterpret_cast<const float2*>(sc + col_of(c, i, q)));
      dsc[i * 2] = dsc[i * 2 + 1] = dbi[i * 2] = dbi[i * 2 + 1] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sig = sigmoid_fast(z[j]);
        const float dz = (j < 2 ? va : vb) ? a[c][i * 4 + j] * (sig * (1.f + z[j] * (1.f - sig))) : 0.f;
        dsc[i * 2 + (j & 1)] += dz * n[j];
        dbi[i * 2 + (j & 1)] += dz;
        const float dn = dz * (j & 1 ? s.y : s.x);
        a[c][i * 4 + j] = dn;
        s1[j >> 1] += dn;
        s2[j >> 1] += dn * n[j];
      }
    }
    const int col = c * 64 + column_slot(lane) * 8 + q * 2;
    *reinterpret_cast<float2*>(rw + col) = column_sums(dsc, lane);
    *reinterpret_cast<float2*>(rw + D + col) = column_sums(dbi, lane);
  }
  rt(s1[0], s1[1], 2);
  rt(s2[0], s2[1], 3);
  const float mean_dn[2] = {s1[0] * (1.f / D), s1[1] * (1.f / D)};
  const float mean_dnn[2] = {s2[0] * (1.f / D), s2[1] * (1.f / D)};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float dbh[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = (c * 8 + i) * 2;
      const float2 na = unpack_bf16(zn[1][k]), nb = unpack_bf16(zn[1][k + 1]);
      const float n[4] = {na.x, na.y, nb.x, nb.y};
      dbh[i * 2] = dbh[i * 2 + 1] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        const float dy = rstd[r] * (a[c][i * 4 + j] - mean_dn[r] - n[j] * mean_dnn[r]);
        a[c][i * 4 + j] = dy;
        dbh[i * 2 + (j & 1)] += dy;
      }
    }
    *reinterpret_cast<float2*>(rw + 2 * D + c * 64 + column_slot(lane) * 8 + q * 2) = column_sums(dbh, lane);
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// -- bf16 forward (K1f) ----------------------------------------------------------

template <int NWG>
constexpr size_t fwd_smem() {
  return 1024 + NWG * TILE_BYTES + RING_STAGES * CHUNK_BYTES + RING_STAGES * 8;
}

// Block (tile, mlp): NWG consumer warpgroups of 64 whole rows each; the ring
// streams the MLP's hidden weights (and, with WIDE, a wide output layer's
// blocks; a call without one runs the instance without that code).  When
// p.h is set (a training forward), each warpgroup also writes its tile's
// images for the backward: x (MLP 0 only) and h_0 .. h_{L-1}.
template <int NWG, bool WIDE>
__global__ void __launch_bounds__(NWG * WG, 1) fused_mlp_fwd_bf16_kernel(const __grid_constant__ Call a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t base = smem_addr(sm);
  const uint32_t ring_base = base + NWG * TILE_BYTES;
  const uint32_t bars = ring_base + RING_STAGES * CHUNK_BYTES;
  const Mlp& p = a.mlp[blockIdx.y];
  const int num_layers = a.num_layers;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ int released[RING_STAGES];
  const int nob = WIDE ? out_blocks(p.n_out) : 0;
  Ring ring{ring_base, bars, released, static_cast<const unsigned char*>(p.w), num_layers,
            (num_layers + nob) * CHUNKS, false, 4 * NWG, 0, nob};
  if (threadIdx.x == 0) init_ring(bars, released);
  __syncthreads();
  if (threadIdx.x == 0) ring.start();

  const int wg = warp >> 2, tid = threadIdx.x & (WG - 1), q = lane & 3;
  const int row0 = blockIdx.x * (NWG * WG_ROWS) + wg * WG_ROWS;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const RowTotals whole_rows{nullptr, 0, r0, q};
  unsigned char* tile = sm + wg * TILE_BYTES;
  const int tiles = (a.m + WG_ROWS - 1) / WG_ROWS, t64 = blockIdx.x * NWG + wg;
  const bool stash = p.h != nullptr && row0 < a.m;
  load_rows<WG>(smem_addr(tile), static_cast<const bf16*>(a.x), row0, a.m - row0, tid);
  cp_async_wait_all();
  fence_proxy_async();
  wg_bar(wg);
  if (stash && blockIdx.y == 0) save_tile<WG>(tile, a.x_img + (size_t)t64 * TILE_BYTES, TILE_BYTES, tid);

  float acc[4][32], mu[2], rstd[2];
  uint32_t unused[2][64];
  for (int l = 0; l < num_layers; ++l) {
    product_kmajor(acc, smem_addr(tile), ring, 0);
    layer_norm_rows(acc, p.bh + l * D, q, whole_rows, mu, rstd);
    affine_silu_rows<4, false, true>(acc, p.sc + l * D, p.bi + l * D, q, mu, rstd, unused);
    if (l + 1 < num_layers || stash || nob) {
      wg_bar(wg);  // every warp's products have read the tile
      store_rows(acc, tile, r0, q, 0);
      fence_proxy_async();
      wg_bar(wg);
      if (stash) save_tile<WG>(tile, p.h + ((size_t)l * tiles + t64) * TILE_BYTES, TILE_BYTES, tid);
    }
  }
  if (nob)
    output_blocks(acc, smem_addr(tile), ring, p, q, row0 + r0, a.m);
  else
    output_rows(acc, p, q, row0 + r0, row0 + r0 + 8, a.m);
}

// -- bf16 backward (K1b): the tile kernel --------------------------------------

constexpr int BWD_WGS = 4;                 // warpgroups of a tile, 64 columns each
constexpr int BWD_THREADS = BWD_WGS * WG;
constexpr size_t BWD_RING = 2 * TILE_BYTES;                       // after the h and dy tiles
constexpr size_t BWD_RED = BWD_RING + RING_STAGES * CHUNK_BYTES;  // 4 row groups x 3 x D f32 column sums
constexpr size_t BWD_XCH = BWD_RED + 4 * 3 * D * 4;               // row totals: 4 slots x 4 parts x 64 rows
constexpr size_t BWD_BARS = BWD_XCH + 4 * BWD_WGS * WG_ROWS * 4;
constexpr size_t BWD_SMEM = 1024 + BWD_BARS + RING_STAGES * 8;

// Block (tile, mlp): four warpgroups share the tile's 64 rows, each owning 64
// columns, so z and n of the layer in flight stay in registers and 16 warps
// hide each other's latency in the row-wise steps.  The h_l images come from
// the training forward (K1f); the ring streams, in the order the products
// take them: W_{L-1} (recompute of y_{L-1}), then for l = L-2 .. 0 W_l
// (recompute of y_l) and W_{l+1} (dh_l = dy_{l+1} W_{l+1}), then W_0
// (dx = dy_0 W_0); with WIDE, a wide output layer's blocks after W_{L-1}
// (dh_{L-1} = g wo).
template <bool WIDE>
__global__ void __launch_bounds__(BWD_THREADS, 1) fused_mlp_bwd_bf16_kernel(const __grid_constant__ Call a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int released[RING_STAGES];
  unsigned char* sm = align_1024(smem_raw);
  unsigned char* ht = sm;               // h_{l-1}: the A operand of y_l = h_{l-1} W_l^T
  unsigned char* dt = sm + TILE_BYTES;  // dy_l: the A operand of dh_{l-1} = dy_l W_l
  float* red = reinterpret_cast<float*>(sm + BWD_RED);
  const uint32_t bars = smem_addr(sm + BWD_BARS);
  const int mlp = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const Mlp& p = a.mlp[mlp];
  const int num_layers = a.num_layers, m = a.m;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nob = WIDE ? out_blocks(p.n_out) : 0;
  Ring ring{smem_addr(sm + BWD_RING), bars, released, static_cast<const unsigned char*>(p.w), num_layers,
            (2 * num_layers + nob) * CHUNKS, true, 4 * BWD_WGS, 0, nob};
  if (threadIdx.x == 0) init_ring(bars, released);
  __syncthreads();
  if (threadIdx.x == 0) ring.start();

  constexpr int NT = BWD_THREADS;
  constexpr int NC = 4 / BWD_WGS;  // 64-column blocks of a warpgroup
  const int tid = threadIdx.x, q = lane & 3, col0 = (warp >> 2) * 64 * NC;
  const int row0 = tile * WG_ROWS, rows = min(WG_ROWS, m - row0);
  const int r0 = (warp & 3) * 16 + (lane >> 2);
  const int row_a = row0 + r0, row_b = row_a + 8;
  const bool va = row_a < m, vb = row_b < m;
  const RowTotals parts{reinterpret_cast<float*>(sm + BWD_XCH), warp >> 2, r0, q};
  const bf16* x = static_cast<const bf16*>(a.x);
  auto consumers_bar = [] { __syncthreads(); };
  auto h_image = [&](int l) { return p.h + ((size_t)l * tiles + tile) * TILE_BYTES; };
  auto dy_image = [&](int l) { return p.dy + ((size_t)l * tiles + tile) * TILE_BYTES; };
  // h_{j} into the h tile (j = -1: x), asynchronously
  auto reload_h = [&](int j) {
    if (j < 0)
      load_rows<NT>(smem_addr(ht), x, row0, rows, tid);
    else
      reload_tile<NT>(smem_addr(ht), h_image(j), tid);
  };
  // the layer's column sums of the tile and its dy image, once dt and red are written
  auto finish_layer = [&](int l) {
    fence_proxy_async();
    consumers_bar();
    float* out = a.col_part + (((size_t)tile * a.num_mlps + mlp) * num_layers + l) * 3 * D;
    for (int e = tid; e < 3 * D; e += NT) out[e] = ((red[e] + red[3 * D + e]) + red[6 * D + e]) + red[9 * D + e];
    save_tile<NT>(dt, dy_image(l), TILE_BYTES, tid);
  };

  float acc[NC][32], mu[2], rstd[2];
  uint32_t zn[2][NC * 16];

  // y_{L-1} from the stashed h_{L-2}: z and n of the last layer
  const int last = num_layers - 1;
  reload_h(last - 1);
  cp_async_wait_all();
  fence_proxy_async();
  consumers_bar();
  product_kmajor(acc, smem_addr(ht), ring, col0);
  layer_norm_rows(acc, p.bh + last * D + col0, q, parts, mu, rstd);
  affine_silu_rows<NC, true, false>(acc, p.sc + last * D + col0, p.bi + last * D + col0, q, mu, rstd, zn);
  consumers_bar();  // every warp's products have read the h tile

  // the output layer: the cotangent's tile images (for dWo), the tile's sum
  // of g (the output bias gradient), dh_{L-1}; a wide layer block by block
  // through the dy tile, 256 columns at a time
  const bf16* g = static_cast<const bf16*>(p.io);
  const int n_out = p.n_out, ncb = g_col_blocks(n_out);
  const int block_cols = nob ? OUT_BLOCK : ncb * 64;
  float* bo_part = a.bo_part + ((size_t)tile * a.num_mlps + mlp) * a.bo_stride;
  if (nob) zero_acc(acc);
#pragma unroll 1
  for (int b = 0; b < max(nob, 1); ++b) {
    const int o0 = b * OUT_BLOCK;
    for (int e = tid; e < WG_ROWS * block_cols; e += NT) {
      const int r = e / block_cols, o = e % block_cols;
      const bf16 v = r < rows && o0 + o < n_out ? g[(size_t)(row0 + r) * n_out + o0 + o] : __float2bfloat16(0.f);
      *reinterpret_cast<bf16*>(dt + img_off(r, o)) = v;
    }
    if (nob) fence_proxy_async();  // wgmma reads the tile
    consumers_bar();
    for (int o = warp; o < block_cols && o0 + o < n_out; o += NT / 32) {  // rows past the input are zeros
      const float s = warp_sum(__bfloat162float(*reinterpret_cast<const bf16*>(dt + img_off(lane, o))) +
                               __bfloat162float(*reinterpret_cast<const bf16*>(dt + img_off(lane + 32, o))));
      if (lane == 0) bo_part[o0 + o] = s;
    }
    save_tile<NT>(dt, p.g_img + ((size_t)tile * ncb + 4 * b) * KC_BYTES, block_cols / 64 * KC_BYTES, tid);
    if (nob) {
      product_mnmajor<NC, true>(acc, smem_addr(dt), ring, col0);  // dh_{L-1} += g_b wo_b
      consumers_bar();  // every warp's products and copies have read the cotangent tile
    }
  }
  if (!nob) output_backward(acc, static_cast<const bf16*>(p.wo), n_out, dt, r0, q, col0);
  consumers_bar();  // the cotangent tile is saved and read
  if (num_layers >= 2) reload_h(num_layers - 3);
  ln_silu_backward(acc, zn, p.sc + (num_layers - 1) * D + col0, rstd, va, vb, red, lane, warp, col0, parts);
  store_rows(acc, dt, r0, q, col0);
  finish_layer(num_layers - 1);

  for (int l = num_layers - 2; l >= 0; --l) {
    cp_async_wait_all();  // h_{l-1} is in the h tile
    fence_proxy_async();
    consumers_bar();
    product_kmajor(acc, smem_addr(ht), ring, col0);  // y_l
    layer_norm_rows(acc, p.bh + l * D + col0, q, parts, mu, rstd);
    affine_silu_rows<NC, true, false>(acc, p.sc + l * D + col0, p.bi + l * D + col0, q, mu, rstd, zn);
    consumers_bar();  // every warp's products have read the h tile
    if (l >= 1) reload_h(l - 2);
    product_mnmajor(acc, smem_addr(dt), ring, col0);  // dh_l = dy_{l+1} W_{l+1}
    consumers_bar();  // every warp's products have read the dy tile
    ln_silu_backward(acc, zn, p.sc + l * D + col0, rstd, va, vb, red, lane, warp, col0, parts);
    store_rows(acc, dt, r0, q, col0);
    finish_layer(l);
  }

  // dx = dy_0 W_0: f32 per MLP, or the compute type for a single MLP
  product_mnmajor(acc, smem_addr(dt), ring, col0);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = col0 + col_of(c, i, q);
      if (a.dx_part) {
        float* out = a.dx_part + (size_t)mlp * m * D;
        if (va) *reinterpret_cast<float2*>(out + (size_t)row_a * D + col) = make_float2(acc[c][i * 4], acc[c][i * 4 + 1]);
        if (vb) *reinterpret_cast<float2*>(out + (size_t)row_b * D + col) = make_float2(acc[c][i * 4 + 2], acc[c][i * 4 + 3]);
      } else {
        bf16* out = static_cast<bf16*>(a.dx);
        if (va) *reinterpret_cast<uint32_t*>(out + (size_t)row_a * D + col) = pack_bf16(acc[c][i * 4], acc[c][i * 4 + 1]);
        if (vb) *reinterpret_cast<uint32_t*>(out + (size_t)row_b * D + col) = pack_bf16(acc[c][i * 4 + 2], acc[c][i * 4 + 3]);
      }
    }
}

// -- bf16 backward: dW as a split-M wgmma GEMM ----------------------------------

// Per MLP, jobs l < L: dW_l[n][k] = sum_rows dy_l[row][n] h_{l-1}[row][k]
// (h_{-1} = x), and l = L: dWo[o][k] = sum_rows g[row][o] h_{L-1}[row][k].
// Block (item, chunk): item walks the MLPs' jobs in order, dw_pairs(rows of
// the job) items each, item `pair` of a job owning its output rows 128 pair
// .. +127, two consumer warpgroups of 64 rows over all 256 columns; the rows
// of chunk `chunk` stream through a ring, each stage one 64-row tile: two
// column blocks of the dy image (A, read MN-major as dy^T) and the whole h
// image (B, MN-major).  Writes part[chunk][dw_row0 + l D + n][k].
constexpr int DW_STAGES = 4;
constexpr uint32_t DW_A_BYTES = 2 * KC_BYTES;
constexpr uint32_t DW_STAGE = DW_A_BYTES + TILE_BYTES;
constexpr size_t DW_SMEM = 1024 + DW_STAGES * DW_STAGE + 2 * DW_STAGES * 8;

struct DwArgs {
  Call call;
  float* part;
  int tiles;
  int chunk_tiles;
};

// The blocks of the dW GEMM: every job's dw_pairs.
int dw_items(const Call& c) {
  int items = 0;
  for (int i = 0; i < c.num_mlps; ++i) items += c.num_layers * dw_pairs(D) + dw_pairs(c.mlp[i].n_out);
  return items;
}

__global__ void __launch_bounds__(2 * WG + 32, 1) dw_bf16_kernel(const __grid_constant__ DwArgs a) {
  const int num_layers = a.call.num_layers, chunk = blockIdx.y;
  int item = blockIdx.x, mlp = 0;
  for (; mlp + 1 < a.call.num_mlps; ++mlp) {
    const int n = num_layers * dw_pairs(D) + dw_pairs(a.call.mlp[mlp].n_out);
    if (item < n) break;
    item -= n;
  }
  const Mlp& p = a.call.mlp[mlp];
  const int l = min(item / dw_pairs(D), num_layers);
  const int pair = item - l * dw_pairs(D);
  const unsigned char* a_img = l < num_layers ? p.dy + (size_t)l * a.tiles * TILE_BYTES : p.g_img;
  const unsigned char* b_img = l == 0 ? a.call.x_img : p.h + (size_t)(l - 1) * a.tiles * TILE_BYTES;
  const int ncb = l < num_layers ? 4 : g_col_blocks(p.n_out);  // 64-column blocks of A's images
  const int n_valid = l < num_layers ? D : p.n_out;
  const int nb0 = pair * 2;
  const int nwg = min(2, (n_valid + 63) / 64 - nb0);
  const int t0 = chunk * a.chunk_tiles, t1 = min(a.tiles, t0 + a.chunk_tiles);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1024(smem_raw);
  const uint32_t stages = smem_addr(sm), bars = stages + DW_STAGES * DW_STAGE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (DW_STAGES + s), 4 * nwg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      Producer prod{stages, bars, DW_STAGE, DW_STAGES, 0};
      for (int t = t0; t < t1; ++t) {
        uint32_t full;
        const uint32_t dst = prod.acquire(nwg * KC_BYTES + TILE_BYTES, full);
        bulk_load(dst, a_img + ((size_t)t * ncb + nb0) * KC_BYTES, nwg * KC_BYTES, full);
        bulk_load(dst + DW_A_BYTES, b_img + (size_t)t * TILE_BYTES, TILE_BYTES, full);
      }
    }
    return;
  }
  const int wg = warp >> 2;
  if (wg >= nwg) return;

  float acc[4][32];
  zero_acc(acc);
  int prev = -1;
  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) % DW_STAGES;
    mbar_wait(bars + 8 * s, ((t - t0) / DW_STAGES) & 1);
    const uint32_t st = stages + s * DW_STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n256<1, 1>(acc, sw128_desc(st + wg * KC_BYTES + ks * 2048, KC_BYTES, 1024),
                       sw128_desc(st + DW_A_BYTES + ks * 2048, KC_BYTES, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (DW_STAGES + prev));
    prev = s;
  }
  wgmma_wait<0>();
  if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (DW_STAGES + prev));
  fence_acc(acc);

  const int q = lane & 3;
  const int n_a = (nb0 + wg) * 64 + (warp & 3) * 16 + (lane >> 2), n_b = n_a + 8;
  float* out = a.part + ((size_t)chunk * a.call.dw_rows + p.dw_row0 + l * D) * D;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = col_of(c, i, q);
      if (n_a < n_valid) *reinterpret_cast<float2*>(out + (size_t)n_a * D + col) = make_float2(acc[c][i * 4], acc[c][i * 4 + 1]);
      if (n_b < n_valid) *reinterpret_cast<float2*>(out + (size_t)n_b * D + col) = make_float2(acc[c][i * 4 + 2], acc[c][i * 4 + 3]);
    }
}

// -- f32 body ----------------------------------------------------------------------
//
// Thread (ty, tx) owns rows ty*8 .. ty*8+7 of the tile for the row-wise steps
// and columns tx*4 .. tx*4+3 and 128+tx*4 .. 128+tx*4+3; one warp owns whole
// rows, so the LayerNorm reductions are warp shuffles.
__device__ __forceinline__ int col32(int tx, int j) { return (j < 4 ? 0 : 128) + tx * 4 + (j & 3); }

// y (8 values of one row, bias not yet added) -> z = LN(y + b) * scale +
// shift, n = the normalised value; returns the row's 1/std.
__device__ __forceinline__ float layer_norm32(float (&y)[8], int tx, const float* bias, const float* scale,
                                              const float* shift, float (&z)[8], float (&n)[8]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    y[j] += bias[col32(tx, j)];
    s += y[j];
  }
  const float mu = warp_sum(s) * (1.f / D);
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = y[j] - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) * (1.f / D) + LN_EPS);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col32(tx, j);
    n[j] = (y[j] - mu) * rstd;
    z[j] = n[j] * scale[c] + shift[c];
  }
  return rstd;
}

// acc = hs (TILE_M x D, stride HS32) . w (D x D as [k][n], global) with FMAs,
// thread (ty, tx) holding rows ty*8+i and columns col32(tx, j).  Starts with a
// barrier (hs is written, ws is free) and ends with one (every warp is done
// reading hs and ws).
__device__ __forceinline__ void tile_product_f32(const float* hs, const float* __restrict__ w, float* ws,
                                                 float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KC32) {
    __syncthreads();
    for (int i = tid; i < KC32 * D; i += THREADS) ws[i] = w[(size_t)k0 * D + i];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC32; ++kk) {
      float av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = hs[(ty * 8 + i) * HS32 + k0 + kk];
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk * D + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk * D + 128 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// Rows row0 .. row0 + rows - 1 of x (m x D) into the tile; zeros past them.
__device__ __forceinline__ void load_tile32(const float* __restrict__ x, int row0, int rows, float* hs) {
  for (int i = threadIdx.x; i < TILE_M * D; i += THREADS) {
    const int r = i / D, c = i % D;
    hs[r * HS32 + c] = r < rows ? x[(size_t)(row0 + r) * D + c] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 2) fused_mlp_fwd_f32_kernel(const __grid_constant__ Call a) {
  extern __shared__ __align__(128) float smem32[];
  float* hs = smem32;                // TILE_M x HS32 activation tile
  float* ws = smem32 + TILE_M * HS32;  // KC32 x D weight chunk
  const Mlp& p = a.mlp[blockIdx.y];
  const float* wh = static_cast<const float*>(p.w);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * TILE_M, rows = min(TILE_M, a.m - row0);
  load_tile32(static_cast<const float*>(a.x), row0, rows, hs);

  for (int l = 0; l < a.num_layers; ++l) {
    float acc[8][8];
    tile_product_f32(hs, wh + (size_t)l * D * D, ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float z[8], n[8];
      layer_norm32(acc[i], tx, p.bh + l * D, p.sc + l * D, p.bi + l * D, z, n);
#pragma unroll
      for (int j = 0; j < 8; ++j) hs[(ty * 8 + i) * HS32 + col32(tx, j)] = z[j] * sigmoid(z[j]);
    }
  }
  __syncthreads();  // hs holds the last hidden layer
  const float* wo = static_cast<const float*>(p.wo);
  float* out = static_cast<float*>(p.io);
  // a warp's threads take one output's row of wo (a broadcast) over
  // consecutive rows of hs (HS32 = 257: no bank conflicts)
  for (int idx = threadIdx.x; idx < rows * p.n_out; idx += THREADS) {
    const int o = idx / rows, r = idx % rows;
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = fmaf(hs[r * HS32 + k], wo[(size_t)o * D + k], s);
    out[(size_t)(row0 + r) * p.n_out + o] = s + p.bo[o];
  }
}

// Per (tile, mlp): the forward recompute stashing h_0 .. h_{L-1}, then for
// l = L-1 .. 0: dh_l (from g, or dy_{l+1} W_{l+1}), the recompute of y_l from
// the stashed h_{l-1}, the LayerNorm and SiLU backward to dy_l (stashed) and
// the tile's column sums; then dx = dy_0 W_0.
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_bwd_f32_kernel(const __grid_constant__ Call a) {
  extern __shared__ __align__(128) float smem32[];
  float* hs = smem32;
  float* ws = hs + TILE_M * HS32;
  float* red = ws + KC32 * D;  // 3 x 8 x D: per-warp column sums
  const int mlp = blockIdx.y, tile = blockIdx.x, m = a.m, num_layers = a.num_layers;
  const Mlp& p = a.mlp[mlp];
  const float* x = static_cast<const float*>(a.x);
  const float* wh = static_cast<const float*>(p.w);
  const float* wt = static_cast<const float*>(p.wt);
  const float* wo = static_cast<const float*>(p.wo);
  const float* g = static_cast<const float*>(p.io);
  float* h_stash = reinterpret_cast<float*>(p.h);
  float* dy_stash = reinterpret_cast<float*>(p.dy);
  const int n_out = p.n_out;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = tile * TILE_M, rows = min(TILE_M, m - row0);

  load_tile32(x, row0, rows, hs);
  float acc[8][8], dh[8][8];
  for (int l = 0; l < num_layers; ++l) {
    tile_product_f32(hs, wh + (size_t)l * D * D, ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      float z[8], n[8];
      layer_norm32(acc[i], tx, p.bh + l * D, p.sc + l * D, p.bi + l * D, z, n);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float h = z[j] * sigmoid(z[j]);
        hs[r * HS32 + col32(tx, j)] = h;
        if (r < rows) h_stash[((size_t)l * m + row0 + r) * D + col32(tx, j)] = h;
      }
    }
  }
  for (int o = tid; o < n_out; o += THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += g[(size_t)(row0 + r) * n_out + o];
    a.bo_part[((size_t)tile * a.num_mlps + mlp) * a.bo_stride + o] = s;
  }
  __syncthreads();  // the stash is visible to the block

  for (int l = num_layers - 1; l >= 0; --l) {
    if (l + 1 < num_layers) tile_product_f32(hs, wt + (size_t)(l + 1) * D * D, ws, dh);  // hs holds dy_{l+1}
    load_tile32(l == 0 ? x : h_stash + (size_t)(l - 1) * m * D, row0, rows, hs);
    tile_product_f32(hs, wh + (size_t)l * D * D, ws, acc);  // y_l
    float dsc[8], dbi[8], dbh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dsc[j] = dbi[j] = dbh[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      const bool valid = r < rows;
      float z[8], n[8], dhr[8];
      const float rstd = layer_norm32(acc[i], tx, p.bh + l * D, p.sc + l * D, p.bi + l * D, z, n);
      if (l + 1 == num_layers) {  // the output layer: dh = g . wo
#pragma unroll
        for (int j = 0; j < 8; ++j) dhr[j] = 0.f;
        if (valid)
          for (int o = 0; o < n_out; ++o) {
            const float gv = g[(size_t)(row0 + r) * n_out + o];
#pragma unroll
            for (int j = 0; j < 8; ++j) dhr[j] = fmaf(gv, wo[(size_t)o * D + col32(tx, j)], dhr[j]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dhr[j] = dh[i][j];
      }
      float dn[8], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sig = sigmoid(z[j]);
        const float dz = valid ? dhr[j] * (sig * (1.f + z[j] * (1.f - sig))) : 0.f;
        dsc[j] += dz * n[j];
        dbi[j] += dz;
        dn[j] = dz * p.sc[l * D + col32(tx, j)];
        s1 += dn[j];
        s2 += dn[j] * n[j];
      }
      const float mean_dn = warp_sum(s1) * (1.f / D), mean_dnn = warp_sum(s2) * (1.f / D);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dy = rstd * (dn[j] - mean_dn - n[j] * mean_dnn);
        dbh[j] += dy;
        hs[r * HS32 + col32(tx, j)] = dy;  // the A operand of dh_{l-1} = dy_l W_l
        if (valid) dy_stash[((size_t)l * m + row0 + r) * D + col32(tx, j)] = dy;
      }
    }
    // the tile's column sums, warp partials summed in a fixed order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[(0 * 8 + ty) * D + col32(tx, j)] = dsc[j];
      red[(1 * 8 + ty) * D + col32(tx, j)] = dbi[j];
      red[(2 * 8 + ty) * D + col32(tx, j)] = dbh[j];
    }
    __syncthreads();
    for (int idx = tid; idx < 3 * D; idx += THREADS) {
      const int qn = idx / D, c = idx % D;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[(qn * 8 + w) * D + c];
      a.col_part[(((size_t)tile * a.num_mlps + mlp) * num_layers + l) * 3 * D + idx] = s;
    }
  }

  tile_product_f32(hs, wt, ws, acc);  // dx = dy_0 W_0
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t off = (size_t)(row0 + r) * D + col32(tx, j);
      if (a.dx_part)
        a.dx_part[(size_t)mlp * m * D + off] = acc[i][j];
      else
        static_cast<float*>(a.dx)[off] = acc[i][j];
    }
  }
}

// part[s][dw_row0 + l D + i][j] = sum over rows k of chunk s of A[k][i]
// B[k][j] with FMAs; job = mlp * (L + 1) + l: l < L: A = dy_l, B = x or
// h_{l-1}; l = L: A = g (n_out wide), B = h_{L-1}.  A block computes 64 x 64
// outputs; thread (tid / 16, tid % 16) holds 4 x 4.
constexpr int DWF_K = 32;

__global__ void __launch_bounds__(THREADS) dw_f32_kernel(const __grid_constant__ Call a, float* part,
                                                         int chunk_rows, int chunks) {
  __shared__ __align__(16) float as[DWF_K][64];
  __shared__ __align__(16) float bs[DWF_K][64];
  const int num_layers = a.num_layers, m = a.m;
  const int job = blockIdx.z / chunks, s = blockIdx.z % chunks;
  const Mlp& p = a.mlp[job / (num_layers + 1)];
  const int l = job % (num_layers + 1);
  const float* A = l < num_layers ? reinterpret_cast<const float*>(p.dy) + (size_t)l * m * D
                                  : static_cast<const float*>(p.io);
  const int na = l < num_layers ? D : p.n_out;
  const float* B = l == 0 ? static_cast<const float*>(a.x) : reinterpret_cast<const float*>(p.h) + (size_t)(l - 1) * m * D;
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * 64;
  if (i0 >= na) return;
  const int k_begin = s * chunk_rows, k_end = min(m, k_begin + chunk_rows);

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
      as[r][c] = in && i0 + c < na ? A[(size_t)(k0 + r) * na + i0 + c] : 0.f;
      bs[r][c] = in ? B[(size_t)(k0 + r) * D + j0 + c] : 0.f;
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
  float* out = part + ((size_t)s * a.dw_rows + p.dw_row0 + l * D) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ti * 4 + i;
    if (row >= na) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(size_t)row * D + j0 + tj * 4 + j] = acc[i][j];
  }
}

// out[i] = sum over p < num_parts of part[p * n + i], in a fixed order: eight
// running sums over blocks of eight parts (eight loads in flight), the rest
// added to the first, then the eight summed in order.
template <typename T>
__global__ void reduce_partials_kernel(const float* __restrict__ part, int num_parts, size_t n, T* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int p = 0;
  for (; p + 8 <= num_parts; p += 8)
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] += part[(size_t)(p + k) * n + i];
  for (; p < num_parts; ++p) s[0] += part[(size_t)p * n + i];
  store(out + i, ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7])));
}

// A row-major (m, D) bf16 matrix as 64-row tile images (zero rows past m).
__global__ void to_images_kernel(const bf16* __restrict__ src, int m, unsigned char* __restrict__ img) {
  const size_t unit = (size_t)blockIdx.x * THREADS + threadIdx.x;  // 16-byte unit of the padded matrix
  const int row = (int)(unit / (D / 8)), col = (int)(unit % (D / 8)) * 8;
  if (row >= (m + 63) / 64 * 64) return;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row < m) v = *reinterpret_cast<const uint4*>(src + (size_t)row * D + col);
  *reinterpret_cast<uint4*>(img + (size_t)(row / 64) * TILE_BYTES + img_off(row % 64, col)) = v;
}

// -- host side -------------------------------------------------------------------

int num_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t align_up(size_t n) { return (n + 255) & ~(size_t)255; }

constexpr int PTRS = 9;  // addresses per MLP in the pointer table

// ptrs: per MLP (w, wt, bh, sc, bi, wo, bo, io, h) as integers.
Call make_call(const void* x, void* x_img, int m, int num_layers, int num_mlps, const long long* ptrs,
               const int* n_outs) {
  Call c{};
  c.x = x;
  c.x_img = static_cast<unsigned char*>(x_img);
  c.m = m;
  c.num_layers = num_layers;
  c.num_mlps = num_mlps;
  c.bo_stride = 1;
  c.dw_rows = 0;
  for (int i = 0; i < num_mlps; ++i) {
    const long long* q = ptrs + PTRS * i;
    Mlp& p = c.mlp[i];
    p.w = reinterpret_cast<const void*>(q[0]);
    p.wt = reinterpret_cast<const void*>(q[1]);
    p.bh = reinterpret_cast<const float*>(q[2]);
    p.sc = reinterpret_cast<const float*>(q[3]);
    p.bi = reinterpret_cast<const float*>(q[4]);
    p.wo = reinterpret_cast<const void*>(q[5]);
    p.bo = reinterpret_cast<const float*>(q[6]);
    p.io = reinterpret_cast<void*>(q[7]);
    p.h = reinterpret_cast<unsigned char*>(q[8]);
    p.n_out = n_outs[i];
    p.dw_row0 = c.dw_rows;
    c.dw_rows += num_layers * D + p.n_out;
    c.bo_stride = p.n_out > c.bo_stride ? p.n_out : c.bo_stride;
  }
  return c;
}

// The backward's scratch, carved from one workspace in this order.
struct BwdWorkspace {
  int tiles, chunks, chunk;  // chunk: tiles (bf16) or rows (f32) per dW chunk
  size_t h[MAX_MLPS], dy[MAX_MLPS], g[MAX_MLPS], col_part, bo_part, dw_part, dx_part, bytes;

  BwdWorkspace(int is_bf16, int m, int num_layers, int num_mlps, const int* n_outs) {
    int bo_stride = 1, dw_rows = 0;
    for (int i = 0; i < num_mlps; ++i) {
      bo_stride = n_outs[i] > bo_stride ? n_outs[i] : bo_stride;
      dw_rows += num_layers * D + n_outs[i];
    }
    tiles = (m + 63) / 64;
    if (is_bf16) {
      const int target = tiles < 16 ? tiles : 16;
      chunk = (tiles + target - 1) / target;
      chunks = (tiles + chunk - 1) / chunk;
    } else {
      const int c = (m + 15) / 16;
      chunk = c < 64 ? 64 : (c + 63) / 64 * 64;
      chunks = (m + chunk - 1) / chunk;
    }
    size_t off = 0;
    auto take = [&](size_t len) {
      const size_t at = off;
      off += align_up(len);
      return at;
    };
    // bf16: the h images come from the training forward
    const size_t stash = is_bf16 ? (size_t)num_layers * tiles * TILE_BYTES : (size_t)num_layers * m * D * 4;
    for (int i = 0; i < num_mlps; ++i) {
      h[i] = take(is_bf16 ? 0 : stash);
      dy[i] = take(stash);
      g[i] = take(is_bf16 ? (size_t)tiles * g_col_blocks(n_outs[i]) * KC_BYTES : 0);
    }
    col_part = take((size_t)tiles * num_mlps * num_layers * 3 * D * 4);
    bo_part = take((size_t)tiles * num_mlps * bo_stride * 4);
    dw_part = take((size_t)chunks * dw_rows * D * 4);
    dx_part = take(num_mlps > 1 ? (size_t)num_mlps * m * D * 4 : 0);
    bytes = off;
  }
};

template <typename T>
int reduce_parts(const float* part, int num_parts, size_t n, T* out, cudaStream_t stream) {
  reduce_partials_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(part, num_parts, n, out);
  return (int)cudaGetLastError();
}

// Whether an MLP of the call has a wide output layer.
bool wide(const Call& c) {
  for (int i = 0; i < c.num_mlps; ++i)
    if (out_blocks(c.mlp[i].n_out)) return true;
  return false;
}

template <int NWG>
int launch_fwd(const Call& c, bool is_wide, dim3 grid, cudaStream_t stream) {
  const auto kernel = is_wide ? fused_mlp_fwd_bf16_kernel<NWG, true> : fused_mlp_fwd_bf16_kernel<NWG, false>;
  const cudaError_t err = allow_smem(kernel, fwd_smem<NWG>());
  if (err) return (int)err;
  kernel<<<grid, NWG * WG, fwd_smem<NWG>(), stream>>>(c);
  return (int)cudaGetLastError();
}

int forward(int is_bf16, const Call& c, cudaStream_t stream) {
  cudaError_t err;
  if (!is_bf16) {
    if ((err = allow_smem(fused_mlp_fwd_f32_kernel, SMEM32))) return (int)err;
    fused_mlp_fwd_f32_kernel<<<dim3((c.m + TILE_M - 1) / TILE_M, c.num_mlps), THREADS, SMEM32, stream>>>(c);
    return (int)cudaGetLastError();
  }
  const int tiles128 = (c.m + 2 * WG_ROWS - 1) / (2 * WG_ROWS);
  if (tiles128 * c.num_mlps >= num_sms()) return launch_fwd<2>(c, wide(c), dim3(tiles128, c.num_mlps), stream);
  return launch_fwd<1>(c, wide(c), dim3((c.m + WG_ROWS - 1) / WG_ROWS, c.num_mlps), stream);
}

int backward(int is_bf16, Call& c, char* workspace, const int* n_outs, float* dw, float* dcols, float* dbo,
             cudaStream_t stream) {
  const int m = c.m, num_layers = c.num_layers, num_mlps = c.num_mlps;
  const BwdWorkspace w(is_bf16, m, num_layers, num_mlps, n_outs);
  const int jobs = num_mlps * (num_layers + 1);
  int widest = D;
  for (int i = 0; i < num_mlps; ++i) widest = n_outs[i] > widest ? n_outs[i] : widest;
  for (int i = 0; i < num_mlps; ++i) {
    if (!is_bf16) c.mlp[i].h = reinterpret_cast<unsigned char*>(workspace + w.h[i]);
    c.mlp[i].dy = reinterpret_cast<unsigned char*>(workspace + w.dy[i]);
    c.mlp[i].g_img = reinterpret_cast<unsigned char*>(workspace + w.g[i]);
  }
  c.col_part = reinterpret_cast<float*>(workspace + w.col_part);
  c.bo_part = reinterpret_cast<float*>(workspace + w.bo_part);
  c.dx_part = num_mlps > 1 ? reinterpret_cast<float*>(workspace + w.dx_part) : nullptr;
  float* dw_part = reinterpret_cast<float*>(workspace + w.dw_part);

  cudaError_t err;
  if (is_bf16) {
    const auto tile_kernel = wide(c) ? fused_mlp_bwd_bf16_kernel<true> : fused_mlp_bwd_bf16_kernel<false>;
    if ((err = allow_smem(tile_kernel, BWD_SMEM))) return (int)err;
    tile_kernel<<<dim3(w.tiles, num_mlps), BWD_THREADS, BWD_SMEM, stream>>>(c);
    if ((err = cudaGetLastError())) return (int)err;
    if ((err = allow_smem(dw_bf16_kernel, DW_SMEM))) return (int)err;
    const DwArgs da{c, dw_part, w.tiles, w.chunk};
    dw_bf16_kernel<<<dim3(dw_items(c), w.chunks), 2 * WG + 32, DW_SMEM, stream>>>(da);
  } else {
    if ((err = allow_smem(fused_mlp_bwd_f32_kernel, SMEM32_BWD))) return (int)err;
    fused_mlp_bwd_f32_kernel<<<dim3(w.tiles, num_mlps), THREADS, SMEM32_BWD, stream>>>(c);
    if ((err = cudaGetLastError())) return (int)err;
    dw_f32_kernel<<<dim3((widest + 63) / 64, D / 64, jobs * w.chunks), THREADS, 0, stream>>>(c, dw_part, w.chunk,
                                                                                         w.chunks);
  }
  if ((err = cudaGetLastError())) return (int)err;
  int e;
  if ((e = reduce_parts(dw_part, w.chunks, (size_t)c.dw_rows * D, dw, stream))) return e;
  if ((e = reduce_parts(c.col_part, w.tiles, (size_t)num_mlps * num_layers * 3 * D, dcols, stream))) return e;
  if ((e = reduce_parts(c.bo_part, w.tiles, (size_t)num_mlps * c.bo_stride, dbo, stream))) return e;
  if (num_mlps > 1) {
    if (is_bf16) return reduce_parts(c.dx_part, num_mlps, (size_t)m * D, static_cast<bf16*>(c.dx), stream);
    return reduce_parts(c.dx_part, num_mlps, (size_t)m * D, static_cast<float*>(c.dx), stream);
  }
  return 0;
}

}  // namespace

extern "C" {

// The feature width, the most MLPs of one call, the widest output layer of
// the register path and the outputs of a wide layer's block, as the kernels
// are compiled.
int sihl_fused_mlp_width() { return D; }
int sihl_fused_mlp_max_mlps() { return MAX_MLPS; }
int sihl_fused_mlp_narrow_out() { return NARROW_OUT; }
int sihl_fused_mlp_out_block() { return OUT_BLOCK; }

// The forward of num_mlps MLPs of num_layers hidden layers over m >= 1 rows
// of x (m, D), in one launch.  is_bf16 selects __nv_bfloat16 for x, the
// weights and the outputs, else float.  ptrs holds, per MLP, the addresses
// of (w, wt, bh, sc, bi, wo, bo, out, h): w the packed hidden-weight image
// (bf16) or (L, D, D) as [in][out] (f32), wt (f32 only) the same as
// [out][in], biases and LayerNorm parameters (L, D) f32, wo (n_out, D) in the
// compute type, bo (n_out) f32, out (m, n_out); n_out >= 1, any width (bf16:
// w holds a wide output layer's blocks after the hidden layers).  bf16 only, for the
// backward: h (L tile images of sihl_fused_mlp_tile_bytes(m) each) and x_img
// (one such image) receive the stash, or are null.  Launches on `stream`
// without synchronising and returns the cudaError_t of the launch.
int sihl_fused_mlp_fwd(int is_bf16, const void* x, void* x_img, int m, int num_layers, int num_mlps,
                       const long long* ptrs, const int* n_outs, void* stream) {
  const Call c = make_call(x, x_img, m, num_layers, num_mlps, ptrs, n_outs);
  return forward(is_bf16, c, static_cast<cudaStream_t>(stream));
}

// Bytes of one layer's stash of m rows as 64-row tile images (bf16).
size_t sihl_fused_mlp_tile_bytes(int m) { return (size_t)((m + WG_ROWS - 1) / WG_ROWS) * TILE_BYTES; }

// Bytes of device scratch that sihl_fused_mlp_bwd needs for these sizes.
size_t sihl_fused_mlp_bwd_workspace(int is_bf16, int m, int num_layers, int num_mlps, const int* n_outs) {
  return BwdWorkspace(is_bf16, m, num_layers, num_mlps, n_outs).bytes;
}

// The backward of the same MLPs given each output's cotangent (the `out`
// slot of ptrs holds g, (m, n_out) in the compute type) and, in bf16, the
// stash that their training forward wrote (h and x_img).  Writes f32 dw
// (sum over the MLPs of L x D + n_out rows, D): per MLP in order the hidden
// weights' gradients in the Linear layout [out][in], then the output
// weight's, n_out rows; dcols (num_mlps, L, 3, D): the LayerNorm scale,
// LayerNorm shift and hidden bias gradients; dbo (num_mlps, widest n_out):
// the output bias gradient in the first n_out entries of its row; dx (m, D)
// in the compute type, summed over the MLPs in
// order.  workspace holds sihl_fused_mlp_bwd_workspace bytes, 256-byte
// aligned.  Launches on `stream` without synchronising and returns the first
// cudaError_t.
int sihl_fused_mlp_bwd(int is_bf16, const void* x, void* x_img, int m, int num_layers, int num_mlps,
                       const long long* ptrs, const int* n_outs, void* workspace, float* dw, float* dcols,
                       float* dbo, void* dx, void* stream) {
  Call c = make_call(x, x_img, m, num_layers, num_mlps, ptrs, n_outs);
  c.dx = dx;
  return backward(is_bf16, c, static_cast<char*>(workspace), n_outs, dw, dcols, dbo,
                  static_cast<cudaStream_t>(stream));
}

// Bytes of scratch for sihl_fused_mlp_dw_alone.
size_t sihl_fused_mlp_dw_alone_workspace(int m) {
  const int n_out = 1;
  const BwdWorkspace w(1, m, 1, 1, &n_out);
  return 2 * align_up((size_t)w.tiles * TILE_BYTES) + (size_t)w.chunks * 2 * D * D * 4;
}

// The bf16 dW GEMM alone, for tests: out (D, D) f32 = dy^T h for row-major
// bf16 h and dy (m, D), through the same tile images, kernel and fixed-order
// reduction as the backward.
int sihl_fused_mlp_dw_alone(const void* h, const void* dy, int m, void* workspace, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_out = 1;
  const BwdWorkspace w(1, m, 1, 1, &n_out);
  char* base = static_cast<char*>(workspace);
  const size_t img = align_up((size_t)w.tiles * TILE_BYTES);
  Call c{};
  c.m = m;
  c.num_layers = 1;
  c.num_mlps = 1;
  c.dw_rows = D;  // the hidden job alone: its two items
  c.mlp[0].n_out = 1;
  c.x_img = reinterpret_cast<unsigned char*>(base);
  c.mlp[0].dy = reinterpret_cast<unsigned char*>(base + img);
  const unsigned units = (unsigned)((size_t)w.tiles * 64 * D / 8);
  to_images_kernel<<<(units + THREADS - 1) / THREADS, THREADS, 0, s>>>(static_cast<const bf16*>(h), m, c.x_img);
  to_images_kernel<<<(units + THREADS - 1) / THREADS, THREADS, 0, s>>>(static_cast<const bf16*>(dy), m, c.mlp[0].dy);
  cudaError_t err;
  if ((err = cudaGetLastError())) return (int)err;
  if ((err = allow_smem(dw_bf16_kernel, DW_SMEM))) return (int)err;
  float* part = reinterpret_cast<float*>(base + 2 * img);
  const DwArgs da{c, part, w.tiles, w.chunk};
  dw_bf16_kernel<<<dim3(dw_pairs(D), w.chunks), 2 * WG + 32, DW_SMEM, s>>>(da);
  if ((err = cudaGetLastError())) return (int)err;
  return reduce_parts(part, w.chunks, (size_t)D * D, out, s);
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
