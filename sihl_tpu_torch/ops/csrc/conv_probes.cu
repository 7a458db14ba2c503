// The flagship backbone's stage-1/2 convolutions as tensor-core GEMMs, for
// Hopper (sm_90a): the three conv probes of the JAX package's tools/.  bf16
// operands, f32 sums, each bf16 output rounded once.
//
// matmul_stats_kernel (P4) replaces tools/probe_conv1x1_pallas.py:build_pallas
// (:79, kernel _mm_kernel :64): y = x w for x (M, 64) and w (64, 256) bf16,
// y (M, 256) bf16 rounded once from the f32 sum; with STATS, also BatchNorm's
// per-channel sum and sum of squares of y taken from the f32 accumulators
// before rounding.  Bound: at the probe's shape (M = 16 * 160 * 160) it reads
// 52.4 MB and writes 209.7 MB, 0.078 ms at 3.35 TB/s, against 13.4 GFLOP,
// 0.014 ms at 989 TFLOP/s: bytes, four fifths of them y's writes.  Design:
// persistent blocks (one an SM) walk the 64-row tiles of x.  A producer warp
// keeps a four-stage ring of x tiles full by 2-D TMA (one thread, full and
// empty mbarriers); w (32 KB) arrives once by TMA and stays in shared memory
// as wgmma's MN-major B operand.  Two consumer warpgroups take each tile, one
// half of the columns each (m64n128k16, K-major A), and round y into one of
// four staging buffers of a whole tile, laid out as one TMA box of a 3-D view
// of y (64 rows by four 64-column chunks, 128-byte swizzle), so that one
// thread stores the tile as a single contiguous 32 KB run (cp.async.bulk.tensor,
// one bulk group a tile).  Three tiles' stores are in flight while the next
// is multiplied; a buffer is written again only after
// cp.async.bulk.wait_group.read says its store has read it.  Whole rows
// contiguous and the deeper staging measured faster than each warpgroup
// storing its own half-row boxes (0.094-0.096 ms against 0.100 alone on an
// H100 SXM at 700 W), though four rows of one parity share the banks of a
// staging store (python -m sihl_tpu_torch.tools.probe_conv_variants times
// the alternatives).  TMA zero-fills the
// rows of x past M and clips the stores there, so the ragged last tile needs
// no masks; a zero row of x gives a zero row of y, so the sums are right
// too.  The statistics stay in registers across the block's tiles: a
// warpgroup's thread holds 32 columns of two rows, so its sum and sum of
// squares are 64 registers beside the 64 of the accumulator.  At the end a
// fixed shuffle tree and a fixed pass over the warps make one (2, 256)
// partial per block, and sum_partials_kernel adds the partials in a fixed
// order, so the sums are bitwise the same from call to call (no atomics).
//
// weight_grad_kernel (P5) replaces tools/probe_wrt_filter.py:build_pallas
// (:78, kernel _acc_kernel :66): dW = x^T dy in f32 for x (M, ci) and
// dy (M, co) bf16, ci a multiple of 64 and co of 256.  Bound: bytes, reading
// x and dy once (0.078, 0.039 and 0.031 ms at the probe's three shapes; the
// products take 0.014 ms).  Design: the TPU carries one accumulator across
// its sequential row grid, which the card's blocks do not have.  A block owns
// a TI x 256 tile of dW (TI = 128 where ci allows, else 64) and one
// contiguous split of the rows; as many blocks run as fit on the card at
// once, those of one group of splits next to each other so that they read
// the operand they share close together in time (L2).  A producer warp
// brings 64-row chunks of x and dy by 2-D TMA (64-column boxes, 128-byte
// swizzle) into a four-stage ring with full and empty mbarriers.  Two
// consumer warpgroups multiply each chunk with wgmma on both operands as
// MN-major shared descriptors (A = x^T, B = dy): at TI = 128 each owns 64 ci
// by all 256 co (m64n256k16), at TI = 64 each owns 128 co (m64n128k16).  A
// stage is released to the producer once the next chunk's products are
// issued.  Rows past M arrive as zeros and add nothing.  The f32 partials
// are what the splits cost in bytes (one dW tile a split), so four blocks
// with consecutive splits of a tile form a cluster: each stages its tile in
// its ring, and each adds a quarter of the rows of the four tiles through
// distributed shared memory in rank order, one partial a cluster.
// sum_partials_kernel adds a tile's partials in a fixed order (no atomics,
// bitwise repeatable); it is launched as a programmatic dependent of the
// products (so is P4's), which hides its launch gap.
//
// conv3x3_kernel (P2) replaces tools/probe_conv3x3_pallas.py:build_pallas
// (:89, kernel _conv_kernel :59): the stride-1 SAME 3x3 conv of x
// (B, H, W, 64) NHWC bf16 by w (3, 3, 64, 64) HWIO bf16, y NHWC bf16 rounded
// once from the f32 sum over the 9 taps and 64 channels.  Bound: 104.9 MB
// (0.031 ms at 3.35 TB/s) and 30.2 GFLOP (0.031 ms at 989 TFLOP/s) at
// batch 16, 160 x 160: balanced, so the tensor cores must run at about half
// their peak while the bytes stream.  Design: the TPU probe fed pre-haloed
// row slabs because its BlockSpec blocks cannot overlap; here persistent
// blocks (one an SM) walk output tiles of 2 rows by 64 columns.  A producer
// warp brings each tile's 4 x 66 pixel halo by one 4-D TMA box of x
// (channels, columns, rows, images) that starts a row and a column before
// the tile: TMA's zeros outside the image are the SAME padding, so no load
// is masked.  The halos go into a three-stage mbarrier ring, so that the
// next two land while this one is multiplied.  All nine taps' weights
// (72 KB) arrive once by TMA and stay as wgmma's MN-major B operand.  A
// pixel's 64 channels are one 128-byte row of the swizzle pattern, so tap
// (ky, kx) of an output row is the halo's 64 consecutive rows from pixel
// (row + ky, kx): a K-major A descriptor that starts inside a pattern
// (wgmma swizzles by address, as TMA does).  No im2col copy: the
// taps re-read the halo in shared memory.  Two consumer warpgroups take a
// block's tiles in turn (one multiplies while the other stores), each a
// tile's 2 x 9 x 4 m64n64k16 products into f32 registers, then y rounded
// once into its staging buffer as a TMA box, stored by one thread and
// clipped at the image's edge.  At W = 160 the third column tile holds 32
// pixels: a sixth of the products are padding.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder lives in libcuda, looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int BOX = 8192;                // one TMA box: 64 rows of 64 bf16 (128 bytes), 128-byte swizzle

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- mbarriers, TMA and wgmma --

__device__ __forceinline__ uint32_t align_1024(uint32_t addr) { return (addr + 1023u) & ~1023u; }

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
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Waits for the phase of bar with this parity to complete.  A wait of more
// than 5 s can only be a ring that lost count: trap (a launch error) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  uint64_t start = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (++spins & 0xFFFu) == 0) {
      if (start == 0)
        start = globaltimer_ns();
      else if (globaltimer_ns() - start > 5000000000ull)
        __trap();
    }
  }
}

// The 64 x 64 box of `map` whose first element is (row, col) into shared dst,
// reported to bar; rows past the matrix's end arrive as zeros (and count).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}
// Shared src into the box of `map` at (row, col); rows past the end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(col), "r"(row), "r"(src)
               : "memory");
}
// Shared src into the box of y_map (a 3-D view of y: 64 columns, 4 chunks,
// rows) whose first row is row; rows past the end are not written.
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map, uint32_t src, int row) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(0), "r"(row), "r"(src)
               : "memory");
}
// The box of a 4-D `map` whose first element is (c0, c1, c2, c3) into shared
// dst, reported to bar; elements outside the tensor (coordinates below 0 or
// past its end) arrive as zeros (and count).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// Shared src into the box of a 4-D `map` at (c0, c1, c2, c3); elements
// outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until at most N of this thread's store groups are still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// Programmatic dependent launch: the next grid on the stream may be
// scheduled once every block of this one has called grid_dependents_go (or
// ended); that grid's grid_dependency_wait returns once this one is
// complete and its writes are visible.
__device__ __forceinline__ void grid_dependents_go() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// the barrier of a block's consumer warpgroups, its first THREADS threads (named barrier 3)
template <int THREADS>
__device__ __forceinline__ void consumers_bar() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(THREADS) : "memory");
}

// the barrier of one warpgroup's 128 threads (named barrier 1 + wg)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");
}

// every thread of every block of the cluster, with release / acquire order
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of shared address addr in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
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

template <int NC>
__device__ __forceinline__ void zero_acc(float (&d)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[c][i] = 0.f;
  fence_acc(d);
}

// A shared-memory matrix descriptor, 128-byte swizzle.  lbo: bytes between
// 64-element atoms along MN (MN-major operands); sbo: bytes between groups of
// 8 rows (K-major) or of 8 K (MN-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
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

// d (+)= A . B for one 64 x 128 x 16 step; A and B from shared memory through
// their descriptors, TA / TB = 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[2][32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (+)= A . B for one 64 x 64 x 16 step; A and B from shared memory through
// their descriptors, TA / TB = 1 for an MN-major operand.  The accumulator
// layout as wgmma's below, with one 64-column chunk.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (+)= A . B over 64 NC columns (NC = 2 or 4).  The accumulator layout:
// thread t of the warpgroup holds rows r0 = 16 (t / 32) + (t % 32) / 4 and
// r0 + 8; d[c][4 i + j] is row r0 + 8 (j / 2), column 64 c + 8 i + 2 (t % 4)
// + j % 2.
template <int NC, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[NC][32], uint64_t da, uint64_t db) {
  static_assert(NC == 2 || NC == 4, "m64n128k16 or m64n256k16");
  if constexpr (NC == 4)
    wgmma_n256<TA, TB>(d, da, db);
  else
    wgmma_n128<TA, TB>(d, da, db);
}

// out[i] = the sum over p of partials[p * n + i], n = 4 n4 floats.  Thread
// (g, c) of a block sums parts g, g + 8, g + 16, ... of float4 column c in
// that order, then group 0 adds the eight group sums in order: the order
// depends on the part count alone, so the sums are the same from call to
// call, and 256 threads share a column block's parts.
constexpr int REDUCE_GROUPS = 8, REDUCE_COLS = 32;

__global__ void __launch_bounds__(REDUCE_GROUPS * REDUCE_COLS)
sum_partials_kernel(const float4* __restrict__ partials, int parts, long long n4, float4* __restrict__ out) {
  __shared__ float4 red[REDUCE_GROUPS][REDUCE_COLS];
  grid_dependency_wait();  // launched early: the partials are complete from here
  const int c = threadIdx.x % REDUCE_COLS, g = threadIdx.x / REDUCE_COLS;
  const long long i = (long long)blockIdx.x * REDUCE_COLS + c;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) {
#pragma unroll 4
    for (int p = g; p < parts; p += REDUCE_GROUPS) {
      const float4 v = partials[(size_t)p * n4 + i];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
  }
  red[g][c] = t;
  __syncthreads();
  if (g == 0 && i < n4) {
#pragma unroll
    for (int h = 1; h < REDUCE_GROUPS; ++h) {
      const float4 v = red[h][c];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    out[i] = t;
  }
}

// n a multiple of 4, partials and out 16-byte aligned.  A programmatic
// dependent launch: its blocks may start while the kernel before it on the
// stream finishes (which lets them go with grid_dependents_go), and wait
// for that grid's completion before they read, so the launch gap is hidden.
int sum_partials(const float* partials, int parts, long long n, float* out, cudaStream_t stream) {
  const long long n4 = n / 4;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n4 + REDUCE_COLS - 1) / REDUCE_COLS));
  cfg.blockDim = dim3(REDUCE_GROUPS * REDUCE_COLS);
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, sum_partials_kernel, reinterpret_cast<const float4*>(partials), parts, n4,
                                 reinterpret_cast<float4*>(out));
}

// ------------------------------------------------------------- P4: matmul_stats

namespace p4 {

constexpr int K = 64, N = 256, TM = 64;  // x (M, 64) by w (64, 256), 64-row tiles
constexpr int WGS = 2;                   // consumer warpgroups, each N / WGS columns of every tile
constexpr int COLS = N / WGS, NC = COLS / 64;
constexpr int THREADS = WGS * WG + 32;   // and a producer warp
constexpr int STAGES = 4;                // x tiles in the ring, a box each
constexpr int W_BYTES = (N / 64) * BOX;  // w as four 64-column boxes: 32 KB
constexpr int PART = NC * BOX;           // a warpgroup's COLS columns of w
constexpr int Y_TILE = TM * N * 2;       // a staged y tile: 32 KB
constexpr int Y_BUFS = 4;                // staging buffers: three stores in flight while one is staged
constexpr int Y_BYTES = Y_BUFS * Y_TILE;
constexpr int SMEM = 1024 + W_BYTES + STAGES * BOX + Y_BYTES + (2 * STAGES + 1) * 8;

template <bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
matmul_stats_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap y_map, long long m, float* __restrict__ partials) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), base = align_1024(raw);
  const uint32_t w_s = base, x_s = w_s + W_BYTES, y_s = x_s + STAGES * BOX, bars = y_s + Y_BYTES;
  const uint32_t w_bar = bars + 8 * 2 * STAGES;  // after full[STAGES], empty[STAGES]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tiles = (m + TM - 1) / TM;
  const int mine = (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);  // tiles blockIdx.x + n gridDim.x

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), WGS * WG / 32);  // each consumer warp releases it
    }
    mbar_init(w_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WGS * WG / 32) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(w_bar, W_BYTES);
      for (int b = 0; b < N / 64; ++b) tma_load(w_s + b * BOX, &w_map, 64 * b, 0, w_bar);
      for (int n = 0; n < mine; ++n) {
        const int s = n % STAGES;
        mbar_wait(bars + 8 * (STAGES + s), ((n / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(bars + 8 * s, BOX);
        tma_load(x_s + s * BOX, &x_map, 0, (int)((blockIdx.x + (long long)n * gridDim.x) * TM), bars + 8 * s);
      }
    }
    return;
  }

  // warpgroup wg owns columns COLS wg .. COLS wg + COLS - 1 of every tile
  const int wg = warp >> 2, tid = threadIdx.x & (WG - 1), q = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // this thread's rows r0 and r0 + 8 of a tile
  const uint32_t b_s = w_s + wg * PART;
  float s1[NC][16], s2[NC][16];  // STATS: column COLS wg + 64 c + 8 i + 2 q + j at [c][2 i + j]
  if (STATS) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < 16; ++k) s1[c][k] = s2[c][k] = 0.f;
  }
  mbar_wait(w_bar, 0);

  for (int n = 0; n < mine; ++n) {
    const int s = n % STAGES;
    const int row0 = (int)((blockIdx.x + (long long)n * gridDim.x) * TM);
    mbar_wait(bars + 8 * s, (n / STAGES) & 1);
    float acc[NC][32];
    zero_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks)
      wgmma<NC, 0, 1>(acc, sw128_desc(x_s + s * BOX + ks * 32, 16, 1024), sw128_desc(b_s + ks * 2048, BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));  // the x tile is read

    if (STATS) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float a = acc[c][4 * i + j], b = acc[c][4 * i + 2 + j];
            s1[c][2 * i + j] += a + b;
            s2[c][2 * i + j] += a * a + b * b;
          }
    }

    // y rounded once into staging buffer n % Y_BUFS: the whole tile as one
    // TMA box of 64 rows by four 64-column chunks, so that its store is one
    // contiguous 32 KB run of y.  128-byte segment s = 4 row + chunk holds
    // its 16-byte unit u at u ^ (s % 8) (TMA's 128-byte swizzle).  The
    // buffer is free once the store of tile n - Y_BUFS has read it.
    const uint32_t buf = y_s + (n % Y_BUFS) * Y_TILE;
    if (threadIdx.x == 0) bulk_wait_read<Y_BUFS - 1>();
    consumers_bar<WGS * WG>();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int seg = 4 * (r0 + 8 * h) + NC * wg + c;
          st_shared(buf + seg * 128 + ((i ^ (seg & 7)) << 4) + q * 4,
                    pack_bf16(acc[c][4 * i + 2 * h], acc[c][4 * i + 2 * h + 1]));
        }
    fence_proxy_async();
    consumers_bar<WGS * WG>();
    if (threadIdx.x == 0) {
      tma_store_rows(&y_map, buf, row0);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_read<0>();  // the stores have read the staging buffers; they complete with the grid
  grid_dependents_go();

  if (STATS) {
    // the 8 lanes of a column (lane >> 2 = 0..7) in a fixed tree, then the
    // warpgroup's four warps in order, through its half of the staging buffers
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < 16; ++k)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[c][k] += __shfl_xor_sync(0xffffffffu, s1[c][k], off);
          s2[c][k] += __shfl_xor_sync(0xffffffffu, s2[c][k], off);
        }
    consumers_bar<WGS * WG>();  // the stores have read the staging buffers (thread 0 waited)
    float* red = reinterpret_cast<float*>(smem_raw + (y_s - raw) + wg * (Y_BYTES / WGS));  // [warp][stat][COLS]
    if (lane < 4) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = 64 * c + 8 * i + 2 * lane + j;
            red[((warp & 3) * 2 + 0) * COLS + col] = s1[c][2 * i + j];
            red[((warp & 3) * 2 + 1) * COLS + col] = s2[c][2 * i + j];
          }
    }
    wg_bar(wg);
    for (int e = tid; e < 2 * COLS; e += WG) {
      const int stat = e / COLS, col = e % COLS;
      float v = red[stat * COLS + col];
#pragma unroll
      for (int w = 1; w < 4; ++w) v += red[(w * 2 + stat) * COLS + col];
      partials[(size_t)blockIdx.x * 2 * N + stat * N + COLS * wg + col] = v;
    }
  }
}

}  // namespace p4

// --------------------------------------------------------- P5: weight_grad_1x1

namespace p5 {

constexpr int TK = 64;      // rows of x and dy a chunk: one box's rows
constexpr int TO = 256;     // co of a block's dW tile
constexpr int STAGES = 4;
constexpr int CL = 4;       // blocks of a cluster: consecutive splits of one tile
constexpr int THREADS = 2 * WG + 32;  // two consumer warpgroups and a producer warp

// TI = 128: warpgroup g owns ci rows 64 g .. 64 g + 63 of the tile by all 256
// co (m64n256k16); TI = 64: both own the 64 ci rows, g co 128 g .. 128 g + 127
// (m64n128k16).  A stage holds the chunk's TI / 64 boxes of x, then its four
// boxes of dy.  At the end the ring holds the block's f32 tile, rows of ROW
// floats (padded so that the accumulator layout's stores meet no conflicts
// beyond two wavefronts a float2).
template <int TI>
struct Tile {
  static constexpr int X_BOXES = TI / 64;
  static constexpr int STAGE = (X_BOXES + TO / 64) * BOX;
  static constexpr int NC = TI == 128 ? 4 : 2;  // 64-column accumulator chunks a warpgroup
  static constexpr int ROW = TO + 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(TI * ROW * 4 <= STAGES * STAGE, "the f32 tile fits in the ring");
  static_assert(TI % CL == 0, "each block of a cluster adds whole rows");
};

// Block b is rank b % CL of cluster b / CL.  The cluster takes tile
// (b / CL) % tiles (ci tile fastest) and the CL splits from CL ((b / CL) /
// tiles), rank r the one from that plus r: chunks [chunks * split / splits,
// chunks * (split + 1) / splits) of 64 rows.  The cluster adds its CL tiles
// through distributed shared memory in rank order, rank r rows r TI / CL ..
// (r + 1) TI / CL - 1, into partials[split / CL].
template <int TI>
__global__ void __launch_bounds__(THREADS, 1)
weight_grad_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap dy_map,
                   long long m, int ci, int co, int splits, float* __restrict__ partials) {
  using T = Tile<TI>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw), stages = align_1024(raw), bars = stages + STAGES * T::STAGE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i_tiles = ci / TI, tiles = i_tiles * (co / TO);
  const int rank = (int)(blockIdx.x % CL), cluster = (int)(blockIdx.x / CL);
  const int tile = cluster % tiles, split = CL * (cluster / tiles) + rank;
  const int i0 = (tile % i_tiles) * TI, o0 = (tile / i_tiles) * TO;
  const long long chunks = (m + TK - 1) / TK;
  const long long c0 = chunks * split / splits, c1 = chunks * (split + 1) / splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 2 * WG / 32);  // each consumer warp releases it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 2 * WG / 32) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      for (long long c = c0; c < c1; ++c) {
        const int n = (int)(c - c0), s = n % STAGES;
        const uint32_t full = bars + 8 * s, dst = stages + s * T::STAGE;
        mbar_wait(bars + 8 * (STAGES + s), ((n / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full, T::STAGE);
        const int row = (int)(c * TK);
#pragma unroll
        for (int b = 0; b < T::X_BOXES; ++b) tma_load(dst + b * BOX, &x_map, i0 + 64 * b, row, full);
#pragma unroll
        for (int b = 0; b < TO / 64; ++b) tma_load(dst + (T::X_BOXES + b) * BOX, &dy_map, o0 + 64 * b, row, full);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp >> 2;
    float acc[T::NC][32];
    zero_acc(acc);
    int prev = -1;
    for (long long c = c0; c < c1; ++c) {
      const int n = (int)(c - c0), s = n % STAGES;
      mbar_wait(bars + 8 * s, (n / STAGES) & 1);
      const uint32_t st = stages + s * T::STAGE;
      const uint32_t a = st + (TI == 128 ? wg * BOX : 0);                         // x^T: MN-major, 64 ci
      const uint32_t b = st + T::X_BOXES * BOX + (TI == 128 ? 0 : wg * 2 * BOX);  // dy: MN-major
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks)
        wgmma<T::NC, 1, 1>(acc, sw128_desc(a + ks * 2048, BOX, 1024), sw128_desc(b + ks * 2048, BOX, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: release its stage
      if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (STAGES + prev));
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // the block's tile into the ring, once both warpgroups are done reading it
    consumers_bar<2 * WG>();
    float* staged = reinterpret_cast<float*>(smem_raw + (stages - raw));
    const int q = lane & 3;
    const int row = (TI == 128 ? 64 * wg : 0) + 16 * (warp & 3) + (lane >> 2);
    const int col0 = (TI == 128 ? 0 : 128 * wg) + 2 * q;
#pragma unroll
    for (int c = 0; c < T::NC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = col0 + 64 * c + 8 * i;
        *reinterpret_cast<float2*>(staged + row * T::ROW + col) = make_float2(acc[c][4 * i], acc[c][4 * i + 1]);
        *reinterpret_cast<float2*>(staged + (row + 8) * T::ROW + col) =
            make_float2(acc[c][4 * i + 2], acc[c][4 * i + 3]);
      }
  }

  grid_dependents_go();
  cluster_sync();  // every tile of the cluster is staged
  constexpr int ROWS = TI / CL;
  float4* out = reinterpret_cast<float4*>(partials + (size_t)(split / CL) * ci * co);
  for (int e = threadIdx.x; e < ROWS * TO / 4; e += THREADS) {
    const int r = rank * ROWS + e / (TO / 4), c4 = e % (TO / 4);
    const uint32_t at = stages + (uint32_t)(r * T::ROW + 4 * c4) * 4;
    float4 sum = ld_cluster_f4(cluster_addr(at, 0));
#pragma unroll
    for (int p = 1; p < CL; ++p) {
      const float4 v = ld_cluster_f4(cluster_addr(at, p));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    out[((size_t)(i0 + r) * co + o0) / 4 + c4] = sum;
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// The launch configuration: blocks of THREADS in clusters of CL.
template <int TI>
cudaLaunchConfig_t config(unsigned blocks, cudaStream_t stream, cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = CL;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<TI>::SMEM;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of weight_grad_kernel<TI> that fit on the card at once; 0 or less
// is minus a cudaError_t.  Allows the kernel its shared memory on the
// current device first.
template <int TI>
long long resident_clusters() {
  cudaError_t err = cudaFuncSetAttribute(weight_grad_kernel<TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<TI>::SMEM);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = config<TI>(CL, nullptr, &cluster);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, weight_grad_kernel<TI>, &cfg);
  if (err != cudaSuccess) return -(long long)err;
  return clusters;
}

template <int TI>
int launch(const CUtensorMap& x_map, const CUtensorMap& dy_map, long long m, int ci, int co, int splits,
           float* partials, cudaStream_t stream) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = config<TI>((unsigned)((ci / TI) * (co / TO) * splits), stream, &cluster);
  return (int)cudaLaunchKernelEx(&cfg, weight_grad_kernel<TI>, x_map, dy_map, m, ci, co, splits, partials);
}

}  // namespace p5

// ------------------------------------------------------------------ P2: conv3x3

namespace p2 {

constexpr int C = 64;                    // input and output channels: a pixel is one 128-byte swizzle row
constexpr int TR = 2, TC = 64;           // output rows and columns of a tile; a row's TC pixels are one wgmma M
constexpr int HR = TR + 2, HC = TC + 2;  // the halo's rows and columns
constexpr int HALO = HR * HC * C * 2;    // 33 KB, one TMA box
constexpr int W_BYTES = 9 * BOX;         // the nine taps' 64 x 64 matrices: 72 KB
constexpr int STAGES = 3;                // halos in the ring
constexpr int WGS = 2;                   // consumer warpgroups, taking the block's tiles in turn
constexpr int THREADS = WGS * WG + 32;   // and a producer warp
constexpr int Y_TILE = TR * TC * C * 2;  // a staged y tile: 16 KB
constexpr int Y_BUFS = 1;                // staging buffers of each warpgroup
constexpr int SMEM = 1024 + W_BYTES + STAGES * HALO + WGS * Y_BUFS * Y_TILE + (2 * STAGES + 1) * 8;
static_assert(HALO % 1024 == 0 && Y_TILE % 1024 == 0, "every buffer starts a swizzle pattern");
static_assert(SMEM <= 232448, "fits an SM's shared memory");

// Tile t of the walk: image bi, output rows r0 .. r0 + TR - 1, columns c0 .. c0 + TC - 1 (columns fastest).
__device__ __forceinline__ void tile_origin(long long t, int tiles_h, int tiles_w, int& bi, int& r0, int& c0) {
  const long long per_image = (long long)tiles_h * tiles_w;
  bi = (int)(t / per_image);
  const int rem = (int)(t % per_image);
  r0 = (rem / tiles_w) * TR;
  c0 = (rem % tiles_w) * TC;
}

// Block b takes tiles b, b + gridDim.x, ...; its n-th tile lands in ring
// stage n % STAGES and goes to consumer warpgroup n % WGS.
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap y_map, int b, int h, int wd) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = align_1024(smem_addr(smem_raw));
  const uint32_t w_s = base, x_s = w_s + W_BYTES, y_s = x_s + STAGES * HALO, bars = y_s + WGS * Y_BUFS * Y_TILE;
  const uint32_t w_bar = bars + 8 * 2 * STAGES;  // after full[STAGES], empty[STAGES]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_h = (h + TR - 1) / TR, tiles_w = (wd + TC - 1) / TC;
  const long long tiles = (long long)b * tiles_h * tiles_w;
  const int mine = (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), WG / 32);  // the consuming warpgroup's warps release it
    }
    mbar_init(w_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WGS * WG / 32) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(w_bar, W_BYTES);
      for (int t = 0; t < 9; ++t) tma_load(w_s + t * BOX, &w_map, 0, t * C, w_bar);
      for (int n = 0; n < mine; ++n) {
        const int s = n % STAGES;
        int bi, r0, c0;
        tile_origin(blockIdx.x + (long long)n * gridDim.x, tiles_h, tiles_w, bi, r0, c0);
        mbar_wait(bars + 8 * (STAGES + s), ((n / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(bars + 8 * s, HALO);
        // the halo starts one row and one column before the tile: TMA's
        // zeros outside the image are the SAME padding
        tma_load_4d(x_s + s * HALO, &x_map, 0, c0 - 1, r0 - 1, bi, bars + 8 * s);
      }
    }
    return;
  }

  const int wg = warp >> 2, q = lane & 3;
  const int p0 = 16 * (warp & 3) + (lane >> 2);  // this thread's pixels p0 and p0 + 8 of each tile row
  const bool leader = (threadIdx.x & (WG - 1)) == 0;  // starts and waits for the warpgroup's stores
  mbar_wait(w_bar, 0);

  for (int n = wg; n < mine; n += WGS) {
    const int s = n % STAGES;
    int bi, r0, c0;
    tile_origin(blockIdx.x + (long long)n * gridDim.x, tiles_h, tiles_w, bi, r0, c0);
    // A parity names one of two phases.  The stage's previous tile, n -
    // STAGES, is the other warpgroup's, and its halo may land after this
    // warpgroup's own later ones: wait until that tile has left the stage,
    // so that the full barrier's phase before this tile's is complete and
    // the parity names this tile's.  (The empty barrier's phase before
    // that, tile n - 2 STAGES, was this warpgroup's own.)
    if (n >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((n / STAGES) - 1) & 1);
    mbar_wait(bars + 8 * s, (n / STAGES) & 1);
    // tap (ky, kx) of output row r reads the halo's row r + ky from pixel
    // kx on: 64 consecutive 128-byte rows of the box, a K-major A whose
    // first row lies anywhere inside a 1024-byte swizzle pattern.  wgmma
    // swizzles by the shared address itself, as TMA does when it writes the
    // halo, so such a start needs nothing more: the descriptor's base-offset
    // field stays 0 (with the start's row in the pattern, (addr >> 7) & 7,
    // there, every tap of a one-tile test read wrong values on an H100).
    const uint32_t halo = x_s + s * HALO;
    float acc[TR][32];
    zero_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
#pragma unroll
        for (int r = 0; r < TR; ++r)
          wgmma_n64<0, 1>(acc[r], sw128_desc(halo + ((r + tap / 3) * HC + tap % 3) * 128 + ks * 32, 16, 1024),
                          sw128_desc(w_s + tap * BOX + ks * 2048, BOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));  // the halo is read

    // y rounded once into the warpgroup's staging buffer, laid out as the
    // store's TMA box: row r's pixel p at 128-byte row r TC + p, its 16-byte
    // unit u at u ^ (p % 8) (TMA's 128-byte swizzle).  The buffer is free
    // once the store of the warpgroup's tile Y_BUFS before has read it.
    const uint32_t buf = y_s + (wg * Y_BUFS + (n / WGS) % Y_BUFS) * Y_TILE;
    if (leader) bulk_wait_read<Y_BUFS - 1>();
    wg_bar(wg);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r * TC + p0 + 8 * hh;
          st_shared(buf + row * 128 + ((i ^ (row & 7)) << 4) + q * 4,
                    pack_bf16(acc[r][4 * i + 2 * hh], acc[r][4 * i + 2 * hh + 1]));
        }
    fence_proxy_async();
    wg_bar(wg);
    if (leader) {
      tma_store_4d(&y_map, buf, 0, c0, r0, bi);  // clipped at the image's edges
      bulk_commit();
    }
  }
  if (leader) bulk_wait_read<0>();  // the stores have read the staging buffers; they complete with the grid
}

}  // namespace p2

// Blocks of `kernel` that fit on the card at once (resident per SM times
// SMs), after allowing it `smem` bytes of dynamic shared memory; 0 or less
// is minus a cudaError_t.
template <typename Kernel>
long long resident_blocks(Kernel kernel, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (this
// library links the runtime alone).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of the row-major bf16 matrix at base, (rows, cols), moved in boxes
// of 64 rows by 64 columns with 128-byte swizzle.  False if there is no
// encoder or it refuses (base or row stride not a multiple of 16 bytes).
bool bf16_map(CUtensorMap* map, const void* base, long long rows, long long cols) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64}, steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of y, (rows, 256) bf16, as the 3-D array (rows, 4, 64), stored in
// boxes of 64 rows by all four 64-column chunks (each row's 512 bytes) with
// 128-byte swizzle.
bool y_rows_map(CUtensorMap* map, void* y, long long rows) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {64, 4, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {128, 512};
  const cuuint32_t box[3] = {64, 4, 64}, steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, y, dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A map of the NHWC bf16 image at base, (b, h, wd, 64), as the 4-D array
// (channels, columns, rows, images), moved in boxes of all 64 channels by
// `cols` columns by `rows` rows of one image, 128-byte swizzle: a pixel is
// one 128-byte row of the box.
bool image_map(CUtensorMap* map, const void* base, int b, int h, int wd, int cols, int rows,
               CUtensorMapL2promotion promotion) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {128, (cuuint64_t)wd * 128, (cuuint64_t)h * wd * 128};
  const cuuint32_t box[4] = {64, (cuuint32_t)cols, (cuuint32_t)rows, 1}, steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool STATS>
int launch_p4(const void* x, const void* w, long long m, void* y, float* partials, float* sums, int blocks,
              cudaStream_t stream) {
  CUtensorMap x_map, w_map, y_map;
  if (!bf16_map(&x_map, x, m, p4::K) || !bf16_map(&w_map, w, p4::K, p4::N) || !y_rows_map(&y_map, y, m))
    return (int)cudaErrorInvalidValue;
  p4::matmul_stats_kernel<STATS><<<blocks, p4::THREADS, p4::SMEM, stream>>>(x_map, w_map, y_map, m, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return STATS ? sum_partials(partials, blocks, 2 * p4::N, sums, stream) : 0;
}

}  // namespace

extern "C" {

// Blocks of sihl_probe_matmul_stats that fit on the card at once.  0 or
// less is minus a cudaError_t.  Also allows the kernel its shared memory on
// the current device, which sihl_probe_matmul_stats needs (the wrapper asks
// once a device).
long long sihl_probe_matmul_resident(int stats) {
  return stats ? resident_blocks(p4::matmul_stats_kernel<true>, p4::THREADS, p4::SMEM)
               : resident_blocks(p4::matmul_stats_kernel<false>, p4::THREADS, p4::SMEM);
}

// x: (m, 64) bf16; w: (64, 256) bf16; y: (m, 256) bf16, all 16-byte
// aligned; with stats, partials: (blocks, 2, 256) f32 scratch and sums:
// (2, 256) f32, the sum and the sum of squares of each column of y before
// rounding.  Block b takes the 64-row tiles b, b + blocks, ...; blocks at
// most the tile count.  One launch (two with stats) on `stream` without
// synchronising; returns the first cudaError_t that is not cudaSuccess.
int sihl_probe_matmul_stats(int stats, const void* x, const void* w, long long m, void* y, float* partials,
                            float* sums, long long blocks, void* stream) {
  if (m < 1 || m >= (1ll << 31) || blocks < 1 || blocks > (m + p4::TM - 1) / p4::TM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return stats ? launch_p4<true>(x, w, m, y, partials, sums, (int)blocks, st)
               : launch_p4<false>(x, w, m, y, nullptr, nullptr, (int)blocks, st);
}

// Clusters of sihl_probe_weight_grad's kernel for dW tiles of ti (64 or
// 128) rows that fit on the card at once.  0 or less is minus a
// cudaError_t.  Also allows that kernel its shared memory on the current
// device, which sihl_probe_weight_grad needs (the wrapper asks once a
// device).
long long sihl_probe_weight_grad_resident(int ti) {
  return ti == 128 ? p5::resident_clusters<128>() : p5::resident_clusters<64>();
}

// x: (m, ci) bf16, dy: (m, co) bf16, 16-byte aligned, ci a multiple of ti
// (64 or 128) and co of 256; splits a multiple of the cluster size 4;
// partials: (splits / 4, ci, co) f32 scratch; dw: (ci, co) f32 = x^T dy.
// (ci / ti) (co / 256) splits blocks, each one ti x 256 tile of dW over one
// split of the 64-row chunks, a cluster's four splits added into one
// partial, then the sum of the partials.  phases: 1 the products alone, 2
// the sum alone, 3 both.  On `stream` without synchronising; returns the
// first cudaError_t that is not cudaSuccess.
int sihl_probe_weight_grad(const void* x, const void* dy, long long m, int ci, int co, int ti, long long splits,
                           float* partials, float* dw, int phases, void* stream) {
  if (m < 1 || m >= (1ll << 31) || (ti != 64 && ti != 128) || ci < ti || co < p5::TO || ci % ti ||
      co % p5::TO || splits < p5::CL || splits % p5::CL ||
      (long long)(ci / ti) * (co / p5::TO) * splits >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phases & 1) {
    CUtensorMap x_map, dy_map;
    if (!bf16_map(&x_map, x, m, ci) || !bf16_map(&dy_map, dy, m, co)) return (int)cudaErrorInvalidValue;
    const int err = ti == 128 ? p5::launch<128>(x_map, dy_map, m, ci, co, (int)splits, partials, st)
                              : p5::launch<64>(x_map, dy_map, m, ci, co, (int)splits, partials, st);
    if (err) return err;
  }
  return phases & 2 ? sum_partials(partials, (int)(splits / p5::CL), (long long)ci * co, dw, st) : 0;
}

// Blocks of sihl_probe_conv3x3's kernel that fit on the card at once.  0 or
// less is minus a cudaError_t.  Also allows the kernel its shared memory on
// the current device, which sihl_probe_conv3x3 needs (the wrapper asks once
// a device).
long long sihl_probe_conv3x3_resident() { return resident_blocks(p2::conv3x3_kernel, p2::THREADS, p2::SMEM); }

// x: (b, h, wd, 64) NHWC bf16; w: (3, 3, 64, 64) HWIO bf16; y: (b, h, wd, 64)
// NHWC bf16, the stride-1 SAME conv; all 16-byte aligned.  Block k takes the
// tiles of TR x TC output pixels k, k + blocks, ... (columns fastest, then
// rows, then images); blocks at most the tile count.  One launch on `stream`
// without synchronising; returns the first cudaError_t that is not
// cudaSuccess.
int sihl_probe_conv3x3(const void* x, const void* w, int b, int h, int wd, void* y, long long blocks, void* stream) {
  const long long tiles = (long long)b * ((h + p2::TR - 1) / p2::TR) * ((wd + p2::TC - 1) / p2::TC);
  if (b < 1 || h < 1 || wd < 1 || blocks < 1 || blocks > tiles || blocks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, w_map, y_map;
  if (!image_map(&x_map, x, b, h, wd, p2::HC, p2::HR, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !bf16_map(&w_map, w, 9 * p2::C, p2::C) ||
      !image_map(&y_map, y, b, h, wd, p2::TC, p2::TR, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return (int)cudaErrorInvalidValue;
  p2::conv3x3_kernel<<<(unsigned)blocks, p2::THREADS, p2::SMEM, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, y_map, b, h, wd);
  return (int)cudaGetLastError();
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
