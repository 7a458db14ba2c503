// Dynamic per-instance pointwise decode (CondInst masks, FCPose heatmaps),
// forward (K5f) and backward (K5b), for Hopper (sm_90a).
//
// Replaces the TPU kernels of sihl_tpu/ops/pallas/dynconv.py: _fwd_kernel
// (launched by _decode_fwd_impl) and _bwd_kernel (launched by
// _decode_vjp_bwd).  Per image b, instance i and pixel s of a (B, S, c)
// feature map, with the instance's P weights in _split's layout:
//
//     x1 = f_s . W1f + (g_s - center_i) . W1c + b1    h1 = silu(x1)
//     x2 = h1 . W2 + b2                               h2 = silu(x2)
//     out = h2 . W3 + b3                              (k outputs, f32)
//
// The TPU kernel packs 128 / c instances block-diagonally into its matrix
// unit's lanes (_block_diag, _pack); that packing only fills the MXU and is
// not carried over.  Here the (B, I, S, c) hidden activations never reach
// device memory: the only large write is the logits themselves.
//
// K5f, bf16 features and weights: decode_fwd_mma_kernel<C, ONE_OUT>, on the
// tensor cores.  What bounds it: per pixel-instance, 2c SiLUs, each an
// exponential and a reciprocal on the special-function unit (16 results a
// clock per SM), once the products move to the tensor cores: at c = 8, 32
// SFU operations against 4 bytes of logits written.  The design:
//  - A block takes a strip of one image's pixels and a group of that
//    image's instances (the plan comes from ops/dynconv.py:decode_plan).
//    Each warp owns TILES tiles of 16 pixels of a row of the strip and keeps,
//    for the whole instance loop, each tile's layer-1 A fragments in
//    registers: the bf16 features, loaded as 32-bit pairs straight from the
//    (B, S, c) tensor, and one more k-slab for the grid term, the pixel's gx
//    and gy each split exactly into three bf16 parts.  At c = 8 (the
//    instance path) a block is 4 warps x 4 tiles (256 pixels) and up to 16
//    instances, six blocks an SM; at c = 32, 8 warps x 1 tile in 5 rows
//    (640 pixels) and up to 6 instances, three blocks an SM: the staging of
//    an instance's 1,656 words is then spread over 640 pixels, and 24 warps
//    an SM hide the latency of a tile's long chain (the plans read fastest
//    of those tried on the card).
//  - The group's weights are staged once, in shared memory: first one copy
//    of the group's bf16 weights as they lie in memory (4-byte loads, all in
//    flight), then from it the slots: layer 1 (W1f, and W1c's rows against
//    the grid slab), W2 and (at k > 1) W3 as bf16 B fragments in fragment
//    order, so that each fragment register is one conflict-free 32-bit
//    ld.shared; b1 - center . W1c (the TPU kernel's b1_eff), b2, W3 at k = 1
//    and b3 in f32.  The fragments are copied bit for bit and the f32
//    vectors widened by a shift: no conversion instruction.
//  - Per instance and tile: layer 1 is mma.sync (m16n8k16 over the features
//    and the grid slab at c = 8; two m16n8k16 and one m16n8k8 over each of
//    four n-tiles at c = 32) from b1_eff; SiLU on the accumulator fragment;
//    layer 2 takes h1 straight from the registers, since an f32 accumulator
//    fragment (rows g, g + 8, columns 2t, 2t + 1) is laid out as the A
//    fragment of the next product.  h1 is split exactly into three bf16
//    parts by bit masks (hi is h1 with its low 16 bits cleared, mid the same
//    of h1 - hi, lo of what is left, at most 8 significant bits), packed in
//    pairs by __byte_perm, and each part times W2 (bf16, exact) accumulates
//    into one f32 fragment: f32 inputs to a bf16 product, with no rounding
//    but the f32 sums'.  Then b2 and SiLU; at k = 1, layer 3 is two FMAs a
//    row and column pair and a scatter-sum across the quad's four lanes,
//    which leaves each lane the logits of its own pixels (coalesced
//    stores); at k > 1, layer 3 is the same three-part product over up to
//    three n-tiles, and a tile's 16 x k logits, contiguous in the output,
//    go through shared memory to coalesced stores.
//  - SiLU is x * rcp.approx(1 + ex2.approx(-x log2 e)): one exponential
//    and one reciprocal on the SFU, no division (within 1e-4 of the plain
//    chain; tanh.approx's error would not be).
//  - Every sum has a fixed order and there are no atomics: two calls are
//    bitwise equal.
// K5f, f32 features and weights: decode_fwd_kernel<C>, f32 FMAs, one thread
// a pixel walking the instances of its block, whose weights sit in shared
// memory as f32 (an instance's 169 floats at c = 8 are read by every thread
// of a warp at once, a broadcast).
//
// The backward (K5b), in f32 FMAs for both input types, recomputes the
// forward and does about three times its work.  It has two reductions that
// the TPU does on a sequential grid axis (the weight gradients, summed over
// spatial tiles in VMEM) and outside the kernel (d(features), summed over
// instance groups).  Blocks on the card run at once and in no order, so:
//  1. decode_bwd_tile_kernel, per (spatial tile of TS pixels, group of up
//     to 32 instances, image), one instance after the other, with the
//     weights in shared memory (the whole group's at c = 8, one instance's
//     at a time at c = 32): each thread recomputes x1, x2 for its pixel (as
//     _bwd_kernel does; nothing is stashed from the forward), backpropagates
//     through the three layers (dsilu = s * (1 + x * (1 - s))), accumulates
//     d(features) over the group's instances in registers, and writes the
//     per-pixel factors of every weight gradient (inputs, h1, h2, dx1, dx2,
//     the output cotangent) to its row of shared memory.  The rows then
//     hold L = [f, rx, ry, one | h1 | h2] and R = [dx1 | dx2 | go], and the
//     instance's weight gradient over the tile is three blocks of L^T R
//     (the TPU kernel's tmat products): [f, rx, ry, one]^T dx1 ((c + 3) x
//     c: W1, b1), [h1, one]^T dx2 ((c + 1) x c: W2, b2) and [h2, one]^T go
//     ((c + 1) x k: W3, b3), which _split lays out one after the other.
//     reduce_weight_grads cuts them into register tiles (4 x 4 at c = 8,
//     4 x 8 at c = 32; ragged edges masked): a tile's job loads its 4 + 4
//     (or 4 + 8) columns of a row and does 16 (32) FMAs, where one entry at
//     a time took 2 loads for each FMA.  At c = 8 there are only 15 jobs
//     (k = 1), so each goes to a whole warp and all 8 warps work: lane l
//     sums rows l, l + 32, ... in row order, and the warp sums its 32
//     lanes' tiles by a fixed butterfly of shuffles (warp_sum_values), so
//     no shared buffer of partials is needed.  At c = 32 there are 99 jobs
//     (k = 17) for 128 threads, and a thread sums all the tile's rows of
//     its job in row order.  The result is a per-tile partial.  d(features)
//     goes to a per-group partial.
//  2. reduce_parts_kernel sums the weight-gradient partials over tiles, and
//     the d(features) partials over groups, each in a fixed order, and
//     casts to the inputs' dtypes.
// No float atomics, and every order depends on the tile size alone, never
// on the grid or the card: the gradients are bitwise the same from call to
// call.
//
// Shared-memory banks.  The row stride is odd (row_stride), so the 32 lanes
// of a warp that each write their own row hit distinct banks.  At c = 8 the
// lanes of a warp read one column of 32 consecutive rows at once: distinct
// banks, since (r1 - r2) * stride is never a multiple of 32 for 0 < |r1 -
// r2| < 32 when the stride is odd.  At c = 32 the lanes read one row at
// once, at their jobs' columns: jobs run through R-tiles fastest, so within
// one block the columns of one load span fewer than 32 (distinct columns on
// distinct banks, repeated ones broadcast); in a warp whose jobs straddle
// two blocks, two columns may lie 32 apart, a 2-way conflict on that load.
// 16-byte loads would need a stride that is a multiple of 4, which makes
// the per-thread row writes of the recompute conflict, so the loads stay
// 4-byte.
// The gradients of the grid and the centres are not computed (the caller
// treats them as constants, as _decode_vjp_bwd returns zeros for them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_OUT = 17;      // widest num_out (keypoint heatmaps)
constexpr int MAX_GROUP = 32;    // instances per block
constexpr int FWD_THREADS = 256;
constexpr int FWD_SMEM = 48 * 1024;

__host__ __device__ constexpr int param_count(int c, int k) { return (c + 2) * c + c + c * c + c + c * k + k; }

// Pixels per backward block: one thread each.
__host__ __device__ constexpr int bwd_threads(int c) { return c == 8 ? 256 : 128; }

// A pixel's row in the backward's shared memory: features (c), relative
// coordinates (2), a constant one, h1, h2, dx1, dx2 (c each) and the output
// cotangent (k).
template <int C>
struct Row {
  static constexpr int ONE = C + 2, H1 = C + 3, H2 = 2 * C + 3, DX1 = 3 * C + 3, DX2 = 4 * C + 3, GO = 5 * C + 3;
};

// Floats per row, made odd, so that threads writing their own rows hit
// distinct banks.
__host__ __device__ constexpr int row_stride(int c, int k) { return (3 + 5 * c + k) | 1; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// Element idx of a bf16 or f32 array, widened to f32.  The type is a
// runtime flag, not a template parameter, so each kernel is compiled once
// per channel count.
__device__ __forceinline__ float load(const void* p, size_t idx, bool is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[idx]) : static_cast<const float*>(p)[idx];
}

// Copy a block's group of n instances' weights (widened to f32) and centres
// into shared memory.
__device__ void load_group(const void* __restrict__ dyn, bool is_bf16, const float* __restrict__ centers, int b,
                           int num_inst, int i0, int n, int p, float* w, float* cen) {
  const size_t base = ((size_t)b * num_inst + i0) * p;
  for (int idx = threadIdx.x; idx < n * p; idx += blockDim.x) w[idx] = load(dyn, base + idx, is_bf16);
  const float* csrc = centers + ((size_t)b * num_inst + i0) * 2;
  for (int idx = threadIdx.x; idx < n * 2; idx += blockDim.x) cen[idx] = csrc[idx];
}

// The two hidden layers of one instance (weights wi) at one pixel.
template <int C>
__device__ __forceinline__ void hidden_layers(const float* wi, const float (&f)[C], float rx, float ry,
                                              float (&x1)[C], float (&h1)[C], float (&x2)[C], float (&h2)[C]) {
  const float* w1 = wi;                // (C + 2, C): feature rows, then the two coordinate rows
  const float* b1 = w1 + (C + 2) * C;
  const float* w2 = b1 + C;            // (C, C)
  const float* b2 = w2 + C * C;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < C; ++a) acc = fmaf(f[a], w1[a * C + j], acc);
    acc = fmaf(rx, w1[C * C + j], acc);
    acc = fmaf(ry, w1[(C + 1) * C + j], acc);
    x1[j] = acc + b1[j];
    h1[j] = x1[j] * sigmoid(x1[j]);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < C; ++a) acc = fmaf(h1[a], w2[a * C + j], acc);
    x2[j] = acc + b2[j];
    h2[j] = x2[j] * sigmoid(x2[j]);
  }
}

// K5f, f32 inputs.  Grid (spatial tiles, instance groups, images); one thread per pixel.
template <int C>
__global__ void __launch_bounds__(FWD_THREADS)
decode_fwd_kernel(const float* __restrict__ mf,       // (B, S, C): channels_last features
                  const float* __restrict__ grid,     // (S, 2)
                  const float* __restrict__ centers,  // (B, I, 2)
                  const float* __restrict__ dyn,      // (B, I, P)
                  int s_total, int num_inst, int k, int group,
                  float* __restrict__ out) {          // (B, I, S, k)
  extern __shared__ float smem[];
  const int p = param_count(C, k);
  const int b = blockIdx.z, i0 = blockIdx.y * group;
  const int n = min(group, num_inst - i0);
  float* w = smem;
  float* cen = w + group * p;
  load_group(dyn, false, centers, b, num_inst, i0, n, p, w, cen);
  __syncthreads();

  const int s = blockIdx.x * FWD_THREADS + threadIdx.x;
  if (s >= s_total) return;
  float f[C];
#pragma unroll
  for (int a = 0; a < C; ++a) f[a] = mf[((size_t)b * s_total + s) * C + a];
  const float gx = grid[2 * s], gy = grid[2 * s + 1];
  for (int li = 0; li < n; ++li) {
    const float* wi = w + li * p;
    float x1[C], h1[C], x2[C], h2[C];
    hidden_layers<C>(wi, f, gx - cen[2 * li], gy - cen[2 * li + 1], x1, h1, x2, h2);
    const float* w3 = wi + (C + 2) * C + C + C * C + C;  // (C, k)
    const float* b3 = w3 + C * k;
    float* o = out + (((size_t)b * num_inst + i0 + li) * s_total + s) * k;
    for (int q = 0; q < k; ++q) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) acc = fmaf(h2[j], w3[j * k + q], acc);
      o[q] = acc + b3[q];
    }
  }
}

// K5f's tensor-core body.  A block: a strip of one image's pixels, ROWS rows
// of ROW pixels taken one after the other, each warp owning TILES tiles of 16
// pixels of a row; and at most MAX_GROUP of the image's instances, staged in
// shared memory one slot each.  Layer 1's k runs over the C features and one
// slab more, the grid slab: a pixel's gx and gy, each as three bf16 parts
// that sum to it exactly (g_parts), against W1c's rows repeated to match.  A
// slot, in 32-bit words: the B fragments of layer 1 (n-tile, slab: C / 8
// feature slabs and the grid slab), of W2 and (k > 1) of W3 (n-tile, slab),
// each slab a lane's word; then f32 vectors: b1 - center . W1c, b2, W3 at
// k = 1, and b3 (zero past k).  After the slots, the staging area: the
// group's centres and its weights as they lie in memory.
template <int C>
struct MmaPlan {
  static constexpr int SLABS = C / 8;  // 8-wide k-slabs and n-tiles of a hidden layer
  static constexpr int TILES = C == 8 ? 4 : 1;
  static constexpr int WARPS = C == 8 ? 4 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROW = 16 * TILES * WARPS;
  static constexpr int ROWS = C == 8 ? 1 : 5;  // at c = 32, spreads the staging of 1,656 words an instance
  static constexpr int STRIP = ROW * ROWS;
  static constexpr int MAX_GROUP = C == 8 ? 16 : 6;
  static constexpr int MIN_BLOCKS = C == 8 ? 6 : 3;  // resident blocks an SM: 24 warps, 85 registers a thread
  static constexpr int OUT_TILES = (MAX_OUT + 7) / 8;  // layer 3's n-tiles at k > 1
  static constexpr int N1 = SLABS * (SLABS + 1), N2 = SLABS * SLABS;  // B words of layers 1 and 2 a lane
  static constexpr int FRAGS = N1 + N2 + OUT_TILES * SLABS;
  static constexpr int W1 = 0, W2 = N1 * 32, W3 = (N1 + N2) * 32;
  static constexpr int B1 = FRAGS * 32, B2 = B1 + C, V3 = B2 + C, B3 = V3 + C;
  static constexpr int SLOT = (B3 + OUT_TILES * 8 + 3) / 4 * 4;
};

// Bytes of shared memory of a block of `group` instances: slots, centres,
// and a staging area that holds first the weights' 4-byte words (one more
// for a start in mid-word), then each warp's tile of logits (16 x k, k > 1).
template <int C>
int mma_smem(int group, int k) {
  using M = MmaPlan<C>;
  const int staging = max((group * param_count(C, k) + 3) / 2, M::WARPS * 16 * MAX_OUT);
  return (group * (M::SLOT + 2) + staging) * (int)sizeof(uint32_t);
}

__device__ __forceinline__ float widen(uint16_t bits) { return __uint_as_float((uint32_t)bits << 16); }

// Stage instances [first, first + n) of dyn (bf16, P each; 4-byte aligned)
// and their centres into the slots.  First one copy of the group's weights
// and centres, every load in flight; then the slots from that copy.  A B
// word of an 8 x 8 block holds rows 2t, 2t + 1 of column g for lane 4g + t
// (the lower row in the low half), copied bit for bit; the grid slab's rows
// are W1c's rows 0, 0, 0, 1, 1, 1 and two of zeros; the f32 vectors are the
// bf16 bits shifted up.
template <int C>
__device__ void stage_mma_group(const bf16* __restrict__ dyn, const float* __restrict__ centers, size_t first,
                                int n, int k, uint32_t* __restrict__ slots) {
  using M = MmaPlan<C>;
  constexpr int S = M::SLABS;
  const int p = param_count(C, k);
  float* cen = reinterpret_cast<float*>(slots + n * M::SLOT);
  uint32_t* copy = slots + n * (M::SLOT + 2);
  const size_t e0 = first * p;  // the group's first weight
  const uint32_t* src = reinterpret_cast<const uint32_t*>(dyn) + e0 / 2;
  const int words = (int)((e0 + (size_t)n * p + 1) / 2 - e0 / 2);
#pragma unroll 4
  for (int w = threadIdx.x; w < words; w += M::THREADS) copy[w] = __ldg(src + w);
  for (int j = threadIdx.x; j < 2 * n; j += M::THREADS) cen[j] = centers[first * 2 + j];
  __syncthreads();

  const uint16_t* raw = reinterpret_cast<const uint16_t*>(copy) + (e0 & 1);
  const int s2 = (C + 2) * C + C, s3 = s2 + C * C + C;  // W2's and W3's first entries
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;  // THREADS is a multiple of 32
  // a B word: rows 2t, 2t + 1 of column `col` of a (., width) matrix at d
  auto b_word = [&](const uint16_t* d, int width, int slab, int col) {
    d += (slab * 8 + 2 * t) * width + col;
    return (uint32_t)d[0] | (uint32_t)d[width] << 16;
  };
  constexpr int N12 = M::N1 + M::N2;
  for (int idx = threadIdx.x; idx < n * N12 * 32; idx += M::THREADS) {
    const int f = idx / 32, li = f / N12, rel = f % N12;  // rel: layer 1's (n-tile, slab), then W2's
    const uint16_t* d = raw + li * p;
    uint32_t word;
    if (rel >= M::N1) {
      word = b_word(d + s2, C, (rel - M::N1) % S, (rel - M::N1) / S * 8 + g);
    } else if (rel % (S + 1) < S) {
      word = b_word(d, C, rel % (S + 1), rel / (S + 1) * 8 + g);
    } else {  // the grid slab: W1c's rows 0, 0 | 0, 1 | 1, 1 | 0, 0 for t = 0 .. 3
      const int col = rel / (S + 1) * 8 + g;
      const uint32_t c0 = d[C * C + col], c1 = d[(C + 1) * C + col];
      word = t == 0 ? c0 | c0 << 16 : t == 1 ? c0 | c1 << 16 : t == 2 ? c1 | c1 << 16 : 0u;
    }
    slots[li * M::SLOT + rel * 32 + lane] = word;
  }
  constexpr int N3 = M::OUT_TILES * S;
  for (int idx = threadIdx.x; k > 1 && idx < n * N3 * 32; idx += M::THREADS) {  // at k = 1, W3 is a vector
    const int f = idx / 32, li = f / N3, rel = f % N3, col = rel / S * 8 + g;
    slots[li * M::SLOT + M::W3 + rel * 32 + lane] = col < k ? b_word(raw + li * p + s3, k, rel % S, col) : 0u;
  }
  constexpr int VEC = M::SLOT - M::B1;
  for (int idx = threadIdx.x; idx < n * VEC; idx += M::THREADS) {
    const int li = idx / VEC, w = M::B1 + idx % VEC;
    const uint16_t* d = raw + li * p;
    uint32_t word = 0;
    if (w < M::B2) {
      const int j = w - M::B1;
      const float c0 = widen(d[C * C + j]), c1 = widen(d[(C + 1) * C + j]);
      word = __float_as_uint(widen(d[(C + 2) * C + j]) - fmaf(cen[2 * li + 1], c1, cen[2 * li] * c0));
    } else if (w < M::V3) {
      word = (uint32_t)d[s2 + C * C + w - M::B2] << 16;
    } else if (w < M::B3) {
      word = k == 1 ? (uint32_t)d[s3 + w - M::V3] << 16 : 0u;
    } else if (w - M::B3 < k) {
      word = (uint32_t)d[s3 + C * k + w - M::B3] << 16;
    }
    slots[li * M::SLOT + w] = word;
  }
}

// d += A B over k = 8 * SLABS for one n-tile: a[s] is k-slab s's A fragment
// (rows g and g + 8), b this lane's B words, slab s at b[32 * s]; slabs in
// pairs as m16n8k16, an odd last one as m16n8k8.
template <int SLABS>
__device__ __forceinline__ void product(float (&d)[4], const uint32_t (&a)[SLABS][2], const uint32_t* b) {
#pragma unroll
  for (int s = 0; s + 1 < SLABS; s += 2) {
    const uint32_t pair[4] = {a[s][0], a[s][1], a[s + 1][0], a[s + 1][1]};
    mma_bf16(d, pair, b[32 * s], b[32 * s + 32]);
  }
  if constexpr (SLABS % 2) mma_bf16_k8(d, a[SLABS - 1], b[32 * (SLABS - 1)]);
}

// x * sigmoid(x): one ex2 and one rcp on the special-function unit.
__device__ __forceinline__ float silu_sfu(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return x * r;
}

// Two f32 as three packed bf16 pairs whose sums are exactly x0 and x1: the
// top 16 bits of x (hi), of x - hi (mid), of x - hi - mid (lo, at most 8
// significant bits, so nothing is cut), the lower column in the low half.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
  x0 -= __uint_as_float(__float_as_uint(x0) & 0xffff0000u);
  x1 -= __uint_as_float(__float_as_uint(x1) & 0xffff0000u);
  mid = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
  x0 -= __uint_as_float(__float_as_uint(x0) & 0xffff0000u);
  x1 -= __uint_as_float(__float_as_uint(x1) & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// A pixel's word of the grid slab for lane t: of (gx's parts hi, mid, lo,
// gy's hi, mid, lo, 0, 0), columns 2t and 2t + 1.
__device__ __forceinline__ uint32_t grid_word(float gx, float gy, int t) {
  uint32_t hi, mid, lo;  // each holds gx's part in its low half, gy's in its high half
  split3(gx, gy, hi, mid, lo);
  return t == 0 ? __byte_perm(hi, mid, 0x5410) : t == 1 ? __byte_perm(lo, hi, 0x7610)
       : t == 2 ? __byte_perm(mid, lo, 0x7632) : 0u;
}

// An accumulator fragment (n-tile s: rows g, g + 8 by columns 2t, 2t + 1)
// as the three parts of the next product's A fragment (k-slab s).
template <int SLABS>
__device__ __forceinline__ void split_fragments(const float (&x)[SLABS][4], uint32_t (&hi)[SLABS][2],
                                                uint32_t (&mid)[SLABS][2], uint32_t (&lo)[SLABS][2]) {
#pragma unroll
  for (int s = 0; s < SLABS; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) split3(x[s][2 * h], x[s][2 * h + 1], hi[s][h], mid[s][h], lo[s][h]);
}

// d = (b + lo B) + mid B) + hi B: an f32 A fragment in three parts times B.
template <int SLABS>
__device__ __forceinline__ void product3(float (&d)[4], const uint32_t (&hi)[SLABS][2], const uint32_t (&mid)[SLABS][2],
                                         const uint32_t (&lo)[SLABS][2], const uint32_t* b) {
  product<SLABS>(d, lo, b);
  product<SLABS>(d, mid, b);
  product<SLABS>(d, hi, b);
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// Sum each of a lane's N values over its quad (the 4 lanes of one g), and
// scatter: lane t keeps the sums of values t * N / 4 to (t + 1) * N / 4 - 1.
// Each step adds a lane's kept value and its partner's, in a fixed order.
template <int N>
__device__ __forceinline__ void quad_sum_scatter(const float (&v)[N], float (&w)[N / 4], int t) {
  float u[N / 2];
  const bool up2 = t & 2, up1 = t & 1;
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
    u[j] = (up2 ? v[j + N / 2] : v[j]) + __shfl_xor_sync(0xffffffffu, up2 ? v[j] : v[j + N / 2], 2);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    w[j] = (up1 ? u[j + N / 4] : u[j]) + __shfl_xor_sync(0xffffffffu, up1 ? u[j] : u[j + N / 4], 1);
}

// K5f, bf16 inputs.  Grid (strips, instance groups, images); ONE_OUT is k == 1.
template <int C, bool ONE_OUT>
__global__ void __launch_bounds__(MmaPlan<C>::THREADS, MmaPlan<C>::MIN_BLOCKS)
decode_fwd_mma_kernel(const bf16* __restrict__ mf,       // (B, S, C): channels_last features
                      const float* __restrict__ grid,    // (S, 2)
                      const float* __restrict__ centers, // (B, I, 2)
                      const bf16* __restrict__ dyn,      // (B, I, P)
                      int s_total, int num_inst, int k, int group,
                      float* __restrict__ out) {         // (B, I, S, k)
  using M = MmaPlan<C>;
  constexpr int SLABS = M::SLABS, TILES = M::TILES;
  extern __shared__ uint32_t slots[];
  const int b = blockIdx.z, i0 = blockIdx.y * group, n = min(group, num_inst - i0);
  const size_t first = (size_t)b * num_inst + i0;
  stage_mma_group<C>(dyn, centers, first, n, k, slots);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // k > 1: a tile's logits (16 pixels x k, contiguous in out) pass through
  // the warp's stretch of the staging area, then go out in coalesced stores
  float* tile_out = reinterpret_cast<float*>(slots + n * (M::SLOT + 2)) + warp * 16 * MAX_OUT;
  for (int row = 0; row < M::ROWS; ++row) {
    const int s0 = blockIdx.x * M::STRIP + row * M::ROW + warp * TILES * 16;  // the warp's first pixel
    if (s0 >= s_total) break;
    // each tile's layer-1 A fragments (rows g, g + 8): the features, then the grid slab
    uint32_t fa[TILES][SLABS + 1][2];
#pragma unroll
    for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = s0 + tile * 16 + g + 8 * h;
        const bool live = s < s_total;
        const uint32_t* px = reinterpret_cast<const uint32_t*>(mf + ((size_t)b * s_total + (live ? s : 0)) * C);
#pragma unroll
        for (int slab = 0; slab < SLABS; ++slab) fa[tile][slab][h] = live ? px[slab * 4 + t] : 0u;
        fa[tile][SLABS][h] = live ? grid_word(grid[2 * s], grid[2 * s + 1], t) : 0u;
      }

    for (int li = 0; li < n; ++li) {
      const uint32_t* slot = slots + li * M::SLOT;
      const float* vec = reinterpret_cast<const float*>(slot);
      float* o = out + (first + li) * s_total * k;
      constexpr int PARTS = TILES > 1 ? 2 * TILES : 4;  // at least one value a lane of the quad
      float part[PARTS] = {};  // k = 1: tile's rows g, g + 8, over this lane's columns
#pragma unroll
      for (int tile = 0; tile < TILES; ++tile) {
        float x[SLABS][4];
#pragma unroll
        for (int nt = 0; nt < SLABS; ++nt) {
          const float2 bias = ld2(vec + M::B1 + nt * 8 + 2 * t);
          x[nt][0] = x[nt][2] = bias.x;
          x[nt][1] = x[nt][3] = bias.y;
          product<SLABS + 1>(x[nt], fa[tile], slot + M::W1 + nt * (SLABS + 1) * 32 + lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[nt][e] = silu_sfu(x[nt][e]);
        }
        uint32_t hi[SLABS][2], mid[SLABS][2], lo[SLABS][2];
        split_fragments<SLABS>(x, hi, mid, lo);
        float y[SLABS][4];
#pragma unroll
        for (int nt = 0; nt < SLABS; ++nt) {
          const float2 bias = ld2(vec + M::B2 + nt * 8 + 2 * t);
          y[nt][0] = y[nt][2] = bias.x;
          y[nt][1] = y[nt][3] = bias.y;
          product3<SLABS>(y[nt], hi, mid, lo, slot + M::W2 + nt * SLABS * 32 + lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) y[nt][e] = silu_sfu(y[nt][e]);
        }
        if constexpr (ONE_OUT) {
          float r0 = 0.f, r1 = 0.f;
#pragma unroll
          for (int nt = 0; nt < SLABS; ++nt) {
            const float2 w3 = ld2(vec + M::V3 + nt * 8 + 2 * t);
            r0 = fmaf(y[nt][1], w3.y, fmaf(y[nt][0], w3.x, r0));
            r1 = fmaf(y[nt][3], w3.y, fmaf(y[nt][2], w3.x, r1));
          }
          part[2 * tile] = r0;
          part[2 * tile + 1] = r1;
        } else {
          split_fragments<SLABS>(y, hi, mid, lo);
#pragma unroll
          for (int nt = 0; nt < M::OUT_TILES; ++nt) {
            const int col = nt * 8 + 2 * t;
            if (nt * 8 >= k) break;
            const float2 bias = ld2(vec + M::B3 + col);
            float z[4] = {bias.x, bias.y, bias.x, bias.y};
            product3<SLABS>(z, hi, mid, lo, slot + M::W3 + nt * SLABS * 32 + lane);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (col < k) tile_out[(g + 8 * h) * k + col] = z[2 * h];
              if (col + 1 < k) tile_out[(g + 8 * h) * k + col + 1] = z[2 * h + 1];
            }
          }
          __syncwarp();
          const int s = s0 + tile * 16, live = min(16, s_total - s) * k;
          for (int j = lane; j < live; j += 32) o[(size_t)s * k + j] = tile_out[j];
          __syncwarp();
        }
      }
      if constexpr (ONE_OUT) {
        float sums[PARTS / 4];
        quad_sum_scatter<PARTS>(part, sums, t);
        const float b3 = vec[M::B3];
#pragma unroll
        for (int j = 0; j < PARTS / 4; ++j) {
          const int e = t * (PARTS / 4) + j;  // value e: tile e / 2, row g + 8 * (e % 2)
          const int s = s0 + e / 2 * 16 + g + 8 * (e % 2);
          if (e < 2 * TILES && s < s_total) o[s] = sums[j] + b3;
        }
      }
    }
  }
}

// The weight-gradient reduction's tiling: a job is a TA x TB tile of one
// block of L^T R (L-indices by R-indices), summed over the tile's rows by
// CHUNKS lanes of one warp, lane l over rows l, l + CHUNKS, ...  At c = 8
// a whole warp takes a job (15 jobs of 4 x 4 at k = 1 for 8 warps); at
// c = 32 a thread does (99 jobs of 4 x 8 at k = 17 for 128 threads).
template <int C>
struct GradTiles {
  static constexpr int TA = 4, TB = C == 8 ? 4 : 8, CHUNKS = C == 8 ? 32 : 1;
};

// One job of an instance's weight gradient: the tile's first L- and
// R-indices (a0, b0) and how many it holds (na, nb); its block's height nl
// (L-index nl - 1 is the constant one), width nr, first L and R columns in
// the row, and first entry in _split's layout (entry of (a, b): entry +
// a * nr + b).
struct GradJob {
  int a0, b0, na, nb, nl, nr, lfirst, rfirst, entry;
};

// The blocks, in _split's order: W1 and b1 = [f, rx, ry, one]^T dx1,
// W2 and b2 = [h1, one]^T dx2, W3 and b3 = [h2, one]^T go.  False past the
// last job.
template <int C>
__device__ __forceinline__ bool grad_job(int j, int k, GradJob& g) {
  using R = Row<C>;
  constexpr int TA = GradTiles<C>::TA, TB = GradTiles<C>::TB;
  int entry = 0;
  auto take = [&](int nl, int nr, int lfirst, int rfirst) {
    const int lt = (nl + TA - 1) / TA, rt = (nr + TB - 1) / TB;
    if (j >= lt * rt) {
      j -= lt * rt;
      entry += nl * nr;
      return false;
    }
    const int a0 = j / rt * TA, b0 = j % rt * TB;
    g = {a0, b0, min(TA, nl - a0), min(TB, nr - b0), nl, nr, lfirst, rfirst, entry};
    return true;
  };
  return take(C + 3, C, 0, R::DX1) || take(C + 1, C, R::H1, R::DX2) || take(C + 1, k, R::H2, R::GO);
}

// Sum each of a lane's N values over the warp's 32 lanes, in a fixed order,
// called with LIVE = N and MASK = 16: each step keeps half of the LIVE
// values and adds the same half from the lane MASK apart, so that after
// log2(N) steps lane l holds value l / (32 / N), summed over the lanes that
// differ in those bits, and the last steps sum over the rest.  Templates,
// not loops, so that every index into v is a constant and v stays in
// registers.
template <int LIVE, int MASK, int N>
__device__ __forceinline__ float warp_sum_values(float (&v)[N]) {
  if constexpr (LIVE > 1) {
    constexpr int HALF = LIVE / 2;
    const bool upper = threadIdx.x & MASK;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float send = upper ? v[j] : v[j + HALF];
      v[j] = (upper ? v[j + HALF] : v[j]) + __shfl_xor_sync(0xffffffffu, send, MASK);
    }
    return warp_sum_values<HALF, MASK / 2>(v);
  } else if constexpr (MASK >= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], MASK);
    return warp_sum_values<1, MASK / 2>(v);
  } else {
    return v[0];
  }
}

// K5b, step 1's weight-gradient partial of one instance over one tile: every
// entry of L^T R over the tile's live rows, into dst[0, P).
template <int C>
__device__ __forceinline__ void reduce_weight_grads(const float* rows, int rs, int live_rows, int k,
                                                    float* __restrict__ dst) {
  constexpr int TA = GradTiles<C>::TA, TB = GradTiles<C>::TB, CHUNKS = GradTiles<C>::CHUNKS;
  constexpr int SLOTS = bwd_threads(C) / CHUNKS;  // jobs under way at once
  const int chunk = threadIdx.x % CHUNKS;
  GradJob g;
  for (int job = threadIdx.x / CHUNKS; grad_job<C>(job, k, g); job += SLOTS) {
    const float* lp = rows + g.lfirst + g.a0;
    const float* rp = rows + g.rfirst + g.b0;
    bool lload[TA], rload[TB];
    float lconst[TA];
#pragma unroll
    for (int a = 0; a < TA; ++a) {  // a column of the row, the constant one, or past the block
      lload[a] = g.a0 + a < g.nl - 1;
      lconst[a] = g.a0 + a == g.nl - 1 ? 1.f : 0.f;
    }
#pragma unroll
    for (int q = 0; q < TB; ++q) rload[q] = q < g.nb;
    float acc[TA * TB];
#pragma unroll
    for (int e = 0; e < TA * TB; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int r = chunk; r < live_rows; r += CHUNKS) {
      const float* lrow = lp + r * rs;
      const float* rrow = rp + r * rs;
      float lv[TA], rv[TB];
#pragma unroll
      for (int a = 0; a < TA; ++a) lv[a] = lload[a] ? lrow[a] : lconst[a];
#pragma unroll
      for (int q = 0; q < TB; ++q) rv[q] = rload[q] ? rrow[q] : 0.f;
#pragma unroll
      for (int a = 0; a < TA; ++a)
#pragma unroll
        for (int q = 0; q < TB; ++q) acc[a * TB + q] = fmaf(lv[a], rv[q], acc[a * TB + q]);
    }
    float* out = dst + g.entry + g.a0 * g.nr + g.b0;
    if constexpr (CHUNKS == 32) {
      constexpr int SHARE = 32 / (TA * TB);  // lanes left holding each sum
      const float s = warp_sum_values<TA * TB, 16>(acc);
      const int e = chunk / SHARE, a = e / TB, q = e % TB;
      if (chunk % SHARE == 0 && a < g.na && q < g.nb) out[a * g.nr + q] = s;
    } else {
#pragma unroll
      for (int a = 0; a < TA; ++a)
#pragma unroll
        for (int q = 0; q < TB; ++q)
          if (a < g.na && q < g.nb) out[a * g.nr + q] = acc[a * TB + q];
    }
  }
}

// Copy one instance's weights (widened to f32) into shared memory.
__device__ void load_instance(const void* __restrict__ dyn, bool is_bf16, size_t inst, int p, float* w) {
  for (int idx = threadIdx.x; idx < p; idx += blockDim.x) w[idx] = load(dyn, inst * p + idx, is_bf16);
}

// Whether the backward keeps its whole group's weights in shared memory (c =
// 8: 22 KB) or one instance's at a time (c = 32: 11 KB each, beside 93 KB
// of rows).
__host__ __device__ constexpr bool group_resident(int c) { return c <= 8; }

// K5b, step 1.  Grid (spatial tiles, instance groups, images); one thread
// per pixel; one row of shared memory per pixel.  At c = 8 a pixel's
// vectors live in registers; at c = 32 they do not fit, and the thread
// works in its own row instead, keeping x1 and x2 in the dx1 and dx2 slots
// until they are overwritten; the next instance's weights are loaded while
// the rows are reduced.
template <int C>
__global__ void __launch_bounds__(bwd_threads(C), 2)
decode_bwd_tile_kernel(const void* __restrict__ mf, const float* __restrict__ grid,
                       const float* __restrict__ centers, const void* __restrict__ dyn,
                       const float* __restrict__ gout,    // (B, I, S, k)
                       bool is_bf16, int s_total, int num_inst, int k, int group,
                       float* __restrict__ dw_part,       // (B, I, tiles, P)
                       float* __restrict__ dmf_part) {    // (groups, B, S, C)
  using R = Row<C>;
  constexpr int TS = bwd_threads(C);
  constexpr int ONE = R::ONE, H1 = R::H1, H2 = R::H2, DX1 = R::DX1, DX2 = R::DX2, GO = R::GO;
  extern __shared__ float smem[];
  const int p_count = param_count(C, k), rs = row_stride(C, k);
  const int b = blockIdx.z, i0 = blockIdx.y * group, tile = blockIdx.x, tiles = gridDim.x;
  const int n = min(group, num_inst - i0);
  constexpr bool RESIDENT = group_resident(C);
  float* w = smem;
  float* cen = w + (RESIDENT ? group : 1) * p_count;
  float* rows = cen + 2 * group;
  if (RESIDENT) {
    load_group(dyn, is_bf16, centers, b, num_inst, i0, n, p_count, w, cen);
  } else {
    const float* csrc = centers + ((size_t)b * num_inst + i0) * 2;
    for (int idx = threadIdx.x; idx < n * 2; idx += blockDim.x) cen[idx] = csrc[idx];
    load_instance(dyn, is_bf16, (size_t)b * num_inst + i0, p_count, w);
  }

  const int t = threadIdx.x, s = tile * TS + t;
  const int live_rows = min(TS, s_total - tile * TS);
  const bool live = t < live_rows;
  float* row = rows + t * rs;
  float gx = 0.f, gy = 0.f;
  if (live) {
    const size_t base = ((size_t)b * s_total + s) * C;
    for (int a = 0; a < C; ++a) row[a] = load(mf, base + a, is_bf16);
    row[ONE] = 1.f;
    gx = grid[2 * s];
    gy = grid[2 * s + 1];
  }
  float f[C], dmf[C];
#pragma unroll
  for (int a = 0; a < C; ++a) {
    if (C <= 8 && live) f[a] = row[a];
    dmf[a] = 0.f;
  }
  __syncthreads();

  for (int li = 0; li < n; ++li) {
    const int inst = i0 + li;
    const float* w1 = RESIDENT ? w + li * p_count : w;  // (C + 2, C)
    const float* b1 = w1 + (C + 2) * C;
    const float* w2 = b1 + C;                            // (C, C)
    const float* b2 = w2 + C * C;
    const float* w3 = b2 + C;                            // (C, k)
    if (live) {
      const float rx = gx - cen[2 * li], ry = gy - cen[2 * li + 1];
      const float* g = gout + (((size_t)b * num_inst + inst) * s_total + s) * k;
      row[C] = rx;
      row[C + 1] = ry;
      for (int q = 0; q < k; ++q) row[GO + q] = g[q];
      if constexpr (C <= 8) {
        float x1[C], h1[C], x2[C], h2[C];
        hidden_layers<C>(w1, f, rx, ry, x1, h1, x2, h2);
        float dx2[C];
#pragma unroll
        for (int j = 0; j < C; ++j) dx2[j] = 0.f;
        for (int q = 0; q < k; ++q) {
          const float gq = row[GO + q];
#pragma unroll
          for (int j = 0; j < C; ++j) dx2[j] = fmaf(gq, w3[j * k + q], dx2[j]);
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float sg = sigmoid(x2[j]);
          dx2[j] *= sg * (1.f + x2[j] * (1.f - sg));
        }
        float dx1[C];
#pragma unroll
        for (int a = 0; a < C; ++a) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < C; ++j) acc = fmaf(dx2[j], w2[a * C + j], acc);
          const float sg = sigmoid(x1[a]);
          dx1[a] = acc * (sg * (1.f + x1[a] * (1.f - sg)));
        }
#pragma unroll
        for (int a = 0; a < C; ++a) {
          float acc = dmf[a];
#pragma unroll
          for (int j = 0; j < C; ++j) acc = fmaf(dx1[j], w1[a * C + j], acc);
          dmf[a] = acc;
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          row[H1 + j] = h1[j];
          row[H2 + j] = h2[j];
          row[DX1 + j] = dx1[j];
          row[DX2 + j] = dx2[j];
        }
      } else {
        for (int j = 0; j < C; ++j) {  // layer 1: x1 -> the dx1 slots, h1
          float acc = 0.f;
#pragma unroll 8
          for (int a = 0; a < C; ++a) acc = fmaf(row[a], w1[a * C + j], acc);
          acc = fmaf(rx, w1[C * C + j], acc);
          const float x = fmaf(ry, w1[(C + 1) * C + j], acc) + b1[j];
          row[DX1 + j] = x;
          row[H1 + j] = x * sigmoid(x);
        }
        for (int j = 0; j < C; ++j) {  // layer 2: x2 -> the dx2 slots, h2
          float acc = 0.f;
#pragma unroll 8
          for (int a = 0; a < C; ++a) acc = fmaf(row[H1 + a], w2[a * C + j], acc);
          const float x = acc + b2[j];
          row[DX2 + j] = x;
          row[H2 + j] = x * sigmoid(x);
        }
        for (int j = 0; j < C; ++j) {  // dx2 over x2
          float acc = 0.f;
          for (int q = 0; q < k; ++q) acc = fmaf(row[GO + q], w3[j * k + q], acc);
          const float x = row[DX2 + j], sg = sigmoid(x);
          row[DX2 + j] = acc * (sg * (1.f + x * (1.f - sg)));
        }
        for (int a = 0; a < C; ++a) {  // dx1 over x1
          float acc = 0.f;
#pragma unroll 8
          for (int j = 0; j < C; ++j) acc = fmaf(row[DX2 + j], w2[a * C + j], acc);
          const float x = row[DX1 + a], sg = sigmoid(x);
          row[DX1 + a] = acc * (sg * (1.f + x * (1.f - sg)));
        }
#pragma unroll
        for (int a = 0; a < C; ++a) {
          float acc = dmf[a];
#pragma unroll 8
          for (int j = 0; j < C; ++j) acc = fmaf(row[DX1 + j], w1[a * C + j], acc);
          dmf[a] = acc;
        }
      }
    }
    __syncthreads();  // the rows are complete; the weights are free
    reduce_weight_grads<C>(rows, rs, live_rows, k, dw_part + (((size_t)b * num_inst + inst) * tiles + tile) * p_count);
    if (!RESIDENT && li + 1 < n) load_instance(dyn, is_bf16, (size_t)b * num_inst + inst + 1, p_count, w);
    __syncthreads();  // the rows are rewritten, and the weights read, for the next instance
  }
  if (live) {
    float* dst = dmf_part + (((size_t)blockIdx.y * gridDim.z + b) * s_total + s) * C;
#pragma unroll
    for (int a = 0; a < C; ++a) dst[a] = dmf[a];
  }
}

// K5b, step 2: out[j] = sum over r < parts of part[r][j], r in order, for
// n entries laid out as (rows, parts, cols) with n = rows * cols.
template <typename T>
__global__ void reduce_parts_kernel(const float* __restrict__ part, int parts, int cols, size_t n,
                                    T* __restrict__ out) {
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t r = idx / cols, j = idx % cols;
    const float* src = part + r * parts * cols + j;
    float acc = 0.f;
    for (int q = 0; q < parts; ++q) acc += src[(size_t)q * cols];
    store(out + idx, acc);
  }
}

int blocks_for(size_t n, int threads) {
  const size_t blocks = (n + threads - 1) / threads;
  return (int)(blocks < 65536 ? blocks : 65536);
}

int fwd_group(int c, int k) {
  const int g = FWD_SMEM / ((param_count(c, k) + 2) * (int)sizeof(float));
  return g < MAX_GROUP ? g : MAX_GROUP;
}

size_t bwd_smem(int c, int k) {
  const size_t weights = (size_t)(group_resident(c) ? MAX_GROUP : 1) * param_count(c, k);
  return (weights + 2 * MAX_GROUP + (size_t)bwd_threads(c) * row_stride(c, k)) * sizeof(float);
}

struct BwdWorkspace {
  float* dw_part;
  float* dmf_part;
  size_t bytes;
  BwdWorkspace(char* base, int c, int b, int s, int i, int k) {
    const size_t tiles = (s + bwd_threads(c) - 1) / bwd_threads(c);
    const size_t groups = (i + MAX_GROUP - 1) / MAX_GROUP;
    const size_t dw = (size_t)b * i * tiles * param_count(c, k), dmf = groups * b * s * c;
    dw_part = reinterpret_cast<float*>(base);
    dmf_part = reinterpret_cast<float*>(base + dw * sizeof(float));
    bytes = (dw + dmf) * sizeof(float);
  }
};

// Whether a launch plan (ops/dynconv.py:decode_plan) covers s pixels with
// strips of `strip` and i instances with groups of at most `group`, each
// block holding at least one of each.
bool plan_fits(int s, int i, int strips, int groups, int group, int strip, int max_group) {
  return group >= 1 && group <= max_group && strips >= 1 && (long long)strips * strip >= s &&
         (long long)(strips - 1) * strip < s && groups >= 1 && (long long)groups * group >= i &&
         (long long)(groups - 1) * group < i;
}

template <int C>
int forward(const void* mf, const float* grid, const float* centers, const void* dyn, int b, int s, int i, int k,
            int strips, int groups, int group, float* out, cudaStream_t stream) {
  if (!plan_fits(s, i, strips, groups, group, FWD_THREADS, fwd_group(C, k))) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)group * (param_count(C, k) + 2) * sizeof(float);
  decode_fwd_kernel<C><<<dim3(strips, groups, b), FWD_THREADS, smem, stream>>>(
      static_cast<const float*>(mf), grid, centers, static_cast<const float*>(dyn), s, i, k, group, out);
  return (int)cudaGetLastError();
}

template <int C>
int forward_mma(const bf16* mf, const float* grid, const float* centers, const bf16* dyn, int b, int s, int i, int k,
                int strips, int groups, int group, float* out, cudaStream_t stream) {
  using M = MmaPlan<C>;
  if (!plan_fits(s, i, strips, groups, group, M::STRIP, M::MAX_GROUP)) return (int)cudaErrorInvalidValue;
  auto kernel = k == 1 ? decode_fwd_mma_kernel<C, true> : decode_fwd_mma_kernel<C, false>;
  const int smem = mma_smem<C>(group, k);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(strips, groups, b), M::THREADS, smem, stream>>>(mf, grid, centers, dyn, s, i, k, group, out);
  return (int)cudaGetLastError();
}

template <int C, typename T>
int backward(bool is_bf16, const void* mf, const float* grid, const float* centers, const void* dyn, const float* gout, int b,
             int s, int i, int k, void* workspace, void* dmf, void* ddyn, cudaStream_t stream) {
  const int group = MAX_GROUP, threads = bwd_threads(C);
  const size_t smem = bwd_smem(C, k);
  cudaError_t err = cudaFuncSetAttribute(decode_bwd_tile_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  BwdWorkspace ws(static_cast<char*>(workspace), C, b, s, i, k);
  const int tiles = (s + threads - 1) / threads, groups = (i + group - 1) / group;
  decode_bwd_tile_kernel<C><<<dim3(tiles, groups, b), threads, smem, stream>>>(
      mf, grid, centers, dyn, gout, is_bf16, s, i, k, group, ws.dw_part, ws.dmf_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int p = param_count(C, k);
  const size_t n_dw = (size_t)b * i * p, n_dmf = (size_t)b * s * C;
  reduce_parts_kernel<T><<<blocks_for(n_dw, 256), 256, 0, stream>>>(ws.dw_part, tiles, p, n_dw,
                                                                     static_cast<T*>(ddyn));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // the d(features) partials are (groups, n_dmf): one row of `groups` parts
  reduce_parts_kernel<T><<<blocks_for(n_dmf, 256), 256, 0, stream>>>(ws.dmf_part, groups, (int)n_dmf, n_dmf,
                                                                      static_cast<T*>(dmf));
  return (int)cudaGetLastError();
}

bool supported(int c, int k) { return (c == 8 || c == 32) && k >= 1 && k <= MAX_OUT; }

}  // namespace

extern "C" {

// Widest num_out the kernels take; c must be 8 or 32.
int sihl_dynconv_max_out() { return MAX_OUT; }

// K5f.  mf: (b, s, c) in bf16 (is_bf16; mf and dyn 4-byte aligned) or f32; grid (s, 2)
// and centers (b, i, 2) f32; dyn (b, i, param_count(c, k)) in mf's type; out
// (b, i, s, k) f32.  b, s, i >= 1.  The grid is strips x groups x b blocks
// of `group` instances each (ops/dynconv.py:decode_plan, which knows each
// body's strip and largest group); a plan that does not fit is refused.
// Launches on `stream` without synchronising and returns the cudaError_t of
// the launch.
int sihl_dynconv_fwd(int is_bf16, int c, const void* mf, const float* grid, const float* centers, const void* dyn,
                     int b, int s, int i, int k, int strips, int groups, int group, float* out, void* stream) {
  if (!supported(c, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const bf16 *mf16 = static_cast<const bf16*>(mf), *dyn16 = static_cast<const bf16*>(dyn);
    return c == 8 ? forward_mma<8>(mf16, grid, centers, dyn16, b, s, i, k, strips, groups, group, out, st)
                  : forward_mma<32>(mf16, grid, centers, dyn16, b, s, i, k, strips, groups, group, out, st);
  }
  return c == 8 ? forward<8>(mf, grid, centers, dyn, b, s, i, k, strips, groups, group, out, st)
                : forward<32>(mf, grid, centers, dyn, b, s, i, k, strips, groups, group, out, st);
}

// Bytes of device scratch sihl_dynconv_bwd needs for these sizes.
size_t sihl_dynconv_bwd_workspace(int c, int b, int s, int i, int k) {
  return supported(c, k) ? BwdWorkspace(nullptr, c, b, s, i, k).bytes : 0;
}

// K5b.  Inputs as sihl_dynconv_fwd's, plus gout (b, i, s, k) f32 and a
// workspace of sihl_dynconv_bwd_workspace bytes; writes dmf (b, s, c) and
// ddyn (b, i, param_count(c, k)) in mf's type.  Three launches on `stream`
// (the tile kernel and two fixed-order reductions); returns the first
// cudaError_t that is not cudaSuccess.
int sihl_dynconv_bwd(int is_bf16, int c, const void* mf, const float* grid, const float* centers, const void* dyn,
                     const float* gout, int b, int s, int i, int k, void* workspace, void* dmf, void* ddyn,
                     void* stream) {
  if (!supported(c, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 8)
    return is_bf16 ? backward<8, bf16>(true, mf, grid, centers, dyn, gout, b, s, i, k, workspace, dmf, ddyn, st)
                   : backward<8, float>(false, mf, grid, centers, dyn, gout, b, s, i, k, workspace, dmf, ddyn, st);
  return is_bf16 ? backward<32, bf16>(true, mf, grid, centers, dyn, gout, b, s, i, k, workspace, dmf, ddyn, st)
                 : backward<32, float>(false, mf, grid, centers, dyn, gout, b, s, i, k, workspace, dmf, ddyn, st);
}

const char* sihl_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
