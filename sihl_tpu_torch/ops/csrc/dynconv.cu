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
//     out = h2 . W3 + b3                              (k outputs)
//
// all in f32 (bf16 features and weights are read as bf16 and widened).
//
// What bounds it on this card.  Per pixel-instance the forward does
// (c + 2) * c + c * c + c * k multiply-adds and 2 * c exponentials (at c = 8,
// k = 1: 152 and 16), and writes k f32 logits; at the training shape (16
// images x 256 instances x 80 x 80) that is 8.0 GFLOP of f32 FMAs against
// 105 MB of logits, so the f32 FMA rate bounds it, with the exponentials
// and divisions of SiLU on the special-function unit beside it.  The
// backward recomputes the forward and does about three times its work.
// The TPU kernel packs 128 / c instances block-diagonally into its matrix
// unit's lanes (_block_diag, _pack); that packing only fills the MXU and is
// not carried over: here one thread owns one pixel, keeps its features in
// registers and walks the instances of its block, whose weights sit in
// shared memory as f32 (an instance's 169 floats at c = 8 are read by every
// thread of a warp at once, a broadcast), so the (B, I, S, c) hidden
// activations never reach device memory and the only large write is the
// logits themselves.
//
// The backward (K5b) has two reductions that the TPU does on a sequential
// grid axis (the weight gradients, summed over spatial tiles in VMEM) and
// outside the kernel (d(features), summed over instance groups).  Blocks on
// the card run at once and in no order, so:
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

template <int C>
__device__ __forceinline__ void load_pixel(const void* __restrict__ mf, bool is_bf16, int b, int s_total, int s,
                                           float (&f)[C]) {
  const size_t base = ((size_t)b * s_total + s) * C;
#pragma unroll
  for (int a = 0; a < C; ++a) f[a] = load(mf, base + a, is_bf16);
}

// K5f.  Grid (spatial tiles, instance groups, images); one thread per pixel.
template <int C>
__global__ void __launch_bounds__(FWD_THREADS)
decode_fwd_kernel(const void* __restrict__ mf,        // (B, S, C): channels_last features, bf16 or f32
                  const float* __restrict__ grid,     // (S, 2)
                  const float* __restrict__ centers,  // (B, I, 2)
                  const void* __restrict__ dyn,       // (B, I, P), mf's type
                  bool is_bf16, int s_total, int num_inst, int k, int group,
                  float* __restrict__ out) {          // (B, I, S, k)
  extern __shared__ float smem[];
  const int p = param_count(C, k);
  const int b = blockIdx.z, i0 = blockIdx.y * group;
  const int n = min(group, num_inst - i0);
  float* w = smem;
  float* cen = w + group * p;
  load_group(dyn, is_bf16, centers, b, num_inst, i0, n, p, w, cen);
  __syncthreads();

  const int s = blockIdx.x * FWD_THREADS + threadIdx.x;
  if (s >= s_total) return;
  float f[C];
  load_pixel<C>(mf, is_bf16, b, s_total, s, f);
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

template <int C>
int forward(bool is_bf16, const void* mf, const float* grid, const float* centers, const void* dyn, int b, int s, int i,
            int k, float* out, cudaStream_t stream) {
  const int group = fwd_group(C, k);
  const dim3 blocks((s + FWD_THREADS - 1) / FWD_THREADS, (i + group - 1) / group, b);
  const size_t smem = (size_t)group * (param_count(C, k) + 2) * sizeof(float);
  decode_fwd_kernel<C><<<blocks, FWD_THREADS, smem, stream>>>(mf, grid, centers, dyn, is_bf16, s, i, k, group, out);
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

// K5f.  mf: (b, s, c) in bf16 (is_bf16) or f32; grid (s, 2) and centers
// (b, i, 2) f32; dyn (b, i, param_count(c, k)) in mf's type; out (b, i, s, k)
// f32.  b, s, i >= 1.  Launches on `stream` without synchronising and
// returns the cudaError_t of the launch.
int sihl_dynconv_fwd(int is_bf16, int c, const void* mf, const float* grid, const float* centers, const void* dyn,
                     int b, int s, int i, int k, float* out, void* stream) {
  if (!supported(c, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return c == 8 ? forward<8>(is_bf16, mf, grid, centers, dyn, b, s, i, k, out, st)
                : forward<32>(is_bf16, mf, grid, centers, dyn, b, s, i, k, out, st);
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
