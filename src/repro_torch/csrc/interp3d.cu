// Tensor-product interpolation on periodic 3D grids: gather-multiply-
// accumulate through a prebuilt plan (kernels K2 and K3) and plan-free
// interpolation at query points (kernel K4).
//
// K2 `apply_plan_{f32,bf16}` replaces the Pallas kernel `apply_plan_pallas`
// (src/repro/kernels/interp3d/interp3d.py:247, body `_plan_body` at :219):
//     out[k, p] = sum_abc (w1[a,p] * w2[b,p]) * w3[c,p] * f_k[i1[a,p] + i2[b,p] + i3[c,p]]
// for K stacked coefficient fields f_k, S = 4 taps per axis (cubic) or 2
// (linear). The plan holds per-axis flat-index contributions (int32, periodic
// wrap or clamp and row strides baked in) and per-axis weights (fp32 or
// bf16), each (S, M).
//
// K3 `apply_plan_fused_{f32,bf16}` replaces `apply_plan_fused`
// (interp3d.py:339, body `_fused_body` at :309): K2's gather for two fields
// (a0, a1) plus one of the two pointwise epilogues of the Gauss-Newton
// matvec (src/repro/core/hessian.py:73-76 and :93-96), selected by an
// integer:
//     0  inc. state   : a0 + dt/2 * (a1 + e)
//     1  inc. adjoint : a0 + dt/2 * (a1 + e * (a0 + dt * a1))
// with e the extra pointwise field.
//
// K4 `interp3d_f32` replaces `interp3d_pallas` (interp3d.py:150, body
// `_interp_body` at :83): per query point q (index units) it takes floor and
// fraction t = q - floor(q), evaluates the basis weights (linear, cubic
// B-spline, cubic Lagrange) and sums the S^3 taps of each of K fields that
// share q, with periodic wrap. The Pallas kernel reads a periodically padded
// halo tile and is valid only for |q - x| <= displacement_bound; K4 sizes its
// tile from the queries themselves and wraps every source coordinate with a
// non-negative floor-mod (C's % truncates), so it is exact for any q.
//
// Mixed precision (bf16 weights, fp32 fields, fp32 accumulation) follows the
// JAX solver as XLA compiles it under jit: weights are rounded to bf16
// (stored so in a K2/K3 plan, rounded in registers in K4),
// wab = bf16(w1 * w2), then (float(wab) * w3) * f in fp32 (XLA keeps the
// product of two bf16 weights in fp32, where it is exact). K4 evaluates the
// weight polynomials as XLA compiles JAX's jitted interp_field: x / 6 as
// x * fp32(1/6), the one multiply-add whose product has a single use (6t^2
// of the B-spline) as an FMA, every other operation rounded on its own
// (__f*_rn, never contracted). A weight's bf16 rounding depends on its last
// fp32 bit, so this is what keeps the bf16 weights equal to the plain
// version's (query_weights in kernels/interp3d.py) and to JAX's.
//
// What bounds them on an H100: bytes, once the gather's latency is hidden.
// Each output voxel reads its plan once (3*S int32 + 3*S weights = 96 B for
// S = 4 in fp32, 72 B with bf16 weights), its K coefficient values (the 64
// taps of a near-identity semi-Lagrangian footpoint hit lines that
// neighbouring outputs also read, so each coefficient comes from DRAM about
// once) and writes 4 B per output: 104 B/voxel for K2 with K = 1 (80 B
// bf16), 112 B for K3 (88 B bf16). K4 reads 12 B of query instead of the
// plan: 20 B/voxel for K = 1, 28 B for K = 2.
//
// Design of K2, K3 and K4. 256-thread blocks over tiles of a 3D output, x3
// fastest, so that a warp reads consecutive query, plan and output addresses
// and a block's taps lie in a small source box; any other output rank is
// flattened and takes 1 x 1 x 256 tiles. The output may be smaller than the
// field (the slab solve's plans gather a halo-extended field at its
// interior): only the plan's indices address the field. The tile comes from
// the wrapper: 2 x 4 x 32 (x1, x2, x3), one query a thread, or 16 x 4 x 32
// for K4's cubic bases, which stage their box, 8 queries a thread (x1 rows 2
// apart). Each thread loads (K2, K3) or computes (K4) a query's indices and
// weights once and reuses them for all K fields. K3 gathers its two fields
// in one pass over the taps, the two loads of a tap issued together under
// one tap weight. The register budget (__launch_bounds__: kMinBlocks = 4
// resident blocks, 64 registers, 32 warps an SM; 6 blocks and 40 registers
// for K4 linear, whose 8 taps need no more) replaces the 255 registers and 8
// warps of the first design; fence_regs keeps the compiler from keeping the
// S^2 weight products of every field live at once across K2's and K4's field
// loops, which spilled.
//
// K4's source box (the cubic bases): the block takes the min and max of
// floor(q) + offset on each axis over its 2048 queries (a block reduction)
// and, when the box [min, max + S - 1]^3 fits in kBoxFloats of shared memory
// (48 KB) and spans at most 64 along x3, stages it there: warps on rows, lanes
// on consecutive x3, every coordinate floor-mod wrapped, so boxes across the
// periodic seam and grids with n < S are exact. Footpoints of a smooth
// velocity move together, so the box is the tile plus the support plus the
// variation of the displacement across the tile: ~3.7 floats staged per
// query at 256^3, against 64 taps read. The taps are then read from shared
// memory at box-local indices; the a-loop of that gather stays a loop, or the
// compiler forms all 64 tap weights ahead of the loads and spills. K fields
// are staged as many at a time as fit. A block whose box is over budget
// (uniform random queries, say) takes the global branch: wrapped indices in
// registers and __ldg gathers, as linear K4 does for every block. Both sum
// the same taps in the same order a -> b -> c with the same arithmetic. The
// box pays for the 64 taps of the cubic bases, not for linear's 8, and not
// for K2, whose plan bytes dominate (both measured slower with a box).
// box_blocks, when not null, counts the blocks that staged their box (a
// diagnostic).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads of a K2 / K3 / K4 block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;     // resident K2 / K3 / K4 blocks per SM: <= 64 registers
constexpr int kMinBlocksS2 = 6;   // K4 linear (8 taps): <= 40 registers
constexpr int kBoxFloats = 12288;  // a block's shared-memory source box (48 KB)
constexpr int kBoxMaxE3 = 64;     // the box's x3 extent: two columns a lane
constexpr int kRowBatch = 4;      // box rows a warp loads before it stores them

// An empty asm that takes and returns each value: the compiler can no longer
// tell that the values are the same for every field of a field loop, so it
// forms the S^2 weight products and index sums inside the loop instead of
// keeping all of them live across it (which spilled at the register budget).
template <int S>
__device__ __forceinline__ void fence_regs(float (&v)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) asm volatile("" : "+f"(v[s]));
}

template <int S>
__device__ __forceinline__ void fence_regs(int (&v)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) asm volatile("" : "+r"(v[s]));
}

// Weight storage type -> how a weight is read and how w1 * w2 is rounded.
template <typename W>
struct WeightType;

template <>
struct WeightType<float> {
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static float round(float w) { return w; }
  __device__ __forceinline__ static float pair(float a, float b) { return a * b; }
};

template <>
struct WeightType<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static float round(float w) {
    return __bfloat162float(__float2bfloat16_rn(w));
  }
  // The product of two bf16 values is exact in fp32; round it once to bf16.
  __device__ __forceinline__ static float pair(float a, float b) {
    return round(__fmul_rn(a, b));
  }
};

// The S^3-tap sum for one field, weights and indices in registers.
template <int S, typename W>
__device__ __forceinline__ float gather_taps(const float* __restrict__ f,
                                             const int (&i1)[S], const int (&i2)[S],
                                             const int (&i3)[S], const float (&w1)[S],
                                             const float (&w2)[S],
                                             const float (&w3)[S]) {
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < S; ++a) {
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const int iab = i1[a] + i2[b];
      const float wab = WeightType<W>::pair(w1[a], w2[b]);
#pragma unroll
      for (int c = 0; c < S; ++c) {
        acc = acc + (wab * w3[c]) * __ldg(f + iab + i3[c]);
      }
    }
  }
  return acc;
}

// gather_taps from a shared-memory box with strides (e23, e3): tap (a, b, c)
// at box[a * e23 + b * e3 + c], in the same order and arithmetic. The a-loop
// is a real loop (w1 rotates through registers): unrolled, the compiler
// forms all S^3 tap weights (wab * w3[c]) ahead of the loads and spills them.
template <int S, typename W>
__device__ __forceinline__ float gather_box(const float* box, int e23, int e3,
                                            const float (&w1)[S], const float (&w2)[S],
                                            const float (&w3)[S]) {
  float acc = 0.0f;
  float wa[S];
#pragma unroll
  for (int a = 0; a < S; ++a) wa[a] = w1[a];
#pragma unroll 1
  for (int a = 0; a < S; ++a) {
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const float* row = box + b * e3;
      const float wab = WeightType<W>::pair(wa[0], w2[b]);
#pragma unroll
      for (int c = 0; c < S; ++c) {
        acc = acc + (wab * w3[c]) * row[c];
      }
    }
#pragma unroll
    for (int t = 0; t + 1 < S; ++t) wa[t] = wa[t + 1];
    box += e23;
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The source box of a K4 block
// ---------------------------------------------------------------------------

struct Box {
  int lo1, lo2, lo3;  // first source coordinate on each axis (not wrapped)
  int e1, e2, e3;     // extents
  int fields;         // fields staged per pass; 0: over budget (global branch)
};

__device__ __forceinline__ int thread_rank() {
  return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}

__device__ __forceinline__ int floor_mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The block's box [min lo, max hi + span - 1] on each axis over its threads
// (a thread without a query passes INT_MAX / INT_MIN), and how many of the
// nfields fields fit in kBoxFloats at once. Every thread of the block calls
// it and reduces the warps' partial results itself (one barrier), so all get
// the same box.
__device__ __forceinline__ Box block_box(int lo1, int lo2, int lo3, int hi1, int hi2,
                                         int hi3, int span, int nfields) {
  __shared__ int part[kWarps][6];
  const int t = thread_rank();
  int v[6] = {__reduce_min_sync(~0u, lo1), __reduce_min_sync(~0u, lo2),
              __reduce_min_sync(~0u, lo3), __reduce_max_sync(~0u, hi1),
              __reduce_max_sync(~0u, hi2), __reduce_max_sync(~0u, hi3)};
  if ((t & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) part[t >> 5][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i] = min(v[i], part[w][i]);
      v[3 + i] = max(v[3 + i], part[w][3 + i]);
    }
  }
  long long e[3];
  bool fits = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    e[i] = static_cast<long long>(v[3 + i]) - v[i] + span;
    fits = fits && e[i] >= 1 && e[i] <= kBoxFloats;
  }
  fits = fits && e[2] <= kBoxMaxE3;
  const long long vol = fits ? e[0] * e[1] * e[2] : 0;
  if (!fits || vol > kBoxFloats) return Box{0, 0, 0, 0, 0, 0, 0};
  return Box{v[0], v[1], v[2], static_cast<int>(e[0]), static_cast<int>(e[1]),
             static_cast<int>(e[2]),
             static_cast<int>(min(static_cast<long long>(nfields), kBoxFloats / vol))};
}

// Stage `count` fields f, f + nfield, ... of the box into s, field after
// field, each (e1, e2, e3) row-major, every coordinate floor-mod wrapped into
// the field. Warp w takes rows w, w + 8, ...: its lane l first finds the
// source of row w + 8 l (the divisions and wraps of 32 rows at once), then
// the warp loads kRowBatch rows at a time, lanes on consecutive x3 (two
// columns a lane, e3 <= 64), all loads before their stores.
__device__ __forceinline__ void load_box(float* __restrict__ s,
                                         const float* __restrict__ f, int count,
                                         long long nfield, const Box& b, int n1, int n2,
                                         int n3) {
  const int t = thread_rank(), lane = t & 31, warp = t >> 5;
  const int rows_f = b.e1 * b.e2, rows = count * rows_f;
  const int j0 = lane, j1 = lane + 32;
  const bool has0 = j0 < b.e3, has1 = j1 < b.e3;
  const int c0 = floor_mod(b.lo3 + j0, n3), c1 = floor_mod(b.lo3 + j1, n3);
  for (int r_base = 0; r_base < rows; r_base += 32 * kWarps) {
    const int my_row = r_base + warp + kWarps * lane;
    long long my_src = 0;
    if (my_row < rows) {
      const int k = my_row / rows_f, rr = my_row - k * rows_f;
      const int r1 = rr / b.e2, r2 = rr - r1 * b.e2;
      my_src = k * nfield + static_cast<long long>(floor_mod(b.lo1 + r1, n1)) * n2 * n3 +
               static_cast<long long>(floor_mod(b.lo2 + r2, n2)) * n3;
    }
    const int n_mine = min(32, (rows - r_base - warp + kWarps - 1) / kWarps);
    for (int i0 = 0; i0 < n_mine; i0 += kRowBatch) {
      float v0[kRowBatch], v1[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const long long src = __shfl_sync(~0u, my_src, (i0 + i) & 31);
        const bool row = i0 + i < n_mine;
        v0[i] = row && has0 ? __ldg(f + src + c0) : 0.0f;
        v1[i] = row && has1 ? __ldg(f + src + c1) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        if (i0 + i < n_mine) {
          float* dst = s + (r_base + warp + kWarps * (i0 + i)) * b.e3;
          if (has0) dst[j0] = v0[i];
          if (has1) dst[j1] = v1[i];
        }
      }
    }
  }
}

// The j-th output voxel of this thread in an (m1, m2, m3) output in tiles
// of (reps * blockDim.z, blockDim.y, blockDim.x), and whether it exists: a
// thread takes the x1 rows threadIdx.z + blockDim.z * j of its tile.
struct OutVoxel {
  long long p;
  bool valid;
  __device__ __forceinline__ OutVoxel(int m1, int m2, int m3, int reps = 1, int j = 0) {
    const int x1 = (blockIdx.z * reps + j) * blockDim.z + threadIdx.z;
    const int x2 = blockIdx.y * blockDim.y + threadIdx.y;
    const int x3 = blockIdx.x * blockDim.x + threadIdx.x;
    valid = x1 < m1 && x2 < m2 && x3 < m3;
    p = (static_cast<long long>(x1) * m2 + x2) * m3 + x3;
  }
};

// ---------------------------------------------------------------------------
// K2 / K3: plan gather
// ---------------------------------------------------------------------------

template <int S, typename W>
struct PlanRegs {
  int i1[S], i2[S], i3[S];
  float w1[S], w2[S], w3[S];

  __device__ __forceinline__ void load(const int* __restrict__ p1,
                                       const int* __restrict__ p2,
                                       const int* __restrict__ p3,
                                       const W* __restrict__ q1,
                                       const W* __restrict__ q2,
                                       const W* __restrict__ q3,
                                       long long m, long long p) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      i1[s] = p1[s * m + p];
      i2[s] = p2[s * m + p];
      i3[s] = p3[s * m + p];
      w1[s] = WeightType<W>::load(q1 + s * m + p);
      w2[s] = WeightType<W>::load(q2 + s * m + p);
      w3[s] = WeightType<W>::load(q3 + s * m + p);
    }
  }

  __device__ __forceinline__ float gather(const float* __restrict__ f) const {
    return gather_taps<S, W>(f, i1, i2, i3, w1, w2, w3);
  }
};

template <int S, typename W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    apply_plan_kernel(const float* __restrict__ coef, float* __restrict__ out,
                      int nfields, long long nfield, int m1, int m2, int m3,
                      const int* __restrict__ i1, const int* __restrict__ i2,
                      const int* __restrict__ i3, const W* __restrict__ w1,
                      const W* __restrict__ w2, const W* __restrict__ w3) {
  const OutVoxel o(m1, m2, m3);
  if (!o.valid) return;
  const long long m = static_cast<long long>(m1) * m2 * m3;
  PlanRegs<S, W> r;
  r.load(i1, i2, i3, w1, w2, w3, m, o.p);
  for (int k = 0; k < nfields; ++k) {
    fence_regs(r.w1);
    fence_regs(r.i1);
    out[k * m + o.p] = r.gather(coef + k * nfield);
  }
}

// K3: one output a thread of a 3D tile (as K2). Both fields are gathered in
// one pass, in _fused_body's loop order a -> b -> c: each tap weight
// (wab * w3[c]) is formed once, and both fields' loads at the tap's index
// are issued together; two gathers in turn spilled ~100 B at this register
// budget. Per field the arithmetic is K2's (acc + (wab * w3[c]) * f), so
// each sum is what the field's own gather gives.
template <int S, typename W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    apply_plan_fused_kernel(const float* __restrict__ coefs, const float* __restrict__ extra,
                            float* __restrict__ out, long long nfield, int m1, int m2,
                            int m3, const int* __restrict__ i1, const int* __restrict__ i2,
                            const int* __restrict__ i3, const W* __restrict__ w1,
                            const W* __restrict__ w2, const W* __restrict__ w3,
                            int epilogue, float half_dt, float dt) {
  const OutVoxel o(m1, m2, m3);
  if (!o.valid) return;
  const long long m = static_cast<long long>(m1) * m2 * m3;
  PlanRegs<S, W> r;
  r.load(i1, i2, i3, w1, w2, w3, m, o.p);
  const float* __restrict__ f1 = coefs + nfield;
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int a = 0; a < S; ++a) {
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const int iab = r.i1[a] + r.i2[b];
      const float wab = WeightType<W>::pair(r.w1[a], r.w2[b]);
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const int i = iab + r.i3[c];
        const float v0 = __ldg(coefs + i);
        const float v1 = __ldg(f1 + i);
        const float wabc = wab * r.w3[c];
        a0 = a0 + wabc * v0;
        a1 = a1 + wabc * v1;
      }
    }
  }
  const float e = extra[o.p];
  out[o.p] = epilogue == 0 ? a0 + half_dt * (a1 + e)
                           : a0 + half_dt * (a1 + e * (a0 + dt * a1));
}

// ---------------------------------------------------------------------------
// K4: plan-free interpolation
// ---------------------------------------------------------------------------

constexpr int kLinear = 0, kBspline = 1, kLagrange = 2;

template <int BASIS>
struct Basis {
  static constexpr int S = BASIS == kLinear ? 2 : 4;
  static constexpr int kOffset = BASIS == kLinear ? 0 : -1;

  // The JAX polynomials (src/repro/core/interp.py:86-107) in the arithmetic
  // of the jitted interp_field; see the header.
  __device__ __forceinline__ static void weights(float t, float (&w)[S]) {
    const float sixth = 1.0f / 6.0f;
    if constexpr (BASIS == kLinear) {
      w[0] = __fsub_rn(1.0f, t);
      w[1] = t;
    } else if constexpr (BASIS == kBspline) {
      const float t2 = __fmul_rn(t, t);
      const float t3 = __fmul_rn(t2, t);
      const float t_3 = __fmul_rn(3.0f, t);
      const float t2_3 = __fmul_rn(3.0f, t2);
      const float t3_3 = __fmul_rn(3.0f, t3);
      w[0] = __fmul_rn(__fsub_rn(__fadd_rn(__fsub_rn(1.0f, t_3), t2_3), t3), sixth);
      w[1] = __fmul_rn(__fadd_rn(__fmaf_rn(-6.0f, t2, 4.0f), t3_3), sixth);
      w[2] = __fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(t_3, 1.0f), t2_3), t3_3), sixth);
      w[3] = __fmul_rn(t3, sixth);
    } else {
      const float tp1 = __fadd_rn(t, 1.0f);
      const float tm1 = __fsub_rn(t, 1.0f);
      const float tm2 = __fsub_rn(t, 2.0f);
      w[0] = __fmul_rn(__fmul_rn(__fmul_rn(-t, tm1), tm2), sixth);
      w[1] = __fmul_rn(__fmul_rn(__fmul_rn(tp1, tm1), tm2), 0.5f);
      w[2] = __fmul_rn(__fmul_rn(__fmul_rn(-tp1, t), tm2), 0.5f);
      w[3] = __fmul_rn(__fmul_rn(__fmul_rn(tp1, t), tm1), sixth);
    }
  }
};

// One axis of one query: the S weights (rounded to the weight type); returns
// the first tap's coordinate, floor(x) + offset, not wrapped.
template <int BASIS, typename W>
__device__ __forceinline__ int axis_weights(float x, float (&w)[Basis<BASIS>::S]) {
  const float fl = floorf(x);
  Basis<BASIS>::weights(__fsub_rn(x, fl), w);
#pragma unroll
  for (int s = 0; s < Basis<BASIS>::S; ++s) w[s] = WeightType<W>::round(w[s]);
  return static_cast<int>(fl) + Basis<BASIS>::kOffset;
}

// The S wrapped, stride-premultiplied tap indices of one axis.
template <int S>
__device__ __forceinline__ void wrap_taps(int base, int n, int stride, int (&idx)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) idx[s] = floor_mod(base + s, n) * stride;
}

// K4. A thread takes `reps` queries of its block's tile, x1 rows apart. The
// cubic bases (kBox) first take the min and max of the block's first taps (a
// pass over their coordinates), stage the box, and then compute each query's
// weights and sum from shared memory; over budget they take the global
// branch, as linear does for every block.
template <int BASIS, typename W>
__global__ void __launch_bounds__(kThreads,
                                  Basis<BASIS>::S == 2 ? kMinBlocksS2 : kMinBlocks)
    interp3d_kernel(const float* __restrict__ coef, const float* __restrict__ q,
                    float* __restrict__ out, int nfields, int n1, int n2, int n3, int m1,
                    int m2, int m3, int reps, int* __restrict__ box_blocks) {
  constexpr int S = Basis<BASIS>::S;
  constexpr bool kBox = S == 4;
  extern __shared__ float s[];  // kBoxFloats floats (kBox)
  const long long m = static_cast<long long>(m1) * m2 * m3;
  const long long nfield = static_cast<long long>(n1) * n2 * n3;
  Box box{0, 0, 0, 0, 0, 0, 0};
  if constexpr (kBox) {
    // A thread without a query is neutral in the block's min and max.
    int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};
    for (int j = 0; j < reps; ++j) {
      const OutVoxel o(m1, m2, m3, reps, j);
      if (!o.valid) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b = static_cast<int>(floorf(q[a * m + o.p])) + Basis<BASIS>::kOffset;
        lo[a] = min(lo[a], b);
        hi[a] = max(hi[a], b);
      }
    }
    box = block_box(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2], S, nfields);
  }
  if (!kBox || box.fields == 0) {
    // Linear takes one query a thread (reps == 1, which its launch checks: a
    // loop over reps made it slower); a cubic block over budget takes its
    // reps queries in turn.
    for (int j = 0; j < (kBox ? reps : 1); ++j) {
      const OutVoxel o(m1, m2, m3, reps, j);
      if (!o.valid) continue;
      float w1[S], w2[S], w3[S];
      int i1[S], i2[S], i3[S];
      wrap_taps<S>(axis_weights<BASIS, W>(q[o.p], w1), n1, n2 * n3, i1);
      wrap_taps<S>(axis_weights<BASIS, W>(q[m + o.p], w2), n2, n3, i2);
      wrap_taps<S>(axis_weights<BASIS, W>(q[2 * m + o.p], w3), n3, 1, i3);
      for (int k = 0; k < nfields; ++k) {
        fence_regs(w1);
        fence_regs(i1);
        out[k * m + o.p] = gather_taps<S, W>(coef + k * nfield, i1, i2, i3, w1, w2, w3);
      }
    }
    return;
  }
  if (box_blocks != nullptr && thread_rank() == 0) atomicAdd(box_blocks, 1);
  const int e3 = box.e3, e23 = box.e2 * e3, vol = box.e1 * e23;
  for (int k0 = 0; k0 < nfields; k0 += box.fields) {
    const int count = min(box.fields, nfields - k0);
    if (k0 > 0) __syncthreads();
    load_box(s, coef + k0 * nfield, count, nfield, box, n1, n2, n3);
    __syncthreads();
    for (int j = 0; j < reps; ++j) {
      const OutVoxel o(m1, m2, m3, reps, j);
      if (!o.valid) continue;
      float w1[S], w2[S], w3[S];
      const int off = (axis_weights<BASIS, W>(q[o.p], w1) - box.lo1) * e23 +
                      (axis_weights<BASIS, W>(q[m + o.p], w2) - box.lo2) * e3 +
                      (axis_weights<BASIS, W>(q[2 * m + o.p], w3) - box.lo3);
      for (int k = 0; k < count; ++k) {
        fence_regs(w1);
        out[(k0 + k) * m + o.p] =
            gather_box<S, W>(s + k * vol + off, e23, e3, w1, w2, w3);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline unsigned int blocks_for(long long m, int threads) {
  return static_cast<unsigned int>((m + threads - 1) / threads);
}

// The grid and block of an (m1, m2, m3) output in (t1, t2, t3) tiles, and
// the queries a thread takes (block (t3, t2, kThreads / (t3 t2)), t1 a
// multiple of its z), or false when the tiling is not one the kernels take.
bool tiled_launch(long long m, int m1, int m2, int m3, int t1, int t2, int t3,
                  dim3* grid, dim3* block, int* reps) {
  if (m1 <= 0 || m2 <= 0 || m3 <= 0 || t1 <= 0 || t2 <= 0 || t3 <= 0) return false;
  if (static_cast<long long>(m1) * m2 * m3 != m || kThreads % (t2 * t3) != 0) return false;
  const int bz = kThreads / (t2 * t3);
  if (t1 % bz != 0) return false;
  *reps = t1 / bz;
  *grid = dim3(blocks_for(m3, t3), blocks_for(m2, t2), blocks_for(m1, t1));
  *block = dim3(t3, t2, bz);
  return grid->y <= 65535 && grid->z <= 65535;
}

template <typename W>
int launch_apply_plan(const float* coef, float* out, int nfields, long long nfield,
                      long long m, int support, const int* i1, const int* i2,
                      const int* i3, const void* w1, const void* w2, const void* w3,
                      int m1, int m2, int m3, int t1, int t2, int t3, void* stream) {
  if (m == 0 || nfields == 0) return 0;
  dim3 grid, block;
  int reps = 0;
  if (!tiled_launch(m, m1, m2, m3, t1, t2, t3, &grid, &block, &reps) || reps != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const W* v1 = static_cast<const W*>(w1);
  const W* v2 = static_cast<const W*>(w2);
  const W* v3 = static_cast<const W*>(w3);
  if (support == 4) {
    apply_plan_kernel<4, W><<<grid, block, 0, s>>>(coef, out, nfields, nfield, m1, m2, m3,
                                                  i1, i2, i3, v1, v2, v3);
  } else if (support == 2) {
    apply_plan_kernel<2, W><<<grid, block, 0, s>>>(coef, out, nfields, nfield, m1, m2, m3,
                                                  i1, i2, i3, v1, v2, v3);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_apply_plan_fused(const float* coefs, const float* extra, float* out,
                            long long nfield, long long m, int support, const int* i1,
                            const int* i2, const int* i3, const void* w1, const void* w2,
                            const void* w3, int epilogue, float half_dt, float dt, int m1,
                            int m2, int m3, int t1, int t2, int t3, void* stream) {
  if (epilogue != 0 && epilogue != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  dim3 grid, block;
  int reps = 0;
  if (!tiled_launch(m, m1, m2, m3, t1, t2, t3, &grid, &block, &reps) || reps != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const W* v1 = static_cast<const W*>(w1);
  const W* v2 = static_cast<const W*>(w2);
  const W* v3 = static_cast<const W*>(w3);
  if (support == 4) {
    apply_plan_fused_kernel<4, W><<<grid, block, 0, s>>>(coefs, extra, out, nfield, m1, m2,
                                                        m3, i1, i2, i3, v1, v2, v3, epilogue,
                                                        half_dt, dt);
  } else if (support == 2) {
    apply_plan_fused_kernel<2, W><<<grid, block, 0, s>>>(coefs, extra, out, nfield, m1, m2,
                                                        m3, i1, i2, i3, v1, v2, v3, epilogue,
                                                        half_dt, dt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cubic bases take kBoxFloats of dynamic shared memory beside their
// static arrays, past the 48 KB a launch gets without asking. The attribute
// belongs to the current device's context, so it is set before every launch
// (one cheap call), on whichever card that is.
template <int BASIS, typename W>
int launch_interp3d(const float* coef, const float* q, float* out, int nfields,
                    int n1, int n2, int n3, int m1, int m2, int m3, dim3 grid,
                    dim3 block, int reps, int* box_blocks, cudaStream_t s) {
  const auto kernel = interp3d_kernel<BASIS, W>;
  const size_t smem = Basis<BASIS>::S == 4 ? kBoxFloats * sizeof(float) : 0;
  if (smem == 0 && reps != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, block, smem, s>>>(coef, q, out, nfields, n1, n2, n3, m1, m2, m3, reps,
                                   box_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int dispatch_interp3d(const float* coef, const float* q, float* out, int nfields,
                      int n1, int n2, int n3, int m1, int m2, int m3, dim3 grid,
                      dim3 block, int reps, int basis, int* box_blocks, cudaStream_t s) {
  switch (basis) {
    case kLinear:
      return launch_interp3d<kLinear, W>(coef, q, out, nfields, n1, n2, n3, m1, m2, m3,
                                         grid, block, reps, box_blocks, s);
    case kBspline:
      return launch_interp3d<kBspline, W>(coef, q, out, nfields, n1, n2, n3, m1, m2, m3,
                                          grid, block, reps, box_blocks, s);
    case kLagrange:
      return launch_interp3d<kLagrange, W>(coef, q, out, nfields, n1, n2, n3, m1, m2, m3,
                                           grid, block, reps, box_blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K2: (m1, m2, m3) is the plan's output shape as three dims (a flattened
// one is (1, 1, m)), (t1, t2, t3) the block's tile of it.
extern "C" int apply_plan_f32(const float* coef, float* out, int nfields,
                              long long nfield, long long m, int support,
                              const int* i1, const int* i2, const int* i3,
                              const void* w1, const void* w2, const void* w3, int m1,
                              int m2, int m3, int t1, int t2, int t3, void* stream) {
  return launch_apply_plan<float>(coef, out, nfields, nfield, m, support, i1, i2, i3, w1,
                                  w2, w3, m1, m2, m3, t1, t2, t3, stream);
}

extern "C" int apply_plan_bf16(const float* coef, float* out, int nfields,
                               long long nfield, long long m, int support,
                               const int* i1, const int* i2, const int* i3,
                               const void* w1, const void* w2, const void* w3, int m1,
                               int m2, int m3, int t1, int t2, int t3, void* stream) {
  return launch_apply_plan<__nv_bfloat16>(coef, out, nfields, nfield, m, support, i1, i2,
                                          i3, w1, w2, w3, m1, m2, m3, t1, t2, t3, stream);
}

// K3: (m1, m2, m3) and (t1, t2, t3) as for K2.
extern "C" int apply_plan_fused_f32(const float* coefs, const float* extra, float* out,
                                    long long nfield, long long m, int support,
                                    const int* i1, const int* i2, const int* i3,
                                    const void* w1, const void* w2, const void* w3,
                                    int epilogue, float half_dt, float dt, int m1, int m2,
                                    int m3, int t1, int t2, int t3, void* stream) {
  return launch_apply_plan_fused<float>(coefs, extra, out, nfield, m, support, i1, i2, i3,
                                        w1, w2, w3, epilogue, half_dt, dt, m1, m2, m3, t1,
                                        t2, t3, stream);
}

extern "C" int apply_plan_fused_bf16(const float* coefs, const float* extra, float* out,
                                     long long nfield, long long m, int support,
                                     const int* i1, const int* i2, const int* i3,
                                     const void* w1, const void* w2, const void* w3,
                                     int epilogue, float half_dt, float dt, int m1, int m2,
                                     int m3, int t1, int t2, int t3, void* stream) {
  return launch_apply_plan_fused<__nv_bfloat16>(coefs, extra, out, nfield, m, support, i1,
                                                i2, i3, w1, w2, w3, epilogue, half_dt, dt,
                                                m1, m2, m3, t1, t2, t3, stream);
}

// K4: (m1, m2, m3) and (t1, t2, t3) as for K2; box_blocks null or a counter
// of the blocks that staged their source box.
extern "C" int interp3d_f32(const float* coef, const float* q, float* out,
                            int nfields, int n1, int n2, int n3, long long m,
                            int basis, int bf16_weights, int m1, int m2, int m3, int t1,
                            int t2, int t3, int* box_blocks, void* stream) {
  if (m == 0 || nfields == 0) return 0;
  dim3 grid, block;
  int reps = 0;
  if (n1 <= 0 || n2 <= 0 || n3 <= 0 ||
      !tiled_launch(m, m1, m2, m3, t1, t2, t3, &grid, &block, &reps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_weights
             ? dispatch_interp3d<__nv_bfloat16>(coef, q, out, nfields, n1, n2, n3, m1, m2,
                                                m3, grid, block, reps, basis, box_blocks, s)
             : dispatch_interp3d<float>(coef, q, out, nfields, n1, n2, n3, m1, m2, m3,
                                        grid, block, reps, basis, box_blocks, s);
}
