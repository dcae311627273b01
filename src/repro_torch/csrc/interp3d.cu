// Tensor-product interpolation on periodic 3D grids: gather-multiply-
// accumulate through a prebuilt plan (kernels K2 and K3) and plan-free
// interpolation at query points (kernel K4).
//
// K2 `apply_plan_{f32,bf16}` replaces the Pallas kernel `apply_plan_pallas`
// (src/repro/kernels/interp3d/interp3d.py:247, body `_plan_body` at :219):
//     out[k, p] = sum_abc (w1[a,p] * w2[b,p]) * w3[c,p] * f_k[i1[a,p] + i2[b,p] + i3[c,p]]
// for K stacked coefficient fields f_k, S = 4 taps per axis (cubic) or 2
// (linear). The plan holds per-axis flat-index contributions (int32, periodic
// wrap and row strides baked in) and per-axis weights (fp32 or bf16), each
// (S, M).
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
// halo tile and is valid only for |q - x| <= displacement_bound; K4 wraps
// each axis's S indices once with a non-negative floor-mod (C's % truncates),
// 3*S wraps per query, so it is exact for any q.
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
// What bounds them on an H100: bytes. Each output voxel reads its plan once
// (3*S int32 + 3*S weights = 96 B for S = 4 in fp32, 72 B with bf16
// weights), its K coefficient values (the 64 taps of a near-identity
// semi-Lagrangian footpoint hit lines that neighbouring threads also read, so
// each coefficient comes from DRAM about once) and writes 4 B per output:
// 104 B/voxel for K2 with K = 1 (80 B bf16), 112 B for K3 (88 B bf16). K4
// reads 12 B of query instead of the plan: 20 B/voxel for K = 1, 28 B for
// K = 2; its floor, weight polynomials and wraps are integer and fp32 work
// that stays far below the fp32 rate.
//
// Design: one thread per output voxel. The thread loads (K2/K3) or computes
// (K4) its 3*S indices and weights once into registers and reuses them for
// all K fields, so the plan or the query crosses DRAM once per call whatever
// K is. Loads of the plan and the queries are coalesced (consecutive p in
// consecutive threads); the coefficient gathers go through the read-only
// path (__ldg).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
__global__ void apply_plan_kernel(const float* __restrict__ coef,
                                  float* __restrict__ out, int nfields,
                                  long long nfield, long long m,
                                  const int* __restrict__ i1,
                                  const int* __restrict__ i2,
                                  const int* __restrict__ i3,
                                  const W* __restrict__ w1,
                                  const W* __restrict__ w2,
                                  const W* __restrict__ w3) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= m) return;
  PlanRegs<S, W> r;
  r.load(i1, i2, i3, w1, w2, w3, m, p);
  for (int k = 0; k < nfields; ++k) {
    out[k * m + p] = r.gather(coef + k * nfield);
  }
}

template <int S, typename W>
__global__ void apply_plan_fused_kernel(const float* __restrict__ coefs,
                                        const float* __restrict__ extra,
                                        float* __restrict__ out,
                                        long long nfield, long long m,
                                        const int* __restrict__ i1,
                                        const int* __restrict__ i2,
                                        const int* __restrict__ i3,
                                        const W* __restrict__ w1,
                                        const W* __restrict__ w2,
                                        const W* __restrict__ w3,
                                        int epilogue, float half_dt, float dt) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= m) return;
  PlanRegs<S, W> r;
  r.load(i1, i2, i3, w1, w2, w3, m, p);
  const float a0 = r.gather(coefs);
  const float a1 = r.gather(coefs + nfield);
  const float e = extra[p];
  out[p] = epilogue == 0 ? a0 + half_dt * (a1 + e)
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

// One axis of one query: the S wrapped, stride-premultiplied tap indices and
// the S weights (rounded to the weight type).
template <int BASIS, typename W>
__device__ __forceinline__ void axis_taps(float x, int n, int stride,
                                          int (&idx)[Basis<BASIS>::S],
                                          float (&w)[Basis<BASIS>::S]) {
  constexpr int S = Basis<BASIS>::S;
  const float fl = floorf(x);
  Basis<BASIS>::weights(__fsub_rn(x, fl), w);
  const int base = static_cast<int>(fl) + Basis<BASIS>::kOffset;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    w[s] = WeightType<W>::round(w[s]);
    int i = (base + s) % n;
    if (i < 0) i += n;
    idx[s] = i * stride;
  }
}

template <int BASIS, typename W>
__global__ void interp3d_kernel(const float* __restrict__ coef,
                                const float* __restrict__ q,
                                float* __restrict__ out, int nfields, int n1,
                                int n2, int n3, long long m) {
  constexpr int S = Basis<BASIS>::S;
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= m) return;
  int i1[S], i2[S], i3[S];
  float w1[S], w2[S], w3[S];
  axis_taps<BASIS, W>(q[p], n1, n2 * n3, i1, w1);
  axis_taps<BASIS, W>(q[m + p], n2, n3, i2, w2);
  axis_taps<BASIS, W>(q[2 * m + p], n3, 1, i3, w3);
  const long long nfield = static_cast<long long>(n1) * n2 * n3;
  for (int k = 0; k < nfields; ++k) {
    out[k * m + p] = gather_taps<S, W>(coef + k * nfield, i1, i2, i3, w1, w2, w3);
  }
}

inline unsigned int blocks_for(long long m, int threads) {
  return static_cast<unsigned int>((m + threads - 1) / threads);
}

constexpr int kThreads = 256;

template <typename W>
int launch_apply_plan(const float* coef, float* out, int nfields, long long nfield,
                      long long m, int support, const int* i1, const int* i2,
                      const int* i3, const void* w1, const void* w2, const void* w3,
                      void* stream) {
  if (m == 0 || nfields == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const W* v1 = static_cast<const W*>(w1);
  const W* v2 = static_cast<const W*>(w2);
  const W* v3 = static_cast<const W*>(w3);
  if (support == 4) {
    apply_plan_kernel<4, W><<<blocks_for(m, kThreads), kThreads, 0, s>>>(
        coef, out, nfields, nfield, m, i1, i2, i3, v1, v2, v3);
  } else if (support == 2) {
    apply_plan_kernel<2, W><<<blocks_for(m, kThreads), kThreads, 0, s>>>(
        coef, out, nfields, nfield, m, i1, i2, i3, v1, v2, v3);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_apply_plan_fused(const float* coefs, const float* extra, float* out,
                            long long nfield, long long m, int support,
                            const int* i1, const int* i2, const int* i3,
                            const void* w1, const void* w2, const void* w3,
                            int epilogue, float half_dt, float dt, void* stream) {
  if (epilogue != 0 && epilogue != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const W* v1 = static_cast<const W*>(w1);
  const W* v2 = static_cast<const W*>(w2);
  const W* v3 = static_cast<const W*>(w3);
  if (support == 4) {
    apply_plan_fused_kernel<4, W><<<blocks_for(m, kThreads), kThreads, 0, s>>>(
        coefs, extra, out, nfield, m, i1, i2, i3, v1, v2, v3, epilogue, half_dt, dt);
  } else if (support == 2) {
    apply_plan_fused_kernel<2, W><<<blocks_for(m, kThreads), kThreads, 0, s>>>(
        coefs, extra, out, nfield, m, i1, i2, i3, v1, v2, v3, epilogue, half_dt, dt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BASIS, typename W>
void launch_interp3d(const float* coef, const float* q, float* out, int nfields,
                     int n1, int n2, int n3, long long m, cudaStream_t s) {
  interp3d_kernel<BASIS, W><<<blocks_for(m, kThreads), kThreads, 0, s>>>(
      coef, q, out, nfields, n1, n2, n3, m);
}

template <typename W>
int dispatch_interp3d(const float* coef, const float* q, float* out, int nfields,
                      int n1, int n2, int n3, long long m, int basis,
                      cudaStream_t s) {
  switch (basis) {
    case kLinear:
      launch_interp3d<kLinear, W>(coef, q, out, nfields, n1, n2, n3, m, s);
      break;
    case kBspline:
      launch_interp3d<kBspline, W>(coef, q, out, nfields, n1, n2, n3, m, s);
      break;
    case kLagrange:
      launch_interp3d<kLagrange, W>(coef, q, out, nfields, n1, n2, n3, m, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int apply_plan_f32(const float* coef, float* out, int nfields,
                              long long nfield, long long m, int support,
                              const int* i1, const int* i2, const int* i3,
                              const void* w1, const void* w2, const void* w3,
                              void* stream) {
  return launch_apply_plan<float>(coef, out, nfields, nfield, m, support, i1, i2,
                                  i3, w1, w2, w3, stream);
}

extern "C" int apply_plan_bf16(const float* coef, float* out, int nfields,
                               long long nfield, long long m, int support,
                               const int* i1, const int* i2, const int* i3,
                               const void* w1, const void* w2, const void* w3,
                               void* stream) {
  return launch_apply_plan<__nv_bfloat16>(coef, out, nfields, nfield, m, support,
                                          i1, i2, i3, w1, w2, w3, stream);
}

extern "C" int apply_plan_fused_f32(const float* coefs, const float* extra,
                                    float* out, long long nfield, long long m,
                                    int support, const int* i1, const int* i2,
                                    const int* i3, const void* w1,
                                    const void* w2, const void* w3,
                                    int epilogue, float half_dt, float dt,
                                    void* stream) {
  return launch_apply_plan_fused<float>(coefs, extra, out, nfield, m, support, i1,
                                        i2, i3, w1, w2, w3, epilogue, half_dt, dt,
                                        stream);
}

extern "C" int apply_plan_fused_bf16(const float* coefs, const float* extra,
                                     float* out, long long nfield, long long m,
                                     int support, const int* i1, const int* i2,
                                     const int* i3, const void* w1,
                                     const void* w2, const void* w3,
                                     int epilogue, float half_dt, float dt,
                                     void* stream) {
  return launch_apply_plan_fused<__nv_bfloat16>(coefs, extra, out, nfield, m,
                                                support, i1, i2, i3, w1, w2, w3,
                                                epilogue, half_dt, dt, stream);
}

extern "C" int interp3d_f32(const float* coef, const float* q, float* out,
                            int nfields, int n1, int n2, int n3, long long m,
                            int basis, int bf16_weights, void* stream) {
  if (m == 0 || nfields == 0) return 0;
  if (n1 <= 0 || n2 <= 0 || n3 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_weights
             ? dispatch_interp3d<__nv_bfloat16>(coef, q, out, nfields, n1, n2, n3, m,
                                                basis, s)
             : dispatch_interp3d<float>(coef, q, out, nfields, n1, n2, n3, m, basis, s);
}
