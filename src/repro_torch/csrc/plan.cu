// The interpolation plan build: per query point q (index units) and axis,
// the S per-axis flat-index contributions (floor(q) + offset + tap, wrapped
// or clamped into the field, times the axis' row stride) and the S basis
// weights at the fraction t = q - floor(q), written as the plan that kernels
// K2 and K3 read (repro_torch.core.interp.InterpPlan): idx (3, S, M) int32
// and weights (3, S, M), fp32 or bf16, axis-major, then tap, then point.
//
// It replaces no TPU kernel: the JAX package's build_plan
// (src/repro/core/interp.py:265) is jnp that XLA fuses into a few loops.
// It exists because the same build in eager PyTorch (its plain version,
// kernels/plan.py) runs ~25 elementwise kernels and three stacks, moving
// ~15 GB at 256^3 (the bf16 weights in fp64, to emulate XLA's FMA): 6.1 ms
// (fp32) and 14.4 ms (bf16) a plan on an H100, 34 and ~18 plans a
// registration.
//
// What bounds it on an H100: bytes, and mostly writes. A point reads 12 B of
// queries and writes 3 * S int32 indices and 3 * S weights: 108 B for
// S = 4 with fp32 weights, 84 B with bf16, 1.81 / 1.41 GB at 256^3, against
// ~70 operations of arithmetic. Design: one thread takes 4 consecutive
// points, so that it reads each axis' queries with one 16-byte load and
// writes each of the 2 * 3 * S planes with one 16-byte store (8 bytes for 4
// bf16 weights); consecutive threads write consecutive addresses in every
// plane. 256-thread blocks, no shared memory. Stores are streaming
// (__stcs, evict-first): the plan is written once and far too large for
// the 50 MB L2 to keep until K2 or K3 reads it. An output whose size is not
// a multiple of 4, or a query tensor not aligned to 16 bytes, takes the
// same kernel with scalar loads and stores.
//
// The plan is the eager build's on the card, bit for bit, so a solve takes
// the same iterations and ends at the same velocity:
//   * indices: floor, int32 conversion, + offset + tap, floor-mod wrap
//     (torch.remainder) or clamp per axis, times the stride, all in int32;
//   * fp32 weights: the basis formulas as repro_torch.kernels.interp3d
//     writes them (lagrange_weights, bspline_weights, linear_weights), one
//     rounding an operation in PyTorch's order (__f*_rn: nothing
//     contracts), and x / 6 and x / 2 as eager CUDA computes a division by a
//     Python scalar: x times the scalar's fp32 reciprocal;
//   * bf16 weights: the arithmetic of JAX's jitted build_plan
//     (_xla_bspline_plan_weights, _xla_lagrange_weights), every B-spline
//     multiply-add an FMA (__fmaf_rn, which the plain version emulates in
//     fp64), x * fp32(1/6), then rounded to bf16 to nearest even.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads of a block
constexpr int kPoints = 4;     // consecutive output points of a thread

// The basis selectors of repro_torch.kernels.interp3d.BASES.
constexpr int kLinear = 0, kBspline = 1, kLagrange = 2;

template <int BASIS>
struct PlanBasis {
  static constexpr int S = BASIS == kLinear ? 2 : 4;
  static constexpr int kOffset = BASIS == kLinear ? 0 : -1;

  // The fp32 formulas, as eager CUDA rounds them.
  __device__ __forceinline__ static void fp32_weights(float t, float (&w)[S]) {
    if constexpr (BASIS == kLinear) {
      w[0] = __fsub_rn(1.0f, t);
      w[1] = t;
    } else if constexpr (BASIS == kBspline) {
      const float sixth = 1.0f / 6.0f;
      const float t2 = __fmul_rn(t, t);
      const float t3 = __fmul_rn(t2, t);
      w[0] = __fmul_rn(
          __fsub_rn(__fadd_rn(__fsub_rn(1.0f, __fmul_rn(t, 3.0f)), __fmul_rn(t2, 3.0f)), t3),
          sixth);
      w[1] = __fmul_rn(__fadd_rn(__fsub_rn(4.0f, __fmul_rn(t2, 6.0f)), __fmul_rn(t3, 3.0f)),
                       sixth);
      w[2] = __fmul_rn(
          __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, 3.0f), 1.0f), __fmul_rn(t2, 3.0f)),
                    __fmul_rn(t3, 3.0f)),
          sixth);
      w[3] = __fmul_rn(t3, sixth);
    } else {
      lagrange(t, w);
    }
  }

  // The bf16 plan's chains before rounding: JAX's jitted build_plan.
  __device__ __forceinline__ static void xla_weights(float t, float (&w)[S]) {
    if constexpr (BASIS == kBspline) {
      const float sixth = 1.0f / 6.0f;
      const float t2 = __fmul_rn(t, t);
      const float t3 = __fmul_rn(t2, t);
      w[0] = __fmul_rn(__fmaf_rn(-t2, t, __fmaf_rn(3.0f, t2, __fmaf_rn(-3.0f, t, 1.0f))),
                       sixth);
      w[1] = __fmul_rn(__fmaf_rn(3.0f, t3, __fmaf_rn(-6.0f, t2, 4.0f)), sixth);
      w[2] = __fmul_rn(__fmaf_rn(-3.0f, t3, __fmaf_rn(3.0f, t2, __fmaf_rn(3.0f, t, 1.0f))),
                       sixth);
      w[3] = __fmul_rn(t3, sixth);
    } else {
      fp32_weights(t, w);
    }
  }

  // lagrange_weights and _xla_lagrange_weights: the same roundings.
  __device__ __forceinline__ static void lagrange(float t, float (&w)[S]) {
    const float sixth = 1.0f / 6.0f;
    const float tp1 = __fadd_rn(t, 1.0f);
    const float tm1 = __fsub_rn(t, 1.0f);
    const float tm2 = __fsub_rn(t, 2.0f);
    w[0] = __fmul_rn(__fmul_rn(__fmul_rn(-t, tm1), tm2), sixth);
    w[1] = __fmul_rn(__fmul_rn(__fmul_rn(tp1, tm1), tm2), 0.5f);
    w[2] = __fmul_rn(__fmul_rn(__fmul_rn(-tp1, t), tm2), 0.5f);
    w[3] = __fmul_rn(__fmul_rn(__fmul_rn(tp1, t), tm1), sixth);
  }
};

// Weight storage type -> the weights of a basis and 4 of them stored.
template <typename W>
struct PlanWeight;

template <>
struct PlanWeight<float> {
  template <int BASIS>
  __device__ __forceinline__ static void weights(float t, float (&w)[PlanBasis<BASIS>::S]) {
    PlanBasis<BASIS>::fp32_weights(t, w);
  }
  __device__ __forceinline__ static void store4(float* p, const float (&v)[kPoints]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  __device__ __forceinline__ static void store1(float* p, float v) { __stcs(p, v); }
};

template <>
struct PlanWeight<__nv_bfloat16> {
  template <int BASIS>
  __device__ __forceinline__ static void weights(float t, float (&w)[PlanBasis<BASIS>::S]) {
    PlanBasis<BASIS>::xla_weights(t, w);
  }
  __device__ __forceinline__ static unsigned short bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  // two weights in one word, the first at the lower address
  __device__ __forceinline__ static unsigned pack(float lo, float hi) {
    return bits(lo) | (static_cast<unsigned>(bits(hi)) << 16);
  }
  __device__ __forceinline__ static void store4(__nv_bfloat16* p, const float (&v)[kPoints]) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(pack(v[0], v[1]), pack(v[2], v[3])));
  }
  __device__ __forceinline__ static void store1(__nv_bfloat16* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p), bits(v));
  }
};

__device__ __forceinline__ int floor_mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The plan of `cnt` (1-4) consecutive points from p0 on: VEC (cnt == 4 and
// every plane 16-byte aligned) loads and stores 4 points at a time.
template <int BASIS, typename W, bool VEC>
__global__ void __launch_bounds__(kThreads)
    build_plan_kernel(const float* __restrict__ q, int* __restrict__ idx,
                      W* __restrict__ w, long long m, int n1, int n2, int n3,
                      int wrap_mask) {
  constexpr int S = PlanBasis<BASIS>::S;
  const long long p0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPoints;
  if (p0 >= m) return;
  const int cnt = VEC ? kPoints : static_cast<int>(m - p0 < kPoints ? m - p0 : kPoints);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int n = a == 0 ? n1 : a == 1 ? n2 : n3;
    const int stride = a == 0 ? n2 * n3 : a == 1 ? n3 : 1;
    const bool wrap = (wrap_mask >> a) & 1;
    const float* qa = q + a * m + p0;
    float x[kPoints];
    if constexpr (VEC) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(qa));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPoints; ++j) x[j] = j < cnt ? __ldg(qa + j) : 0.0f;
    }
    int ix[S][kPoints];
    float wt[S][kPoints];
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      const float fl = floorf(x[j]);
      float ws[S];
      PlanWeight<W>::template weights<BASIS>(__fsub_rn(x[j], fl), ws);
      const int base = static_cast<int>(fl) + PlanBasis<BASIS>::kOffset;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = base + s;
        ix[s][j] = (wrap ? floor_mod(i, n) : min(max(i, 0), n - 1)) * stride;
        wt[s][j] = ws[s];
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long plane = static_cast<long long>(a * S + s) * m + p0;
      if constexpr (VEC) {
        __stcs(reinterpret_cast<int4*>(idx + plane),
               make_int4(ix[s][0], ix[s][1], ix[s][2], ix[s][3]));
        PlanWeight<W>::store4(w + plane, wt[s]);
      } else {
#pragma unroll
        for (int j = 0; j < kPoints; ++j) {
          if (j < cnt) {
            __stcs(idx + plane + j, ix[s][j]);
            PlanWeight<W>::store1(w + plane + j, wt[s][j]);
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

template <int BASIS, typename W>
int launch_build_plan(const float* q, int* idx, void* w, long long m, int n1, int n2,
                      int n3, int wrap_mask, cudaStream_t s) {
  const long long threads = (m + kPoints - 1) / kPoints;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  W* wp = static_cast<W*>(w);
  // every plane starts 16-byte aligned when its base is and m % 4 == 0
  if (m % kPoints == 0 && aligned16(q) && aligned16(idx) && aligned16(w)) {
    build_plan_kernel<BASIS, W, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        q, idx, wp, m, n1, n2, n3, wrap_mask);
  } else {
    build_plan_kernel<BASIS, W, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        q, idx, wp, m, n1, n2, n3, wrap_mask);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int dispatch_build_plan(const float* q, int* idx, void* w, long long m, int n1, int n2,
                        int n3, int basis, int wrap_mask, cudaStream_t s) {
  switch (basis) {
    case kLinear:
      return launch_build_plan<kLinear, W>(q, idx, w, m, n1, n2, n3, wrap_mask, s);
    case kBspline:
      return launch_build_plan<kBspline, W>(q, idx, w, m, n1, n2, n3, wrap_mask, s);
    case kLagrange:
      return launch_build_plan<kLagrange, W>(q, idx, w, m, n1, n2, n3, wrap_mask, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (3, m) fp32; idx (3, S, m) int32; w (3, S, m) fp32 or (bf16_weights) bf16;
// the field (n1, n2, n3), n1 * n2 * n3 < 2^31; bit a of wrap_mask: axis a
// wraps (else clamps).
extern "C" int build_plan(const float* q, int* idx, void* w, long long m, int n1, int n2,
                          int n3, int basis, int bf16_weights, int wrap_mask, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || n1 <= 0 || n2 <= 0 || n3 <= 0 ||
      static_cast<long long>(n1) * n2 * n3 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_weights
             ? dispatch_build_plan<__nv_bfloat16>(q, idx, w, m, n1, n2, n3, basis, wrap_mask, s)
             : dispatch_build_plan<float>(q, idx, w, m, n1, n2, n3, basis, wrap_mask, s);
}
