// Gather-multiply-accumulate through a prebuilt interpolation plan
// (kernels K2 and K3).
//
// K2 `apply_plan_f32` replaces the Pallas kernel `apply_plan_pallas`
// (src/repro/kernels/interp3d/interp3d.py:247, body `_plan_body` at :219):
//     out[k, p] = sum_abc (w1[a,p] * w2[b,p]) * w3[c,p] * f_k[i1[a,p] + i2[b,p] + i3[c,p]]
// for K stacked coefficient fields f_k, S = 4 taps per axis (cubic) or 2
// (linear). The plan holds per-axis flat-index contributions (int32, periodic
// wrap and row strides baked in) and per-axis weights (fp32), each (S, M).
//
// K3 `apply_plan_fused_f32` replaces `apply_plan_fused` (interp3d.py:339,
// body `_fused_body` at :309): K2's gather for two fields (a0, a1) plus one
// of the two pointwise epilogues of the Gauss-Newton matvec
// (src/repro/core/hessian.py:73-76 and :93-96), selected by an integer:
//     0  inc. state   : a0 + dt/2 * (a1 + e)
//     1  inc. adjoint : a0 + dt/2 * (a1 + e * (a0 + dt * a1))
// with e the extra pointwise field.
//
// What bounds them on an H100: bytes. Each output voxel reads its plan once
// (3*S int32 + 3*S fp32 = 96 B for S = 4), its K coefficient values (the 64
// taps of a near-identity semi-Lagrangian footpoint hit lines that
// neighbouring threads also read, so each coefficient comes from DRAM about
// once) and writes 4 B per output: 104 B/voxel for K2 with K = 1, 112 B for
// K3. The ~200 flops per voxel and field are far below the balance point.
//
// Design: one thread per output voxel. The thread loads its 3*S indices and
// weights once into registers and reuses them for all K fields, so the plan,
// the bulk of the bytes, crosses DRAM once per call whatever K is. Plan loads
// are coalesced (consecutive p in consecutive threads); the coefficient
// gathers go through the read-only path (__ldg). The weight products follow
// the JAX order (w1*w2)*w3*f so differences stay at FMA/op-order noise.

#include <cuda_runtime.h>

namespace {

template <int S>
struct PlanRegs {
  int i1[S], i2[S], i3[S];
  float w1[S], w2[S], w3[S];

  __device__ __forceinline__ void load(const int* __restrict__ p1,
                                       const int* __restrict__ p2,
                                       const int* __restrict__ p3,
                                       const float* __restrict__ q1,
                                       const float* __restrict__ q2,
                                       const float* __restrict__ q3,
                                       long long m, long long p) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      i1[s] = p1[s * m + p];
      i2[s] = p2[s * m + p];
      i3[s] = p3[s * m + p];
      w1[s] = q1[s * m + p];
      w2[s] = q2[s * m + p];
      w3[s] = q3[s * m + p];
    }
  }

  __device__ __forceinline__ float gather(const float* __restrict__ f) const {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < S; ++a) {
#pragma unroll
      for (int b = 0; b < S; ++b) {
        const int iab = i1[a] + i2[b];
        const float wab = w1[a] * w2[b];
#pragma unroll
        for (int c = 0; c < S; ++c) {
          acc = acc + (wab * w3[c]) * __ldg(f + iab + i3[c]);
        }
      }
    }
    return acc;
  }
};

template <int S>
__global__ void apply_plan_kernel(const float* __restrict__ coef,
                                  float* __restrict__ out, int nfields,
                                  long long nfield, long long m,
                                  const int* __restrict__ i1,
                                  const int* __restrict__ i2,
                                  const int* __restrict__ i3,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ w2,
                                  const float* __restrict__ w3) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= m) return;
  PlanRegs<S> r;
  r.load(i1, i2, i3, w1, w2, w3, m, p);
  for (int k = 0; k < nfields; ++k) {
    out[k * m + p] = r.gather(coef + k * nfield);
  }
}

template <int S>
__global__ void apply_plan_fused_kernel(const float* __restrict__ coefs,
                                        const float* __restrict__ extra,
                                        float* __restrict__ out,
                                        long long nfield, long long m,
                                        const int* __restrict__ i1,
                                        const int* __restrict__ i2,
                                        const int* __restrict__ i3,
                                        const float* __restrict__ w1,
                                        const float* __restrict__ w2,
                                        const float* __restrict__ w3,
                                        int epilogue, float half_dt, float dt) {
  long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (p >= m) return;
  PlanRegs<S> r;
  r.load(i1, i2, i3, w1, w2, w3, m, p);
  const float a0 = r.gather(coefs);
  const float a1 = r.gather(coefs + nfield);
  const float e = extra[p];
  out[p] = epilogue == 0 ? a0 + half_dt * (a1 + e)
                         : a0 + half_dt * (a1 + e * (a0 + dt * a1));
}

inline unsigned int blocks_for(long long m, int threads) {
  return static_cast<unsigned int>((m + threads - 1) / threads);
}

}  // namespace

extern "C" int apply_plan_f32(const float* coef, float* out, int nfields,
                              long long nfield, long long m, int support,
                              const int* i1, const int* i2, const int* i3,
                              const float* w1, const float* w2,
                              const float* w3, void* stream) {
  if (m == 0 || nfields == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (support == 4) {
    apply_plan_kernel<4><<<blocks_for(m, threads), threads, 0, s>>>(
        coef, out, nfields, nfield, m, i1, i2, i3, w1, w2, w3);
  } else if (support == 2) {
    apply_plan_kernel<2><<<blocks_for(m, threads), threads, 0, s>>>(
        coef, out, nfields, nfield, m, i1, i2, i3, w1, w2, w3);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int apply_plan_fused_f32(const float* coefs, const float* extra,
                                    float* out, long long nfield, long long m,
                                    int support, const int* i1, const int* i2,
                                    const int* i3, const float* w1,
                                    const float* w2, const float* w3,
                                    int epilogue, float half_dt, float dt,
                                    void* stream) {
  if (epilogue != 0 && epilogue != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (support == 4) {
    apply_plan_fused_kernel<4><<<blocks_for(m, threads), threads, 0, s>>>(
        coefs, extra, out, nfield, m, i1, i2, i3, w1, w2, w3, epilogue,
        half_dt, dt);
  } else if (support == 2) {
    apply_plan_fused_kernel<2><<<blocks_for(m, threads), threads, 0, s>>>(
        coefs, extra, out, nfield, m, i1, i2, i3, w1, w2, w3, epilogue,
        half_dt, dt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
