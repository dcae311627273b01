// The Gauss-Newton Hessian matvec's two contractions over a trajectory of
// nt + 1 time slices (repro_torch.core.hessian, core.transport), on fields
// of m points:
//   traj_source_kernel:     s[t] = -(vt_0 g[t,0] + vt_1 g[t,1] + vt_2 g[t,2])
//                           for t = 0..nt: the incremental state's sources
//                           -vt . grad m_t; vt (3, m), g = grad m (nt+1, 3, m),
//                           s (nt+1, m);
//   traj_body_force_kernel: out_c = a_c + sum_t w_t lam_t g[t,c], c = 0..2:
//                           the trapezoid body force int lam grad m dt, with
//                           w_0 = w_nt = dt/2 and w_t = dt otherwise, plus
//                           (optionally) a = beta A vt, the regularisation
//                           term the matvec and the gradient add to it; the
//                           nt + 1 fields lam_t are separate tensors, passed
//                           as a by-value array of pointers.
//
// They replace no TPU kernel: the JAX package writes both contractions as
// einsums (src/repro/core/hessian.py, src/repro/core/transport.py) that XLA
// fuses. They exist because the same contractions in eager PyTorch are a
// broadcast product over all 15 gradient planes, its reduction, a stack of
// the lam fields and the weighted sums: ~9.7 GB moved per fused matvec and
// ~12.4 GB per plan-free one at 256^3, where a single pass needs 3.3 GB.
//
// What bounds them on an H100: bytes. traj_source reads 3 + 3 (nt+1) planes
// and writes nt + 1: 23 planes, 1.54 GB at 256^3 and nt = 4, against 5
// operations a point and slice; traj_body_force reads (nt+1) + 3 (nt+1)
// + 3 planes and writes 3: 26 planes, 1.74 GB. At 3.35 TB/s that is 0.46
// and 0.52 ms. Design: one thread takes 4 consecutive points, so that every
// plane is read with one 16-byte load and written with one 16-byte store,
// consecutive threads on consecutive addresses in every plane; 256-thread
// blocks, no shared memory. For nt + 1 <= kMaxUnrolled the slice count is
// a template argument and the loops unroll, so all of a thread's loads (the
// 3 (nt+1) gradient planes and the lam planes) are independent and the
// compiler issues them ahead of their use; at nt = 4 the vector path takes
// 32 (sources) and 44 (body force) registers, so 40-64 warps a SM stay
// resident to cover HBM latency. A larger nt takes the same kernel with the
// slices in a loop. Stores are streaming
// (__stcs, evict-first): the outputs are far larger than the 50 MB L2. A
// size that is not a multiple of 4, or a plane not aligned to 16 bytes
// (multires coarse levels, slabs), takes the same kernel with scalar loads
// and stores.
//
// Both equal their plain versions (repro_torch/kernels/contract.py) run on
// the card bit for bit: fp32 throughout, one rounding an operation in the
// plain version's order (__f*_rn: nothing contracts into an FMA).
//   * traj_source: torch.sum over the component axis on the card keeps one
//     thread's accumulators in four slots that start at 0 and combines them
//     in order, so the sum is ((p0 + p1) + p2) + 0 (the final + 0 turns a
//     -0 into +0), then negated;
//   * traj_body_force: the plain version's loop, acc = 0, acc = acc +
//     (w_t lam_t) g[t,c] for t in order, then a + acc.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads of a block
constexpr int kPoints = 4;        // consecutive points of a thread
constexpr int kMaxSlices = 64;    // nt + 1 at most
constexpr int kMaxUnrolled = 9;   // nt + 1 up to this unrolls (nt <= 8)

// The lam fields of traj_body_force, one pointer a time slice.
struct Slices {
  const float* p[kMaxSlices];
};

// cnt (1-4) consecutive values from p on; VEC: 4, with one 16-byte load.
template <bool VEC>
__device__ __forceinline__ void load(const float* __restrict__ p, int cnt,
                                     float (&x)[kPoints]) {
  if constexpr (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPoints; ++j) x[j] = j < cnt ? __ldg(p + j) : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store(float* __restrict__ p, int cnt,
                                      const float (&x)[kPoints]) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kPoints; ++j)
      if (j < cnt) __stcs(p + j, x[j]);
  }
}

// -(vt . g) as the card's torch.sum reduces the three products.
__device__ __forceinline__ float source(float v0, float v1, float v2, float g0, float g1,
                                        float g2) {
  const float s = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(v0, g0), __fmul_rn(v1, g1)), __fmul_rn(v2, g2)), 0.0f);
  return -s;
}

// The first point of a thread and how many of its kPoints lie in the field.
__device__ __forceinline__ long long first_point() {
  return (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPoints;
}

template <bool VEC>
__device__ __forceinline__ int point_count(long long p0, long long m) {
  return VEC ? kPoints : static_cast<int>(m - p0 < kPoints ? m - p0 : kPoints);
}

// NT1 > 0: nt + 1 slices, unrolled; NT1 == 0: nt1 slices in a loop.
template <int NT1, bool VEC>
__global__ void __launch_bounds__(kThreads)
    traj_source_kernel(const float* __restrict__ vt, const float* __restrict__ grad,
                       float* __restrict__ out, long long m, int nt1) {
  const long long p0 = first_point();
  if (p0 >= m) return;
  const int cnt = point_count<VEC>(p0, m);
  float v[3][kPoints];
#pragma unroll
  for (int c = 0; c < 3; ++c) load<VEC>(vt + c * m + p0, cnt, v[c]);
  if constexpr (NT1 > 0) {
    float g[NT1][3][kPoints];
#pragma unroll
    for (int t = 0; t < NT1; ++t)
#pragma unroll
      for (int c = 0; c < 3; ++c) load<VEC>(grad + (3LL * t + c) * m + p0, cnt, g[t][c]);
#pragma unroll
    for (int t = 0; t < NT1; ++t) {
      float s[kPoints];
#pragma unroll
      for (int j = 0; j < kPoints; ++j)
        s[j] = source(v[0][j], v[1][j], v[2][j], g[t][0][j], g[t][1][j], g[t][2][j]);
      store<VEC>(out + t * m + p0, cnt, s);
    }
  } else {
    for (int t = 0; t < nt1; ++t) {
      float g[3][kPoints];
#pragma unroll
      for (int c = 0; c < 3; ++c) load<VEC>(grad + (3LL * t + c) * m + p0, cnt, g[c]);
      float s[kPoints];
#pragma unroll
      for (int j = 0; j < kPoints; ++j)
        s[j] = source(v[0][j], v[1][j], v[2][j], g[0][j], g[1][j], g[2][j]);
      store<VEC>(out + t * m + p0, cnt, s);
    }
  }
}

// acc_c += (w_t lam_t) g[t,c] for one slice.
__device__ __forceinline__ void accumulate(float w, const float (&lam)[kPoints],
                                           const float (&g)[3][kPoints],
                                           float (&acc)[3][kPoints]) {
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const float wl = __fmul_rn(w, lam[j]);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c][j] = __fadd_rn(acc[c][j], __fmul_rn(wl, g[c][j]));
  }
}

template <int NT1, bool VEC>
__global__ void __launch_bounds__(kThreads)
    traj_body_force_kernel(Slices lam, const float* __restrict__ grad,
                           const float* __restrict__ a, float* __restrict__ out, long long m,
                           int nt1, float w_end, float w_mid) {
  const long long p0 = first_point();
  if (p0 >= m) return;
  const int cnt = point_count<VEC>(p0, m);
  float acc[3][kPoints];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < kPoints; ++j) acc[c][j] = 0.0f;
  if constexpr (NT1 > 0) {
    float l[NT1][kPoints];
    float g[NT1][3][kPoints];
#pragma unroll
    for (int t = 0; t < NT1; ++t) {
      load<VEC>(lam.p[t] + p0, cnt, l[t]);
#pragma unroll
      for (int c = 0; c < 3; ++c) load<VEC>(grad + (3LL * t + c) * m + p0, cnt, g[t][c]);
    }
#pragma unroll
    for (int t = 0; t < NT1; ++t)
      accumulate(t == 0 || t == NT1 - 1 ? w_end : w_mid, l[t], g[t], acc);
  } else {
    for (int t = 0; t < nt1; ++t) {
      float l[kPoints];
      float g[3][kPoints];
      load<VEC>(lam.p[t] + p0, cnt, l);
#pragma unroll
      for (int c = 0; c < 3; ++c) load<VEC>(grad + (3LL * t + c) * m + p0, cnt, g[c]);
      accumulate(t == 0 || t == nt1 - 1 ? w_end : w_mid, l, g, acc);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (a != nullptr) {
      float x[kPoints];
      load<VEC>(a + c * m + p0, cnt, x);
#pragma unroll
      for (int j = 0; j < kPoints; ++j) acc[c][j] = __fadd_rn(x[j], acc[c][j]);
    }
    store<VEC>(out + c * m + p0, cnt, acc[c]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

// Blocks of a launch over m points (0 where m is out of a grid's range).
unsigned blocks_for(long long m) {
  const long long threads = (m + kPoints - 1) / kPoints;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks);
}

// The launch of traj_source_kernel<NT1, VEC>.
template <int NT1, bool VEC>
struct Source {
  static void run(const float* vt, const float* grad, float* out, long long m, int nt1,
                  unsigned blocks, cudaStream_t s) {
    traj_source_kernel<NT1, VEC><<<blocks, kThreads, 0, s>>>(vt, grad, out, m, nt1);
  }
};

// The launch of traj_body_force_kernel<NT1, VEC>.
template <int NT1, bool VEC>
struct Body {
  static void run(const Slices* lam, const float* grad, const float* a, float* out,
                  long long m, int nt1, float w_end, float w_mid, unsigned blocks,
                  cudaStream_t s) {
    traj_body_force_kernel<NT1, VEC><<<blocks, kThreads, 0, s>>>(*lam, grad, a, out, m, nt1,
                                                                 w_end, w_mid);
  }
};

// F<NT1, VEC>::run(args...) with NT1 = nt1 up to kMaxUnrolled, else 0 (the
// slices in a loop).
template <template <int, bool> class F, bool VEC, typename... Args>
void by_slices(int nt1, Args... args) {
  static_assert(kMaxUnrolled == 9, "the cases below unroll nt + 1 = 1..9");
  switch (nt1) {
    case 1: F<1, VEC>::run(args...); break;
    case 2: F<2, VEC>::run(args...); break;
    case 3: F<3, VEC>::run(args...); break;
    case 4: F<4, VEC>::run(args...); break;
    case 5: F<5, VEC>::run(args...); break;
    case 6: F<6, VEC>::run(args...); break;
    case 7: F<7, VEC>::run(args...); break;
    case 8: F<8, VEC>::run(args...); break;
    case 9: F<9, VEC>::run(args...); break;
    default: F<0, VEC>::run(args...); break;
  }
}

bool bad_sizes(long long m, int nt1) { return m < 0 || nt1 < 1 || nt1 > kMaxSlices; }

}  // namespace

// vt (3, m), grad (nt1, 3, m), out (nt1, m), all fp32 and contiguous.
extern "C" int traj_source(const float* vt, const float* grad, float* out, long long m,
                           int nt1, void* stream) {
  if (bad_sizes(m, nt1)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const unsigned blocks = blocks_for(m);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every plane starts 16-byte aligned when its base is and m % 4 == 0
  if (m % kPoints == 0 && aligned16(vt) && aligned16(grad) && aligned16(out))
    by_slices<Source, true>(nt1, vt, grad, out, m, nt1, blocks, s);
  else
    by_slices<Source, false>(nt1, vt, grad, out, m, nt1, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

// lam: nt1 host pointers to (m,) fields; grad (nt1, 3, m); a (3, m) or null;
// out (3, m); all fp32 and contiguous. w_end weighs slices 0 and nt1 - 1,
// w_mid the others.
extern "C" int traj_body_force(const float* const* lam, const float* grad, const float* a,
                               float* out, long long m, int nt1, float w_end, float w_mid,
                               void* stream) {
  if (bad_sizes(m, nt1)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const unsigned blocks = blocks_for(m);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  Slices slices{};
  bool vec = m % kPoints == 0 && aligned16(grad) && aligned16(out) &&
             (a == nullptr || aligned16(a));
  for (int t = 0; t < nt1; ++t) {
    if (lam[t] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    slices.p[t] = lam[t];
    vec = vec && aligned16(lam[t]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    by_slices<Body, true>(nt1, &slices, grad, a, out, m, nt1, w_end, w_mid, blocks, s);
  else
    by_slices<Body, false>(nt1, &slices, grad, a, out, m, nt1, w_end, w_mid, blocks, s);
  return static_cast<int>(cudaGetLastError());
}
