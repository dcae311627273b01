// Periodic 1D stencil along one axis of a stack of 3D fields (kernel K1).
//
// Replaces the Pallas kernel `stencil_pencil` (src/repro/kernels/pencil.py:135,
// body `_stencil_body` at :120). Two callers share it:
//   * FD8 first derivative, antisymmetric, radius 4, scale 1/h
//       out = scale * sum_k c_k (f[i+k] - f[i-k])
//   * cubic B-spline prefilter, symmetric, radius 7, three axis passes
//       out = scale * (c0 f[i] + sum_k c_k (f[i+k] + f[i-k]))
//
// What bounds it on an H100: bytes. Per voxel it reads 4 B and writes 4 B
// (8-15 taps, ~13-30 flops), far below the card's ~20 flop/B balance point,
// so the least time is 8 B/voxel over 3.35 TB/s (40 us for one 256^3 field).
//
// Design: one thread per output voxel, neighbouring threads on neighbouring
// x3 addresses, so every tap load of a warp is one coalesced 128 B line. The
// 2R neighbour reads along the stencil axis are left to L1/L2 to serve again;
// there is no shared-memory halo tile yet (later work). Periodic wrap is a
// floor-mod on the axis index, taken non-negative. The sum is accumulated in
// the same tap order as the plain PyTorch version, so the two differ only by
// FMA contraction.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;

struct Taps {
  float c[kMaxTaps];
};

__device__ __forceinline__ int wrap(int j, int n) {
  int m = j % n;
  return m < 0 ? m + n : m;
}

__global__ void stencil_axis_kernel(const float* __restrict__ f,
                                    float* __restrict__ out, long long total,
                                    int n, long long stride, int ntaps,
                                    int symmetric, Taps taps, float scale) {
  long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= total) return;
  const int i = static_cast<int>((g / stride) % n);
  const long long base = g - static_cast<long long>(i) * stride;
  float acc;
  if (symmetric) {
    // taps = (c0, c1, ..., cR)
    acc = taps.c[0] * f[g];
    for (int k = 1; k < ntaps; ++k) {
      const float fp = f[base + wrap(i + k, n) * stride];
      const float fm = f[base + wrap(i - k, n) * stride];
      acc = acc + taps.c[k] * (fp + fm);
    }
  } else {
    // taps = (c1, ..., cR)
    acc = 0.0f;
    for (int k = 1; k <= ntaps; ++k) {
      const float fp = f[base + wrap(i + k, n) * stride];
      const float fm = f[base + wrap(i - k, n) * stride];
      acc = acc + taps.c[k - 1] * (fp - fm);
    }
  }
  out[g] = acc * scale;
}

}  // namespace

extern "C" int stencil_axis_f32(const float* f, float* out, long long batch,
                                int n1, int n2, int n3, int axis,
                                const float* taps, int ntaps, int symmetric,
                                float scale, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t = {};
  for (int k = 0; k < ntaps; ++k) t.c[k] = taps[k];
  const int n = axis == 0 ? n1 : (axis == 1 ? n2 : n3);
  const long long stride = axis == 0 ? static_cast<long long>(n2) * n3
                                     : (axis == 1 ? n3 : 1);
  const long long total = batch * n1 * static_cast<long long>(n2) * n3;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  stencil_axis_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      f, out, total, n, stride, ntaps, symmetric, t, scale);
  return static_cast<int>(cudaGetLastError());
}
