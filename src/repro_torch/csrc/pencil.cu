// Periodic 1D stencil along one axis of a stack of 3D fields (kernel K1),
// and its valid-mode counterpart on a halo-extended axis (kernel K5).
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

// Kernel K5: valid-mode antisymmetric stencil along one axis of a stack of
// halo-extended 3D fields.
//
// Replaces the Pallas kernel `stencil_pencil_valid`
// (src/repro/kernels/pencil.py:81, body `_stencil_valid_body` at :65): the
// x1 FD8 derivative of the slab-parallel solve, whose boundary rows come from
// a halo exchange instead of a periodic wrap. The input has n + 2R rows on
// the stencil axis, the output n; there is no wrap:
//     out[i] = scale * sum_k c_k (f[i+R+k] - f[i+R-k])
//
// What bounds it on an H100: bytes, as K1. Per output voxel it reads a
// little more than 4 B (the 2R halo rows once more) and writes 4 B, with
// 3R flops; at 264x256x256 -> 256x256x256 fp32 the least time is 136.3 MB
// over 3.35 TB/s, 40.7 us.
//
// Design: one thread per output voxel, neighbouring threads on neighbouring
// x3 addresses (coalesced tap loads, as K1); the 2R reads along the axis are
// left to L1/L2. No index wraps: every tap lies inside the extended input.
// The sum runs in the plain version's tap order (zero, then k = 1..R, then
// the scale), the same arithmetic as K1's antisymmetric branch, so K5 on an
// exchanged slab gives K1's periodic result on the interior rows.
__global__ void stencil_valid_kernel(const float* __restrict__ f,
                                     float* __restrict__ out, long long total,
                                     int o1, int o2, int o3, int axis,
                                     int radius, Taps taps, float scale) {
  long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= total) return;
  // Output coordinates (b, i1, i2, i3); the input has 2R more rows on `axis`.
  const int i3 = static_cast<int>(g % o3);
  long long t = g / o3;
  const int i2 = static_cast<int>(t % o2);
  t /= o2;
  const int i1 = static_cast<int>(t % o1);
  const long long b = t / o1;
  const int n1 = o1 + (axis == 0 ? 2 * radius : 0);
  const int n2 = o2 + (axis == 1 ? 2 * radius : 0);
  const int n3 = o3 + (axis == 2 ? 2 * radius : 0);
  const long long stride = axis == 0 ? static_cast<long long>(n2) * n3
                                     : (axis == 1 ? n3 : 1);
  const long long c = ((b * n1 + i1 + (axis == 0 ? radius : 0)) * n2 + i2 +
                       (axis == 1 ? radius : 0)) * n3 + i3 +
                      (axis == 2 ? radius : 0);
  float acc = 0.0f;
  for (int k = 1; k <= radius; ++k) {
    const float fp = f[c + k * stride];
    const float fm = f[c - k * stride];
    acc = acc + taps.c[k - 1] * (fp - fm);
  }
  out[g] = acc * scale;
}

}  // namespace

extern "C" int stencil_valid_f32(const float* f, float* out, long long batch,
                                 int n1, int n2, int n3, int axis,
                                 const float* taps, int ntaps, float scale,
                                 void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t = {};
  for (int k = 0; k < ntaps; ++k) t.c[k] = taps[k];
  // (n1, n2, n3) are the input's sizes; the output is 2R shorter on `axis`.
  const int o1 = axis == 0 ? n1 - 2 * ntaps : n1;
  const int o2 = axis == 1 ? n2 - 2 * ntaps : n2;
  const int o3 = axis == 2 ? n3 - 2 * ntaps : n3;
  if (o1 <= 0 || o2 <= 0 || o3 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = batch * o1 * static_cast<long long>(o2) * o3;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  stencil_valid_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f, out, total, o1, o2, o3, axis, ntaps, t, scale);
  return static_cast<int>(cudaGetLastError());
}

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
