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
// Design: a streaming halo kernel, one shape per kind of axis, with no index
// division or wrap per tap. A field stack (B, N1, N2, N3) is seen as
// (outer, n, inner) along the stencil axis.
//   * Strided axes (x1, x2: inner = N2 N3 or N3): each thread owns one
//     column of the contiguous inner dimension (a warp reads 128 B rows,
//     coalesced) and walks a chunk of kChunk = 64 outputs along the axis. It
//     loads the kChunk + 2R rows it needs once, into a register window
//     (fully unrolled, R a template parameter), wrapping the row index once
//     per loaded row (start from the floor-mod of i0 - R, then a compare per
//     row, so any n >= 1 works, n < R included), and computes every output
//     from registers. Each input is read (64 + 2R)/64 times: 1.125 for FD8,
//     1.22 for the prefilter, and neighbouring chunks of a column are
//     neighbouring blocks, so their halo rows meet in L2. The chunk's tail
//     past n is loaded (wrapped) but not stored.
//   * The contiguous axis (x3): a CTA holds whole x3 rows in shared memory,
//     each extended by its wrapped halo of R values on both sides (taken
//     once per row), loaded with coalesced float4 loads when n3 % 4 == 0,
//     then each thread computes four consecutive outputs from five aligned
//     float4 shared-memory reads and stores them as one float4 (scalar loads,
//     reads and stores otherwise).
// Both keep the plain version's tap order (acc = c0 f or 0, then acc +=
// c_k (f[+k] +- f[-k]) for k = 1..R, then * scale), so the two differ only
// by FMA contraction.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;

struct Taps {
  float c[kMaxTaps];
};

// ---- K1, strided axes -----------------------------------------------------

constexpr int kChunk = 64;       // outputs per thread along a strided axis
constexpr int kColThreads = 128; // columns per CTA

// Grid: x = outer * chunks (chunk fastest), y = column blocks of `inner`.
template <int R, bool SYM>
__global__ void __launch_bounds__(kColThreads)
stencil_strided_kernel(const float* __restrict__ f, float* __restrict__ out, int n,
                       long long inner, int chunks, Taps taps, float scale) {
  const long long col = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (col >= inner) return;
  const int chunk = static_cast<int>(blockIdx.x % static_cast<unsigned>(chunks));
  const long long o = blockIdx.x / static_cast<unsigned>(chunks);
  const long long base = o * n * inner + col;
  const int i0 = chunk * kChunk;

  // w[r] = f[i0 - R + r], periodic: the row index wraps once per row.
  int j = (i0 - R) % n;
  if (j < 0) j += n;
  const float* p = f + base + j * inner;
  float w[kChunk + 2 * R];
#pragma unroll
  for (int r = 0; r < kChunk + 2 * R; ++r) {
    w[r] = *p;
    p += inner;
    if (++j == n) {
      j = 0;
      p = f + base;
    }
  }
  const int n_out = n - i0 < kChunk ? n - i0 : kChunk;
  float* q = out + base + static_cast<long long>(i0) * inner;
#pragma unroll
  for (int t = 0; t < kChunk; ++t) {
    if (t < n_out) {
      float acc = SYM ? taps.c[0] * w[t + R] : 0.0f;
#pragma unroll
      for (int k = 1; k <= R; ++k) {
        const float fp = w[t + R + k];
        const float fm = w[t + R - k];
        acc = acc + taps.c[SYM ? k : k - 1] * (SYM ? fp + fm : fp - fm);
      }
      q[t * inner] = acc * scale;
    }
  }
}

template <int R, bool SYM>
int strided(const float* f, float* out, long long outer, int n, long long inner,
            const Taps& taps, float scale, cudaStream_t stream) {
  const int chunks = (n + kChunk - 1) / kChunk;
  const int threads = inner >= kColThreads ? kColThreads
                                           : static_cast<int>((inner + 31) / 32 * 32);
  const long long col_blocks = (inner + threads - 1) / threads;
  const long long x_blocks = outer * chunks;
  if (col_blocks > 65535 || x_blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(x_blocks), static_cast<unsigned>(col_blocks));
  stencil_strided_kernel<R, SYM><<<grid, threads, 0, stream>>>(f, out, n, inner, chunks,
                                                                 taps, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- K1, the contiguous axis ----------------------------------------------

constexpr int kPad = 8;          // >= the largest radius, a multiple of 4
constexpr int kRowThreads = 256;

// acc over the taps around w[C] (w holds at least C - R .. C + R), R <= 8
// at run time, in the plain version's order; tap indices stay compile-time
// constants, so the taps stay in the parameter bank.
template <int C, bool SYM>
__device__ __forceinline__ float taps_at(const float* w, int radius, const Taps& taps,
                                         float scale) {
  float acc = SYM ? taps.c[0] * w[C] : 0.0f;
#pragma unroll
  for (int k = 1; k <= kPad; ++k) {
    if (k <= radius) {
      const float fp = w[C + k];
      const float fm = w[C - k];
      acc = acc + taps.c[SYM ? k : k - 1] * (SYM ? fp + fm : fp - fm);
    }
  }
  return acc * scale;
}

// One CTA of (bx, by) threads holds `by` rows of length n in shared memory,
// row y at sm[y * (n + 2 kPad) + kPad + i] for i in -R .. n + R - 1.
// VEC (n % 4 == 0, 16-byte aligned f and out): float4 loads, and each thread
// computes four outputs 4c .. 4c + 3 from sm[4c - 8 .. 4c + 11].
template <bool VEC, bool SYM>
__global__ void __launch_bounds__(kRowThreads)
stencil_rows_kernel(const float* __restrict__ f, float* __restrict__ out, long long rows,
                    int n, int radius, Taps taps, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = n + 2 * kPad;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  float* srow = reinterpret_cast<float*>(smem4) + threadIdx.y * ld + kPad;
  const float* frow = f + row * n;
  if (live) {
    if (VEC) {
      for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
        const float4 x = *reinterpret_cast<const float4*>(frow + 4 * c);
        *reinterpret_cast<float4*>(srow + 4 * c) = x;
      }
    } else {
      for (int c = threadIdx.x; c < n; c += blockDim.x) srow[c] = frow[c];
    }
    // the halo: -R .. -1 and n .. n + R - 1, wrapped once each
    for (int h = threadIdx.x; h < 2 * radius; h += blockDim.x) {
      const int i = h < radius ? h - radius : n + h - radius;
      int src = i % n;
      if (src < 0) src += n;
      srow[i] = frow[src];
    }
  }
  __syncthreads();
  if (!live) return;
  float* orow = out + row * n;
  if (VEC) {
    for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
      float w[20];
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(srow + 4 * c - 8 + 4 * u);
        w[4 * u] = x.x;
        w[4 * u + 1] = x.y;
        w[4 * u + 2] = x.z;
        w[4 * u + 3] = x.w;
      }
      float4 y;
      y.x = taps_at<8, SYM>(w, radius, taps, scale);
      y.y = taps_at<9, SYM>(w, radius, taps, scale);
      y.z = taps_at<10, SYM>(w, radius, taps, scale);
      y.w = taps_at<11, SYM>(w, radius, taps, scale);
      *reinterpret_cast<float4*>(orow + 4 * c) = y;
    }
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      float w[2 * kPad + 1];
#pragma unroll
      for (int d = -kPad; d <= kPad; ++d)
        w[d + kPad] = (d >= -radius && d <= radius) ? srow[c + d] : 0.0f;
      orow[c] = taps_at<kPad, SYM>(w, radius, taps, scale);
    }
  }
}

template <bool VEC, bool SYM>
int rows_launch(const float* f, float* out, long long rows, int n, int radius,
                const Taps& taps, float scale, cudaStream_t stream) {
  const int q = VEC ? n / 4 : n;
  const int bx = q < kRowThreads ? q : kRowThreads;
  const int by = kRowThreads / bx;
  const size_t smem = sizeof(float) * static_cast<size_t>(by) * (n + 2 * kPad);
  const long long blocks = (rows + by - 1) / by;
  if (blocks > INT_MAX || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_rows_kernel<VEC, SYM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stencil_rows_kernel<VEC, SYM><<<static_cast<unsigned>(blocks), dim3(bx, by), smem, stream>>>(
      f, out, rows, n, radius, taps, scale);
  return static_cast<int>(cudaGetLastError());
}

int rows_dispatch(const float* f, float* out, long long rows, int n, int radius,
                  int symmetric, const Taps& taps, float scale, cudaStream_t stream) {
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return symmetric ? rows_launch<true, true>(f, out, rows, n, radius, taps, scale, stream)
                     : rows_launch<true, false>(f, out, rows, n, radius, taps, scale, stream);
  return symmetric ? rows_launch<false, true>(f, out, rows, n, radius, taps, scale, stream)
                   : rows_launch<false, false>(f, out, rows, n, radius, taps, scale, stream);
}

// R = ntaps - 1 (symmetric) or ntaps (antisymmetric), 1..8 taps.
int strided_dispatch(int ntaps, int symmetric, const float* f, float* out, long long outer,
                     int n, long long inner, const Taps& t, float scale, cudaStream_t s) {
  if (symmetric) {
    switch (ntaps - 1) {
      case 0: return strided<0, true>(f, out, outer, n, inner, t, scale, s);
      case 1: return strided<1, true>(f, out, outer, n, inner, t, scale, s);
      case 2: return strided<2, true>(f, out, outer, n, inner, t, scale, s);
      case 3: return strided<3, true>(f, out, outer, n, inner, t, scale, s);
      case 4: return strided<4, true>(f, out, outer, n, inner, t, scale, s);
      case 5: return strided<5, true>(f, out, outer, n, inner, t, scale, s);
      case 6: return strided<6, true>(f, out, outer, n, inner, t, scale, s);
      case 7: return strided<7, true>(f, out, outer, n, inner, t, scale, s);
    }
  } else {
    switch (ntaps) {
      case 1: return strided<1, false>(f, out, outer, n, inner, t, scale, s);
      case 2: return strided<2, false>(f, out, outer, n, inner, t, scale, s);
      case 3: return strided<3, false>(f, out, outer, n, inner, t, scale, s);
      case 4: return strided<4, false>(f, out, outer, n, inner, t, scale, s);
      case 5: return strided<5, false>(f, out, outer, n, inner, t, scale, s);
      case 6: return strided<6, false>(f, out, outer, n, inner, t, scale, s);
      case 7: return strided<7, false>(f, out, outer, n, inner, t, scale, s);
      case 8: return strided<8, false>(f, out, outer, n, inner, t, scale, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (batch * n1 * static_cast<long long>(n2) * n3 == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 2)
    return rows_dispatch(f, out, batch * n1 * static_cast<long long>(n2), n3,
                         symmetric ? ntaps - 1 : ntaps, symmetric, t, scale, s);
  const long long outer = axis == 0 ? batch : batch * n1;
  const int n = axis == 0 ? n1 : n2;
  const long long inner = axis == 0 ? static_cast<long long>(n2) * n3 : n3;
  return strided_dispatch(ntaps, symmetric, f, out, outer, n, inner, t, scale, s);
}
