// Periodic 1D stencil along one axis of a stack of 3D fields (kernel K1),
// and its valid-mode counterpart on a halo-extended axis (kernel K5).
//
// K1 `stencil_axis_f32` replaces the Pallas kernel `stencil_pencil`
// (src/repro/kernels/pencil.py:135, body `_stencil_body` at :120). Two
// callers share it:
//   * FD8 first derivative, antisymmetric, radius 4, scale 1/h
//       out = scale * sum_k c_k (f[i+k] - f[i-k])
//   * cubic B-spline prefilter, symmetric, radius 7, three axis passes
//       out = scale * (c0 f[i] + sum_k c_k (f[i+k] + f[i-k]))
//
// K5 `stencil_valid_f32` replaces `stencil_pencil_valid` (pencil.py:81,
// body `_stencil_valid_body` at :65): the x1 FD8 derivative of the
// slab-parallel solve, whose boundary rows come from a halo exchange instead
// of a periodic wrap. The input has n + 2R rows on the stencil axis, the
// output n; there is no wrap:
//     out[i] = scale * sum_k c_k (f[i+R+k] - f[i+R-k])
//
// What bounds both on an H100: bytes. Per voxel they read 4 B and write 4 B
// (8-15 taps, ~13-30 flops), far below the card's ~20 flop/B balance point,
// so the least time is 8 B/voxel over 3.35 TB/s (40 us for one 256^3 field;
// K5 reads the 2R halo rows besides, 40.7 us at 264x256x256 -> 256^3).
//
// Design: a streaming halo kernel, one shape per kind of axis, with no index
// division per voxel. A field stack (B, N1, N2, N3) is seen as (outer, n,
// inner) along the stencil axis; a WRAP template flag selects K1's periodic
// rows or K5's extended input (n + 2R rows, no wrap).
//   * Strided axes (x1, x2: inner = N2 N3 or N3): each thread owns one
//     column of the contiguous inner dimension (a warp reads 128 B rows,
//     coalesced) and walks a chunk of kChunk = 64 outputs along the axis. It
//     loads the kChunk + 2R rows it needs once, into a register window
//     (fully unrolled, R a template parameter), and computes every output
//     from registers. K1 wraps the row index once per loaded row (start from
//     the floor-mod of i0 - R, then a compare per row, so any n >= 1 works,
//     n < R included); the chunk's tail past n is loaded (wrapped) but not
//     stored. K5 reads rows i0 .. i0 + kChunk + 2R - 1 of the extended input
//     as they are and leaves the rows past its end unread. Each input is read
//     (64 + 2R)/64 times: 1.125 for FD8, 1.22 for the prefilter, and
//     neighbouring chunks of a column are neighbouring blocks, so their halo
//     rows meet in L2.
//   * The contiguous axis (x3): a CTA holds whole x3 rows in shared memory,
//     each extended by its halo of R values on both sides: K1 takes the
//     wrapped halo once per row, K5 stages its n3 + 2R input values as they
//     are. Loads are coalesced float4 loads when the rows allow it (n3 % 4 ==
//     0, and R % 4 == 0 for K5's extended rows); then each thread computes
//     four consecutive outputs from five aligned float4 shared-memory reads
//     and stores them as one float4 (scalar loads, reads and stores
//     otherwise).
// Both keep the plain version's tap order (acc = c0 f or 0, then acc +=
// c_k (f[+k] +- f[-k]) for k = 1..R, then * scale), so kernel and plain
// version differ only by FMA contraction, and K5 on an exchanged slab gives
// K1's periodic result on the interior rows. K5's instantiations are
// kernels of their own name (stencil_valid_*), so a profile tells them apart.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;

struct Taps {
  float c[kMaxTaps];
};

// ---- strided axes -----------------------------------------------------------

constexpr int kChunk = 64;       // outputs per thread along a strided axis
constexpr int kColThreads = 128; // columns per CTA

// Grid: x = outer * chunks (chunk fastest), y = column blocks of `inner`.
// n output rows; the input has n rows (WRAP) or n + 2R.
template <int R, bool SYM, bool WRAP>
__device__ __forceinline__ void strided_body(const float* __restrict__ f,
                                             float* __restrict__ out, int n,
                                             long long inner, int chunks, const Taps& taps,
                                             float scale) {
  const long long col = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
  if (col >= inner) return;
  const int chunk = static_cast<int>(blockIdx.x % static_cast<unsigned>(chunks));
  const long long o = blockIdx.x / static_cast<unsigned>(chunks);
  const int n_in = WRAP ? n : n + 2 * R;
  const int i0 = chunk * kChunk;

  float w[kChunk + 2 * R];
  if constexpr (WRAP) {
    // w[r] = f[i0 - R + r], periodic: the row index wraps once per row.
    const long long base = o * n * inner + col;
    int j = (i0 - R) % n;
    if (j < 0) j += n;
    const float* p = f + base + j * inner;
#pragma unroll
    for (int r = 0; r < kChunk + 2 * R; ++r) {
      w[r] = *p;
      p += inner;
      if (++j == n) {
        j = 0;
        p = f + base;
      }
    }
  } else {
    // w[r] = f_ext[i0 + r]; rows past the extended input are not read.
    const float* p = f + (o * n_in + i0) * inner + col;
    const int avail = n_in - i0;
#pragma unroll
    for (int r = 0; r < kChunk + 2 * R; ++r) w[r] = r < avail ? p[r * inner] : 0.0f;
  }
  const int n_out = n - i0 < kChunk ? n - i0 : kChunk;
  float* q = out + (o * n + i0) * inner + col;
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
__global__ void __launch_bounds__(kColThreads)
stencil_strided_kernel(const float* __restrict__ f, float* __restrict__ out, int n,
                       long long inner, int chunks, Taps taps, float scale) {
  strided_body<R, SYM, true>(f, out, n, inner, chunks, taps, scale);
}

template <int R>
__global__ void __launch_bounds__(kColThreads)
stencil_valid_strided_kernel(const float* __restrict__ f, float* __restrict__ out, int n,
                             long long inner, int chunks, Taps taps, float scale) {
  strided_body<R, false, false>(f, out, n, inner, chunks, taps, scale);
}

template <int R, bool SYM, bool WRAP>
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
  if constexpr (WRAP)
    stencil_strided_kernel<R, SYM><<<grid, threads, 0, stream>>>(f, out, n, inner, chunks,
                                                                   taps, scale);
  else
    stencil_valid_strided_kernel<R><<<grid, threads, 0, stream>>>(f, out, n, inner, chunks,
                                                                    taps, scale);
  return static_cast<int>(cudaGetLastError());
}

// Radius 0..8 (K1: R = ntaps - 1 symmetric, ntaps antisymmetric; K5: R =
// ntaps, antisymmetric, no wrap).
template <bool SYM, bool WRAP>
int strided_dispatch(int radius, const float* f, float* out, long long outer, int n,
                     long long inner, const Taps& t, float scale, cudaStream_t s) {
  switch (radius) {
    case 0:
      if constexpr (SYM) return strided<0, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
      break;
    case 1: return strided<1, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
    case 2: return strided<2, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
    case 3: return strided<3, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
    case 4: return strided<4, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
    case 5: return strided<5, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
    case 6: return strided<6, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
    case 7: return strided<7, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
    case 8:
      if constexpr (!SYM) return strided<8, SYM, WRAP>(f, out, outer, n, inner, t, scale, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the contiguous axis ----------------------------------------------------

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

// One CTA of (bx, by) threads holds `by` rows of n outputs in shared memory,
// row y at sm[y * (n + 2 kPad) + kPad + i] for i in -R .. n + R - 1. Input
// rows hold n values (WRAP; the halo wraps) or n + 2R (the halo is there).
// VEC (16-byte aligned f and out, n % 4 == 0 and, without WRAP, R % 4 == 0):
// float4 loads, and each thread computes four outputs 4c .. 4c + 3 from
// sm[4c - 8 .. 4c + 11].
template <bool VEC, bool SYM, bool WRAP>
__device__ __forceinline__ void rows_body(const float* __restrict__ f,
                                          float* __restrict__ out, long long rows, int n,
                                          int radius, const Taps& taps, float scale) {
  extern __shared__ float4 smem4[];
  const int ld = n + 2 * kPad;
  const int n_in = WRAP ? n : n + 2 * radius;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  float* srow = reinterpret_cast<float*>(smem4) + threadIdx.y * ld + kPad;
  const float* frow = f + row * n_in;
  // input value i goes to srow[i] (WRAP) or srow[i - R]
  float* sdst = WRAP ? srow : srow - radius;
  if (live) {
    if (VEC) {
      for (int c = threadIdx.x; c < n_in / 4; c += blockDim.x) {
        const float4 x = *reinterpret_cast<const float4*>(frow + 4 * c);
        *reinterpret_cast<float4*>(sdst + 4 * c) = x;
      }
    } else {
      for (int c = threadIdx.x; c < n_in; c += blockDim.x) sdst[c] = frow[c];
    }
    if (WRAP) {
      // the halo: -R .. -1 and n .. n + R - 1, wrapped once each
      for (int h = threadIdx.x; h < 2 * radius; h += blockDim.x) {
        const int i = h < radius ? h - radius : n + h - radius;
        int src = i % n;
        if (src < 0) src += n;
        srow[i] = frow[src];
      }
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
__global__ void __launch_bounds__(kRowThreads)
stencil_rows_kernel(const float* __restrict__ f, float* __restrict__ out, long long rows,
                    int n, int radius, Taps taps, float scale) {
  rows_body<VEC, SYM, true>(f, out, rows, n, radius, taps, scale);
}

template <bool VEC>
__global__ void __launch_bounds__(kRowThreads)
stencil_valid_rows_kernel(const float* __restrict__ f, float* __restrict__ out,
                          long long rows, int n, int radius, Taps taps, float scale) {
  rows_body<VEC, false, false>(f, out, rows, n, radius, taps, scale);
}

template <bool VEC, bool SYM, bool WRAP>
int rows_launch(const float* f, float* out, long long rows, int n, int radius,
                const Taps& taps, float scale, cudaStream_t stream) {
  void (*kernel)(const float*, float*, long long, int, int, Taps, float);
  if constexpr (WRAP)
    kernel = stencil_rows_kernel<VEC, SYM>;
  else
    kernel = stencil_valid_rows_kernel<VEC>;
  const int q = VEC ? n / 4 : n;
  const int bx = q < kRowThreads ? q : kRowThreads;
  const int by = kRowThreads / bx;
  const size_t smem = sizeof(float) * static_cast<size_t>(by) * (n + 2 * kPad);
  const long long blocks = (rows + by - 1) / by;
  if (blocks > INT_MAX || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), dim3(bx, by), smem, stream>>>(f, out, rows, n,
                                                                        radius, taps, scale);
  return static_cast<int>(cudaGetLastError());
}

// n outputs a row.
template <bool SYM, bool WRAP>
int rows_dispatch(const float* f, float* out, long long rows, int n, int radius,
                  const Taps& taps, float scale, cudaStream_t stream) {
  const bool vec = n % 4 == 0 && (WRAP || radius % 4 == 0) &&
                   reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? rows_launch<true, SYM, WRAP>(f, out, rows, n, radius, taps, scale, stream)
             : rows_launch<false, SYM, WRAP>(f, out, rows, n, radius, taps, scale, stream);
}

// One stencil along `axis` of a (batch, n1, n2, n3) input: periodic (WRAP),
// or valid with an output 2R shorter on `axis`.
template <bool SYM, bool WRAP>
int stencil_launch(const float* f, float* out, long long batch, int n1, int n2, int n3,
                   int axis, int radius, const Taps& t, float scale, cudaStream_t s) {
  const int n = (axis == 0 ? n1 : axis == 1 ? n2 : n3) - (WRAP ? 0 : 2 * radius);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * n1 * static_cast<long long>(n2) * n3 == 0) return 0;
  if (axis == 2)
    return rows_dispatch<SYM, WRAP>(f, out, batch * n1 * static_cast<long long>(n2), n,
                                    radius, t, scale, s);
  const long long outer = axis == 0 ? batch : batch * n1;
  const long long inner = axis == 0 ? static_cast<long long>(n2) * n3 : n3;
  return strided_dispatch<SYM, WRAP>(radius, f, out, outer, n, inner, t, scale, s);
}

Taps make_taps(const float* taps, int ntaps) {
  Taps t = {};
  for (int k = 0; k < ntaps; ++k) t.c[k] = taps[k];
  return t;
}

}  // namespace

// K5: (n1, n2, n3) are the input's sizes; the output is 2R = 2 ntaps shorter
// on `axis`.
extern "C" int stencil_valid_f32(const float* f, float* out, long long batch,
                                 int n1, int n2, int n3, int axis,
                                 const float* taps, int ntaps, float scale,
                                 void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return stencil_launch<false, false>(f, out, batch, n1, n2, n3, axis, ntaps,
                                      make_taps(taps, ntaps), scale,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int stencil_axis_f32(const float* f, float* out, long long batch,
                                int n1, int n2, int n3, int axis,
                                const float* taps, int ntaps, int symmetric,
                                float scale, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || axis < 0 || axis > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Taps t = make_taps(taps, ntaps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return symmetric
             ? stencil_launch<true, true>(f, out, batch, n1, n2, n3, axis, ntaps - 1, t, scale, s)
             : stencil_launch<false, true>(f, out, batch, n1, n2, n3, axis, ntaps, t, scale, s);
}
