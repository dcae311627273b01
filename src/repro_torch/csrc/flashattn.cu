// Flash attention (kernel K6): softmax attention with an online softmax,
// optionally causal, on (BH, S, hd) tensors with the heads folded into the
// leading dimension (MHA: K and V have as many heads as Q).
//
// Replaces the Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flashattn/flashattn.py:72, body `_flash_body` at :37),
// and computes what it computes:
//   q' = fp32(q) * fp32(1/sqrt(hd));  s = q' fp32(k)^T  (fp32)
//   causal: s = -1e30 where the key position exceeds the query position
//   online softmax over key tiles: m, l and acc in fp32,
//     m' = max(m, max s); p = exp(s - m'); c = exp(m - m');
//     l' = l c + sum p;   acc' = acc c + p fp32(v)
//   out = acc / max(l, 1e-30), rounded to q's dtype (fp32 or bf16).
//
// What bounds it on an H100: operations. Per (query, key) pair it does 4 hd
// flops (2 hd for q k^T, 2 hd for p v) against 4 hd elements of q, k, v and
// out over the whole call, so at S = 2048 the flop-to-byte ratio is ~S/2
// (bf16), past the card's ~295 flop/B balance point. The least time is the
// flops over the tensor cores' 989 TFLOP/s (bf16 inputs) or the 67 TFLOP/s of
// fp32 (fp32 inputs); bytes over 3.35 TB/s come second. For the Qwen1.5-0.5B
// prefill (BH = 128, S = 2048, hd = 64, causal) that is 68.7 GFLOP: 0.069 ms
// at the bf16 tensor-core rate, 1.03 ms at the fp32 FMA rate.
//
// Design (simple, on the CUDA cores): one CTA of 256 threads per (bh, 64-row
// query tile); the scaled q tile lives transposed in shared memory in fp32
// for the CTA's life. The CTA walks the key tiles of 64 rows: each is staged
// through shared memory (k transposed, v as it is, both in fp32, rows past S
// zero), each thread computes a 4x4 block of the 64x64 score tile with float4
// shared-memory loads, masks it (ragged tail: key >= S; causal: key > query),
// and updates the online-softmax state of its 4 rows, reduced across the 16
// threads that share a row with warp shuffles. p goes back to shared memory
// (transposed) and each thread adds p v into its 4 rows x hd/16 columns of
// acc, which stays in registers. Causal CTAs stop at the diagonal tile: key
// tiles above it are fully masked, and skipping them is exact because the
// first tile always holds key 0, so m is finite before any masked tile. CTAs
// are issued heaviest (last) query tile first.
//
// Left out, for later work: tensor cores (wgmma, or mma.sync) and TMA/cp.async
// double buffering of the key tiles; keeping k and v in bf16 in shared memory
// (here they are widened to fp32 on the way in); folding GQA's group into the
// indexing, so repeated K/V heads need not be materialised by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // query rows per CTA, key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads, a 4x4 score block each
constexpr int kLd = kTile + 4;   // padded row (floats) of the transposed tiles
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Reduce over the 16 threads that share a score row (lanes differing in
// their low 4 bits).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * HD * kLd + kTile * HD + kTile * kLd);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int bh, int s_len, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [HD][kLd]   q' transposed
  float* kt = qt + HD * kLd;                    // [HD][kLd]   k tile transposed
  float* vs = kt + HD * kLd;                    // [kTile][HD] v tile
  float* pt = vs + kTile * HD;                  // [kTile][kLd] p transposed

  constexpr int kCols = HD / 16;  // output columns per thread: 4 or 8
  const int tid = threadIdx.x;
  const int tx = tid % 16;        // score columns 4tx..4tx+3, output columns 4tx+64c..
  const int ty = tid / 16;        // rows 4ty..4ty+3
  const int n_tiles = (s_len + kTile - 1) / kTile;
  const int b = blockIdx.x % bh;
  const int qi = n_tiles - 1 - static_cast<int>(blockIdx.x / bh);
  const int q0 = qi * kTile;
  const long long head = static_cast<long long>(b) * s_len * HD;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;

  for (int idx = tid; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int pos = q0 + r;
    qt[d * kLd + r] = pos < s_len ? to_f32(qh[static_cast<long long>(pos) * HD + d]) * scale
                                  : 0.0f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int kv_tiles = causal ? qi + 1 : n_tiles;
  for (int t = 0; t < kv_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's reads of kt, vs and pt are done
    for (int idx = tid; idx < kTile * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int pos = k0 + r;
      const bool in = pos < s_len;
      const long long g = static_cast<long long>(pos) * HD + d;
      kt[d * kLd + r] = in ? to_f32(kh[g]) : 0.0f;
      vs[r * HD + d] = in ? to_f32(vh[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(kt + d * kLd + 4 * tx);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        if (kpos >= s_len || (causal && kpos > qpos)) s[i][j] = kMasked;
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
      // l is kept as this thread's share of the row sum; the 16 shares add
      // up to the row's l (they share m, so they share every correction).
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + j * kLd + 4 * ty);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c4 = 0; c4 < kCols / 4; ++c4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + j * HD + 64 * c4 + 4 * tx);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][4 * c4 + jj] = fmaf(p[i], vv[jj], acc[i][4 * c4 + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(row_sum(l[i]), 1e-30f);
    const int pos = q0 + 4 * ty + i;
    if (pos >= s_len) continue;
    T* orow = out + head + static_cast<long long>(pos) * HD;
#pragma unroll
    for (int c4 = 0; c4 < kCols / 4; ++c4)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        store(orow + 64 * c4 + 4 * tx + jj, acc[i][4 * c4 + jj] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s_len, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_tiles = static_cast<unsigned>((s_len + kTile - 1) / kTile);
  flash_attention_kernel<T, HD><<<n_tiles * static_cast<unsigned>(bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), bh, s_len, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int s_len, int hd, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<T, 64>(q, k, v, out, bh, s_len, causal, scale, st);
  if (hd == 128) return launch<T, 128>(q, k, v, out, bh, s_len, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int bh, int s_len, int hd, int causal, float scale,
                                   void* stream) {
  return dispatch<float>(q, k, v, out, bh, s_len, hd, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int bh, int s_len, int hd, int causal, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, s_len, hd, causal, scale, stream);
}
