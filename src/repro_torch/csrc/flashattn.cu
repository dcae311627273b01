// Flash attention (kernel K6): softmax attention with an online softmax,
// optionally causal, on (BH, S, hd) tensors with the heads folded into the
// leading dimension (MHA: K and V have as many heads as Q). The queries may
// be a block of rows of a longer sequence: (BH, S_q, hd) queries at
// positions q_offset .. against (BH, S_kv, hd) keys, as the sequence-parallel
// prefill gives them (S_q = S_kv, q_offset = 0 is self-attention).
//
// Replaces the Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flashattn/flashattn.py:72, body `_flash_body` at :37),
// and computes what it computes:
//   s = fp32(q) fp32(k)^T scaled by fp32(1/sqrt(hd))  (fp32; the TPU kernel
//       and the fp32 kernel scale q first, the bf16 kernel the scores)
//   causal: s = -1e30 where the key position exceeds q_offset + the query's
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
// Two kernels, one per input type (entry points below):
//
// * bf16 inputs (`flash_attention_bf16`, `flash_attention_bf16_kernel`): the
//   tensor cores. One CTA of 4 warps per (bh, 64-row query tile), 16 query
//   rows per warp. The q tile comes in once by cp.async and is held in
//   registers as mma A fragments (ldmatrix). K and V tiles of 64 keys stay in
//   bf16 in shared memory, in a ring of 3 (hd 64) or 2 (hd 128) stages fed by
//   16-byte cp.async copies (zero-filled past S), so the next tiles load
//   while this one is computed; rows are padded by 16 bytes, so ldmatrix
//   (K) and ldmatrix.trans (V) read without bank conflicts. S = q k^T runs as
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate: products of bf16 values are
//   exact, so this is the fp32 product up to summation order) and is scaled
//   afterwards, in fp32: q is never scaled in bf16. m, l and acc live in fp32
//   registers on the accumulator layout (each thread holds 2 rows, reduced
//   over its quad with shuffles); exp runs as exp2, the scale times log2(e)
//   folded into its argument by one FFMA per score.
//   Only the diagonal tile and a ragged last tile pay for the mask. p is NOT
//   rounded to bf16 for p v (that costs ~40% of the bf16 outputs one ulp):
//   it is split in registers into hi = bf16(p) and lo = bf16(p - hi), and two
//   mma.sync against the same V fragment add hi v and lo v in fp32, which
//   carries p to ~16 significant bits. That is 1.5x the plain flop count on
//   the tensor cores; the bound above stays the plain count. The output is
//   divided by l, rounded once to bf16, staged in shared memory and stored
//   with 16-byte stores; query rows past S are not stored.
//
// * fp32 inputs (`flash_attention_f32`, `flash_attention_kernel<float, HD>`):
//   the CUDA cores, in full fp32 (a tensor-core product would need TF32 or a
//   three-way bf16 split to stay inside fp32's 2e-4 check, and no served path
//   computes attention in fp32). One CTA of 256 threads per (bh, 64-row query
//   tile); the scaled q tile (here q' = fp32(q) * scale, as the TPU kernel
//   does) lives transposed in shared memory in fp32 for the CTA's life. The
//   CTA walks the key tiles of 64 rows: each is staged through shared memory
//   (k transposed, v as it is, both in fp32, rows past S zero), each thread
//   computes a 4x4 block of the 64x64 score tile with float4 shared-memory
//   loads, masks it (ragged tail: key >= S; causal: key > query), and
//   updates the online-softmax state of its 4 rows, reduced across the 16
//   threads that share a row with warp shuffles. p goes back to shared
//   memory (transposed) and each thread adds p v into its 4 rows x hd/16
//   columns of acc, which stays in registers.
//
// Both kernels are instantiated twice: for self-attention (S_kv = S_q and
// offset 0 fixed at compile time, so its code is the self-attention
// kernel's) and for queries at an offset. Both: causal CTAs stop at the key
// tile that holds their last query's diagonal (key tiles past it are fully
// masked, and skipping them is exact because the first tile always holds
// key 0, so m is finite before any masked tile), and CTAs are issued
// heaviest (last) query tile first. Only the tiles that reach past a
// query's diagonal or past S_kv pay for the mask.
//
// Left out, for later work: wgmma with TMA-fed tiles and mbarriers in
// warp-specialised producer/consumer warpgroups (FA3's shape; the split of p
// holds there too, p being the register A operand, in two halves); folding
// GQA's group into the indexing, so repeated K/V heads need not be
// materialised by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// fp32 inputs: CUDA cores.

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

// kRect: queries at an offset of a longer key sequence; without it S_kv is
// S_q and the offset 0 at compile time (the self-attention kernel).
template <typename T, int HD, bool kRect>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int bh, int s_len, int s_kv, int q_offset, int causal, float scale) {
  if constexpr (!kRect) {
    s_kv = s_len;
    q_offset = 0;
  }
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
  const long long kv_head = static_cast<long long>(b) * s_kv * HD;
  const T* qh = q + head;
  const T* kh = k + kv_head;
  const T* vh = v + kv_head;

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

  const int n_kv_tiles = (s_kv + kTile - 1) / kTile;
  const int last_key = q_offset + min(q0 + kTile, s_len) - 1;  // the tile's last query
  const int kv_tiles = !causal ? n_kv_tiles
                       : kRect ? min(last_key / kTile + 1, n_kv_tiles) : qi + 1;
  for (int t = 0; t < kv_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's reads of kt, vs and pt are done
    for (int idx = tid; idx < kTile * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const int pos = k0 + r;
      const bool in = pos < s_kv;
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
      const int qpos = q_offset + q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        if (kpos >= s_kv || (causal && kpos > qpos)) s[i][j] = kMasked;
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

template <typename T, int HD, bool kRect>
int launch_as(const void* q, const void* k, const void* v, void* out, int bh,
              int s_len, int s_kv, int q_offset, int causal, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD, kRect>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_tiles = static_cast<unsigned>((s_len + kTile - 1) / kTile);
  flash_attention_kernel<T, HD, kRect>
      <<<n_tiles * static_cast<unsigned>(bh), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), bh, s_len, s_kv, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s_len, int s_kv, int q_offset, int causal, float scale, cudaStream_t stream) {
  if (s_kv == s_len && q_offset == 0)
    return launch_as<T, HD, false>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale,
                                   stream);
  return launch_as<T, HD, true>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale, stream);
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate).

namespace bf16tc {

constexpr int kRows = 64;        // query rows per CTA: 4 warps x 16
constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int kLd = HD + 8;                // padded smem row (bf16): +16 B
  static constexpr int kStages = HD == 64 ? 3 : 2;  // K/V ring depth
  static constexpr int kTile = kKeys * kLd;         // one K or V tile (bf16)
  static constexpr int kChunks = HD / 8;            // 16-byte chunks per row
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * (static_cast<size_t>(kRows) * kLd + 2 * kStages * kTile);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

// c += a b: a 16x16 row-major (4 regs), b 16x8 column-major (2 regs), c fp32.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> hi = bf16(x, y), lo = bf16(x - hi.x, y - hi.y); the low 16 bits
// hold x, the element of the lower column.
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Copy 64 rows of a (S, HD) head, from row r0, into a padded smem tile; rows
// past S are zero-filled (their source address stays in bounds).
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int s_len, int tid) {
  using C = Cfg<HD>;
#pragma unroll
  for (int c = tid; c < kKeys * C::kChunks; c += kThreads) {
    const int r = c / C::kChunks, col = (c % C::kChunks) * 8;
    const int pos = r0 + r;
    const bool in = pos < s_len;
    const __nv_bfloat16* g = src + static_cast<long long>(in ? pos : 0) * HD + col;
    cp_async16(smem_addr(dst + r * C::kLd + col), g, in ? 16 : 0);
  }
}

// kRect as in the fp32 kernel.
template <int HD, bool kRect>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int bh, int s_len,
                            int s_kv, int q_offset, int causal, float scale_log2) {
  if constexpr (!kRect) {
    s_kv = s_len;
    q_offset = 0;
  }
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][kLd]
  __nv_bfloat16* skv = sq + kRows * C::kLd;  // stage st: K at 2 st kTile, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row group, column pair
  const int n_tiles = (s_len + kRows - 1) / kRows;
  const int b = blockIdx.x % bh;
  const int qi = n_tiles - 1 - static_cast<int>(blockIdx.x / bh);
  const int q0 = qi * kRows;
  const long long head = static_cast<long long>(b) * s_len * HD;
  const long long kv_head = static_cast<long long>(b) * s_kv * HD;
  const __nv_bfloat16* kh = k + kv_head;
  const __nv_bfloat16* vh = v + kv_head;
  const int n_kv_tiles = (s_kv + kKeys - 1) / kKeys;
  const int first_key = q_offset + q0;                          // the tile's first query
  const int last_key = q_offset + min(q0 + kRows, s_len) - 1;  // and its last
  const int kv_tiles = !causal ? n_kv_tiles
                       : kRect ? min(last_key / kKeys + 1, n_kv_tiles) : qi + 1;

  // cp.async groups: 0 = the q tile, then one per K/V tile (possibly empty).
  load_tile<HD>(sq, q + head, q0, s_len, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < kv_tiles) {
      load_tile<HD>(skv + 2 * st * C::kTile, kh, st * kKeys, s_kv, tid);
      load_tile<HD>(skv + (2 * st + 1) * C::kTile, vh, st * kKeys, s_kv, tid);
    }
    cp_async_commit();
  }

  // q as A fragments: rows 16 warp .. +15, k-steps of 16 head columns.
  cp_async_wait<C::kStages - 1>();
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = kk * 16 + (lane >> 4) * 8;
    ldsm_x4(smem_addr(sq + row * C::kLd + col), qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // rows r = 0 (row g of the warp) and r = 1 (row g + 8); m in log2 units
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  const int row0 = q_offset + q0 + warp * 16 + g;

  for (int t = 0; t < kv_tiles; ++t) {
    cp_async_wait<C::kStages - 2>();  // tile t has landed
    __syncthreads();                  // ... for every thread; tile t-1 is done with
    {
      const int nt = t + C::kStages - 1;
      if (nt < kv_tiles) {
        const int st = nt % C::kStages;
        load_tile<HD>(skv + 2 * st * C::kTile, kh, nt * kKeys, s_kv, tid);
        load_tile<HD>(skv + (2 * st + 1) * C::kTile, vh, nt * kKeys, s_kv, tid);
      }
      cp_async_commit();
    }
    const int st = t % C::kStages;
    const __nv_bfloat16* sk = skv + 2 * st * C::kTile;
    const __nv_bfloat16* sv = sk + C::kTile;

    // S = q k^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = jj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(sk + key * C::kLd + col), b0, b1, b2, b3);
        mma(s[2 * jj], qa[kk], b0, b1);
        mma(s[2 * jj + 1], qa[kk], b2, b3);
      }
    }

    // mask the tiles that reach past a query's diagonal or past S_kv (only
    // those pay for it)
    const int k0 = t * kKeys;
    if (k0 + kKeys > s_kv || (causal && (kRect ? k0 + kKeys - 1 > first_key : t == qi))) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= s_kv || (causal && key > row)) s[j][e] = kMasked;
        }
    }

    // online softmax; each row's 64 scores lie on the 4 threads of a quad.
    // The scale goes into the exponent, in fp32 (log2 units, scale > 0):
    // p = exp2(s * scale log2(e) - m), one FFMA per score.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float corr = ex2(m[r] - m_new);
      m[r] = m_new;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * r] = ex2(fmaf(s[j][2 * r], scale_log2, -m_new));
        s[j][2 * r + 1] = ex2(fmaf(s[j][2 * r + 1], scale_log2, -m_new));
        psum += s[j][2 * r] + s[j][2 * r + 1];
      }
      // l is this thread's share of the row sum; the quad's shares add up to
      // the row's l at the end (they share m, so they share every correction)
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }

    // acc += p v with p = hi + lo (two bf16 halves), 16 keys per k-step: the
    // score accumulators of n-tiles 2 kk, 2 kk + 1 are p's A fragment.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int jd = 0; jd < HD / 16; ++jd) {
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = jd * 16 + (lane >> 4) * 8;
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(sv + key * C::kLd + col), b0, b1, b2, b3);
        mma(acc[2 * jd], ph, b0, b1);
        mma(acc[2 * jd], pl, b0, b1);
        mma(acc[2 * jd + 1], ph, b2, b3);
        mma(acc[2 * jd + 1], pl, b2, b3);
      }
    }
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30) in bf16, through this warp's own rows of the q
  // tile (read only by this warp, long ago), then 16-byte stores.
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    denom[r] = fmaxf(lr, 1e-30f);
  }
  __nv_bfloat16* so = sq + warp * 16 * C::kLd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(so + g * C::kLd + col) =
        __floats2bfloat162_rn(acc[j][0] / denom[0], acc[j][1] / denom[0]);
    *reinterpret_cast<__nv_bfloat162*>(so + (g + 8) * C::kLd + col) =
        __floats2bfloat162_rn(acc[j][2] / denom[1], acc[j][3] / denom[1]);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * C::kChunks; c += 32) {
    const int r = c / C::kChunks, col = (c % C::kChunks) * 8;
    const int pos = q0 + warp * 16 + r;
    if (pos < s_len)
      *reinterpret_cast<uint4*>(out + head + static_cast<long long>(pos) * HD + col) =
          *reinterpret_cast<const uint4*>(so + r * C::kLd + col);
  }
}

template <int HD, bool kRect>
int launch_as(const void* q, const void* k, const void* v, void* out, int bh, int s_len,
              int s_kv, int q_offset, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<HD, kRect>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned n_tiles = static_cast<unsigned>((s_len + kRows - 1) / kRows);
  flash_attention_bf16_kernel<HD, kRect><<<n_tiles * static_cast<unsigned>(bh), kThreads,
                                           smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), bh, s_len,
      s_kv, q_offset, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s_len,
           int s_kv, int q_offset, int causal, float scale, cudaStream_t stream) {
  if (s_kv == s_len && q_offset == 0)
    return launch_as<HD, false>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale, stream);
  return launch_as<HD, true>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale, stream);
}

}  // namespace bf16tc

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int s_len,
             int s_kv, int q_offset, int hd, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<T, 64>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale, st);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out, int bh, int s_len,
                  int s_kv, int q_offset, int hd, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return bf16tc::launch<64>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale, st);
  if (hd == 128)
    return bf16tc::launch<128>(q, k, v, out, bh, s_len, s_kv, q_offset, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// s_len: query rows (S_q); s_kv: keys; q_offset: the first query's position
// among the keys.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int bh, int s_len, int s_kv, int q_offset, int hd,
                                   int causal, float scale, void* stream) {
  return dispatch<float>(q, k, v, out, bh, s_len, s_kv, q_offset, hd, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int bh, int s_len, int s_kv, int q_offset, int hd,
                                    int causal, float scale, void* stream) {
  return dispatch_bf16(q, k, v, out, bh, s_len, s_kv, q_offset, hd, causal, scale, stream);
}
