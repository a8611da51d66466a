// Hopper (sm_90a) attention kernels, with a plain C interface for ctypes
// (see repro_torch/kernels/_build.py and flash_attention.py).
//
// Both compute the Pallas kernels' function: masked scores are the finite
// -1e30, so exp(m_prev - m_new) is never NaN, and the output is
// acc / max(l, 1e-30), so a row with no valid key comes out 0. Inputs are
// f32, bf16 or f16 (one type for q, k and v), accumulation is f32, the
// output is in the inputs' type. Index arithmetic is size_t throughout.
//
// flash_attention (SIMT route) — replaces repro/kernels/flash_attention.py:
//   flash_attention (Pallas body _flash_fwd_kernel), reached through
//   ops.flash_attention for f32 and for the 16-bit shapes the tensor-core
//   route (flash_attention_wgmma.cu) does not take (a head dim that is no
//   multiple of 8). q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv) ->
//   (BH, Sq, dv). Key j is valid for query i iff j < Skv and, when causal,
//   j <= i + Skv - Sq (queries sit at the end of the KV window: bottom-right
//   alignment).
//   Bound: operations, 2 * (dh + dv) per valid (query, key) pair, at the
//   card's f32 rate outside the tensor cores for f32 (no TF32: the f32
//   checks hold it to 2e-5).
//   Design: register-blocked f32 SIMT. One block per (bh, BQ-query tile),
//   BQ = 128 where two blocks still fit an SM's shared memory, else 64; 256
//   threads as 16 x 16. Thread (ty, tx) owns the RM = BQ / 16 query rows
//   ty * RM + a and the keys tx * 4 + b of each 64-key tile (an RM x 4 score
//   micro-tile), and the value columns 64 c + tx * 4 + e. Q is staged once
//   and each K tile per step, both transposed (head dim major), so a thread
//   reads its rows and its keys as float4 broadcasts: RM / 4 + 1 16-byte
//   loads per 4 RM FMAs. P goes through shared memory row-major and V is
//   read as float4, RM + 4 NCG loads per 16 RM NCG FMAs of O += P V. The
//   online (m, l) follow the Pallas kernel (expf, masked scores -1e30, their
//   weight 0); tiles past the block's last query are skipped. Given an lse
//   pointer (the autograd forward, flash_attention.py), the block also
//   writes each row's f32 log-sum-exp m + log(max(l, 1e-30)) for the
//   backward; the inference forward passes null and writes nothing more.
//   Shared memory: (BQ dh + 64 dh + 64 * 64 NCG + BQ * 68) floats.
//
// flash_decode — replaces repro/kernels/flash_attention.py:flash_decode
//   (Pallas body _flash_decode_kernel), reached through ops.flash_decode.
//   q (B, H, dh), k (B, S, Hkv, dh), v (B, S, Hkv, dv), lens (B,) ->
//   (B, H, dv), H a multiple of Hkv: query head h reads kv head
//   h / (H / Hkv), repeat_kv's order, from the grouped cache as it lies (no
//   repeat is made); key s of batch row b is valid iff
//   s < clamp(lens[b], 0, S).
//   Bound: bytes, the valid prefix of K and V read once (len * Hkv *
//   (dh + dv) * itemsize per b); two flops per element read. Each kv head
//   is read by the H / Hkv blocks of its query heads, which sit next to each
//   other on the grid's x axis, so the later reads mostly come from L2.
//   Design: split-KV ("flash-decoding"). The grid is (B*H, n_split): B*H on
//   x, whose limit is 2^31 - 1, the splits on y. The wrapper picks the
//   chunk of keys per block from S and B*H alone (flash_attention.
//   decode_split: 1024 keys, halved down to 64 until the grid has ~1024
//   blocks), never from the lengths, which stay on the card. A block whose
//   chunk starts at or past its row's length returns at once. In a block,
//   groups of G lanes take one key each: on the vector path (rows of dh and
//   dv a multiple of 16 bytes, k and v 16-byte aligned) each lane loads
//   16-byte pieces, so a bf16 row of 128 is one half-warp load; any other
//   head width loads one element a lane over a whole warp. Each group keeps
//   four keys' K and V rows in flight: plain unrolled loads, issued before
//   any is used (a cp.async ring would add shared-memory traffic and
//   barriers for no more bytes in flight). At ~64 registers a thread eight
//   blocks of 128 threads fit an SM: 8 x 8 groups x 4 keys x 512 B = 128 KB
//   in flight for bf16 heads of 128, several times the ~25 KB that HBM's
//   latency needs. A group reduces each score over its G lanes and keeps
//   its own online (m, l, acc), rescaled once per four keys. The block
//   merges its groups in shared memory and writes the split's (m, l,
//   acc[dv]) in f32 to a workspace; a second kernel, one block per (b, h),
//   rescales the live splits' partials by exp(m_i - max m) and divides by
//   max(l, 1e-30).

#include <cstring>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value
constexpr int kMaxHeadDim = 256;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// reductions over the 16 lanes of a half-warp (one query row of the tile)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// --------------------------------------------------------------------------
// flash_attention, SIMT route
// --------------------------------------------------------------------------
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdp = kBK + 4;  // P row (float4-aligned)

size_t attention_smem(int bq, int dh, int ncg) {
  return static_cast<size_t>(bq * dh + kBK * dh + kBK * 64 * ncg + bq * kLdp) * sizeof(float);
}

// four consecutive elements of a row from d on, as f32 (zeros past `n`);
// VEC: one 16- or 8-byte load, the caller guarantees alignment and n % 4 == 0
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* p, int d, int n, float (&x)[4]) {
  if (VEC) {
    if (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + d);
      x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p + d);
      const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = to_f(h[e]);
    }
  } else {
    T raw[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) raw[e] = d + e < n ? p[d + e] : zero<T>();
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = to_f(raw[e]);
  }
}

// rows [row0, row0 + rows) of a (n_rows, D) matrix, transposed into
// dst[d * rows + r] (zeros past n_rows); consecutive threads take
// consecutive rows, so the stores are conflict-free
template <typename T, bool VEC>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int row0, int rows, int n_rows,
                                        int D) {
  const int d4 = (D + 3) / 4;
  for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
    const int r = i % rows, d = (i / rows) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) load4<T, VEC>(src + static_cast<size_t>(row0 + r) * D, d, D, x);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < D) dst[(d + e) * rows + r] = x[e];
  }
}

template <typename T, int RM, int NCG, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            float* __restrict__ lse, int Sq, int Skv, int dh, int dv, float scale,
                            int causal) {
  constexpr int BQ = 16 * RM, VW = 64 * NCG;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // dh x BQ
  float* kt = qt + BQ * dh;                      // dh x kBK
  float* vs = kt + kBK * dh;                     // kBK x VW
  float* ps = vs + kBK * VW;                     // BQ x kLdp
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int offset = Skv - Sq;
  const T* kg = k + bh * Skv * dh;
  const T* vg = v + bh * Skv * dv;

  stage_t<T, VEC>(qt, q + bh * Sq * dh, q0, BQ, Sq, dh);
  float m[RM], l[RM], acc[RM][NCG][4];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;
  }

  // keys past the tile's last query (q0 + BQ - 1 + offset) are masked for
  // every row of the tile
  const int k_end = causal ? min(Skv, q0 + BQ + offset) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q staged; the previous tile's K, V, P consumed
    stage_t<T, VEC>(kt, kg, k0, kBK, Skv, dh);
    for (int i = tid; i < kBK * (VW / 4); i += kThreads) {
      const int r = i / (VW / 4), c = (i - r * (VW / 4)) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < Skv && c < dv) load4<T, VEC>(vg + static_cast<size_t>(k0 + r) * dv, c, dv, x);
      *reinterpret_cast<float4*>(vs + r * VW + c) = make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    float s[RM][4];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dh; ++d) {
      const float4 kb = *reinterpret_cast<const float4*>(kt + d * kBK + tx * 4);
      float qa[RM];
#pragma unroll
      for (int a4 = 0; a4 < RM / 4; ++a4) {
        const float4 f = *reinterpret_cast<const float4*>(qt + d * BQ + ty * RM + a4 * 4);
        qa[a4 * 4] = f.x; qa[a4 * 4 + 1] = f.y; qa[a4 * 4 + 2] = f.z; qa[a4 * 4 + 3] = f.w;
      }
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        s[a][0] = fmaf(qa[a], kb.x, s[a][0]);
        s[a][1] = fmaf(qa[a], kb.y, s[a][1]);
        s[a][2] = fmaf(qa[a], kb.z, s[a][2]);
        s[a][3] = fmaf(qa[a], kb.w, s[a][3]);
      }
    }

    const bool full = k0 + kBK <= Skv && (!causal || k0 + kBK - 1 <= q0 + offset);
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int qpos = q0 + ty * RM + a + offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kpos = k0 + tx * 4 + b;
        ok[b] = full || (kpos < Skv && (!causal || kpos <= qpos));
        s[a][b] = ok[b] ? s[a][b] * scale : kNegInf;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], half_max(mx));
      const float corr = expf(m[a] - m_new);
      float p[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) p[b] = ok[b] ? expf(s[a][b] - m_new) : 0.f;
      *reinterpret_cast<float4*>(ps + (ty * RM + a) * kLdp + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
      l[a] = l[a] * corr + ((p[0] + p[1]) + (p[2] + p[3]));  // this thread's keys
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NCG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][c][e] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[RM];
#pragma unroll
      for (int a = 0; a < RM; ++a)
        pa[a] = *reinterpret_cast<const float4*>(ps + (ty * RM + a) * kLdp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NCG; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (j + jj) * VW + c * 64 + tx * 4);
#pragma unroll
          for (int a = 0; a < RM; ++a) {
            const float pj = jj == 0 ? pa[a].x : jj == 1 ? pa[a].y : jj == 2 ? pa[a].z : pa[a].w;
            acc[a][c][0] = fmaf(pj, vv.x, acc[a][c][0]);
            acc[a][c][1] = fmaf(pj, vv.y, acc[a][c][1]);
            acc[a][c][2] = fmaf(pj, vv.z, acc[a][c][2]);
            acc[a][c][3] = fmaf(pj, vv.w, acc[a][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const float den = fmaxf(half_sum(l[a]), 1e-30f);
    const int row = q0 + ty * RM + a;
    if (row >= Sq) continue;
    if (lse && tx == 0) lse[bh * Sq + row] = m[a] + logf(den);
    T* o = out + (bh * Sq + row) * dv;
#pragma unroll
    for (int c = 0; c < NCG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 64 + tx * 4 + e;
        if (col < dv) store(o + col, acc[a][c][e] / den);
      }
  }
}

template <typename T, int RM, int NCG>
cudaError_t launch_attention_t(const void* q, const void* k, const void* v, void* out,
                               float* lse, int BH, int Sq, int Skv, int dh, int dv, float scale,
                               int causal, bool vec, cudaStream_t stream) {
  const size_t smem = attention_smem(16 * RM, dh, NCG);
  auto kernel = vec ? flash_attention_simt_kernel<T, RM, NCG, true>
                    : flash_attention_simt_kernel<T, RM, NCG, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(BH, (Sq + 16 * RM - 1) / (16 * RM));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q),
                                           static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out),
                                           lse, Sq, Skv, dh, dv, scale, causal);
  return cudaGetLastError();
}

// 128-query tiles where two blocks fit an SM's 228 KB and the accumulator
// stays at 64 registers, else 64
constexpr size_t kTwoBlocks = 113 * 1024;

template <typename T>
cudaError_t launch_attention_dv(const void* q, const void* k, const void* v, void* out,
                                float* lse, int BH, int Sq, int Skv, int dh, int dv, float scale,
                                int causal, bool vec, cudaStream_t s) {
  const int ncg = (dv + 63) / 64;
#define LAUNCH(RM, NCG) \
  launch_attention_t<T, RM, NCG>(q, k, v, out, lse, BH, Sq, Skv, dh, dv, scale, causal, vec, s)
  if (ncg <= 2 && attention_smem(128, dh, ncg) <= kTwoBlocks)
    return ncg == 1 ? LAUNCH(8, 1) : LAUNCH(8, 2);
  switch (ncg) {
    case 1: return LAUNCH(4, 1);
    case 2: return LAUNCH(4, 2);
    case 3: return LAUNCH(4, 3);
    default: return LAUNCH(4, 4);
  }
#undef LAUNCH
}

// --------------------------------------------------------------------------
// flash_decode: a split-KV pass, then a combine
// --------------------------------------------------------------------------
constexpr int kDecodeWarps = 4;
constexpr int kDecodeUnroll = 4;  // keys in flight per lane group
constexpr int kCombineThreads = 128;
constexpr int kMaxSplits = 4096;  // the combine keeps a weight per split in shared memory

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;  // (B,)
  void* out;
  float* part_acc;  // (B*H, n_split, dv) f32
  float* part_ml;   // (B*H, n_split, 2) f32: the split's (m, l)
  int H, Hkv, S, dh, dv, chunk, n_split;
  float scale;
};

__device__ __forceinline__ int decode_len(const DecodeArgs& a, size_t b) {
  return min(max(a.lens[b], 0), a.S);
}

// What a lane loads of a key row at a time: 16 bytes (PER elements) on the
// vector path, one element on the scalar path.
template <typename T, bool VEC>
struct Piece {
  using type = uint4;
  static constexpr int per = 16 / sizeof(T);
};
template <typename T>
struct Piece<T, false> {
  using type = T;
  static constexpr int per = 1;
};

template <typename C>
__device__ __forceinline__ C zero_piece() { return zero<C>(); }
template <>
__device__ __forceinline__ uint4 zero_piece<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  T e[16 / sizeof(T)];
  memcpy(e, &u, sizeof(u));
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) f[j] = to_f(e[j]);
}
template <typename T>
__device__ __forceinline__ void unpack(const T& x, float* f) { f[0] = to_f(x); }

// sum over the G lanes of an aligned lane group
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block (bh, split) takes keys [split * chunk, min((split + 1) * chunk, len))
// of row bh. Each group of G lanes takes one key at a time, kDecodeUnroll
// keys in flight, and keeps its own online (m, l, acc); the block combines
// its groups through shared memory and writes the split's partial. A split
// at or past the row's length returns before it loads anything, and the
// combine never reads it.
template <typename T, bool VEC, int G, int N>
__global__ void __launch_bounds__(kDecodeWarps * 32)
flash_decode_split_kernel(const DecodeArgs a) {
  using C = typename Piece<T, VEC>::type;
  constexpr int PER = Piece<T, VEC>::per;
  constexpr int GROUPS = kDecodeWarps * 32 / G;
  constexpr int WIDTH = G * N * PER;  // the widest head this instance takes
  __shared__ float m_s[GROUPS], l_s[GROUPS];
  __shared__ float acc_s[GROUPS][WIDTH];

  const size_t bh = blockIdx.x;
  const int split = blockIdx.y;
  const size_t b = bh / a.H, h = bh - b * a.H;
  const size_t kvh = h / (a.H / a.Hkv);  // repeat_kv's order
  const int len = decode_len(a, b);
  const int start = split * a.chunk;
  if (start >= len) return;
  const int end = min(start + a.chunk, len);
  const int group = threadIdx.x / G, g = threadIdx.x % G;
  const int dh = a.dh, dv = a.dv;
  const int kpieces = dh / PER, vpieces = dv / PER;
  // key s of this (b, kvh) starts s * ks elements past kb: keys are Hkv
  // heads apart
  const size_t ks = static_cast<size_t>(a.Hkv) * dh, vs = static_cast<size_t>(a.Hkv) * dv;
  const T* kb = static_cast<const T*>(a.k) + (b * a.S * a.Hkv + kvh) * dh;
  const T* vb = static_cast<const T*>(a.v) + (b * a.S * a.Hkv + kvh) * dv;
  const T* q = static_cast<const T*>(a.q) + bh * dh;

  // piece n of lane g holds elements (g + G n) * PER + j of q, k, v and acc
  float qf[N][PER], acc[N][PER];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int d = (g + G * n) * PER + j;
      qf[n][j] = d < dh ? to_f(q[d]) : 0.f;
      acc[n][j] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;
  for (int base = start; base < end; base += GROUPS * kDecodeUnroll) {
    // all loads first, raw; converted when used
    C kr[kDecodeUnroll][N], vr[kDecodeUnroll][N];
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const int s = base + u * GROUPS + group;
      const bool ok = s < end;
      const C* kp = reinterpret_cast<const C*>(kb + static_cast<size_t>(s) * ks);
      const C* vp = reinterpret_cast<const C*>(vb + static_cast<size_t>(s) * vs);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int c = g + G * n;
        kr[u][n] = ok && c < kpieces ? __ldg(kp + c) : zero_piece<C>();
        vr[u][n] = ok && c < vpieces ? __ldg(vp + c) : zero_piece<C>();
      }
    }
    // scores of the group's keys (masked -1e30), then one rescale for all
    float sc[kDecodeUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float kf[PER];
        unpack<T>(kr[u][n], kf);
#pragma unroll
        for (int j = 0; j < PER; ++j) dot = fmaf(qf[n][j], kf[j], dot);
      }
      dot = group_sum<G>(dot) * a.scale;
      sc[u] = base + u * GROUPS + group < end ? dot : kNegInf;
      m_new = fmaxf(m_new, sc[u]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int j = 0; j < PER; ++j) acc[n][j] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      if (base + u * GROUPS + group >= end) continue;  // uniform over the group
      const float p = expf(sc[u] - m_new);
      l += p;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float vf[PER];
        unpack<T>(vr[u][n], vf);
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[n][j] = fmaf(p, vf[j], acc[n][j]);
      }
    }
    m = m_new;
  }

  if (g == 0) {
    m_s[group] = m;
    l_s[group] = l;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int d = (g + G * n) * PER + j;
      if (d < dv) acc_s[group][d] = acc[n][j];
    }
  }
  __syncthreads();
  // a group with no key has l = acc = 0 and m = -1e30: weight 0
  float mt = kNegInf;
#pragma unroll
  for (int w = 0; w < GROUPS; ++w) mt = fmaxf(mt, m_s[w]);
  const size_t part = bh * a.n_split + split;
  for (int d = threadIdx.x; d < dv; d += blockDim.x) {
    float at = 0.f;
#pragma unroll
    for (int w = 0; w < GROUPS; ++w) at = fmaf(acc_s[w][d], expf(m_s[w] - mt), at);
    a.part_acc[part * dv + d] = at;
  }
  if (threadIdx.x == 0) {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < GROUPS; ++w) lt = fmaf(l_s[w], expf(m_s[w] - mt), lt);
    a.part_ml[2 * part] = mt;
    a.part_ml[2 * part + 1] = lt;
  }
}

// max (MAX) or sum of x over the block; every thread gets the result
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red is written again by the next reduction
  return x;
}

// One block per (b, h): the live splits' partials (m_i, l_i, acc_i),
// rescaled by exp(m_i - max m) and summed, over max(l, 1e-30). A row of
// length 0 has no live split and comes out 0.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const DecodeArgs a) {
  extern __shared__ float w_s[];  // exp(m_i - max m) per live split
  __shared__ float red_s[kCombineThreads / 32];
  const size_t bh = blockIdx.x;
  const int len = decode_len(a, bh / a.H);
  const int n_live = static_cast<int>((static_cast<long long>(len) + a.chunk - 1) / a.chunk);
  const float* ml = a.part_ml + bh * a.n_split * 2;
  float mt = kNegInf;
  for (int i = threadIdx.x; i < n_live; i += blockDim.x) mt = fmaxf(mt, ml[2 * i]);
  mt = block_reduce<true>(mt, red_s);
  float lt = 0.f;
  for (int i = threadIdx.x; i < n_live; i += blockDim.x) {
    const float c = expf(ml[2 * i] - mt);
    w_s[i] = c;
    lt = fmaf(ml[2 * i + 1], c, lt);
  }
  lt = block_reduce<false>(lt, red_s);  // its barrier also publishes w_s
  const float denom = fmaxf(lt, 1e-30f);
  const float* pa = a.part_acc + bh * a.n_split * a.dv;
  T* out = static_cast<T*>(a.out) + bh * a.dv;
  for (int d = threadIdx.x; d < a.dv; d += blockDim.x) {
    float at = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_live; ++i) at = fmaf(w_s[i], pa[static_cast<size_t>(i) * a.dv + d], at);
    store(out + d, at / denom);
  }
}

template <typename T, bool VEC, int G, int N>
cudaError_t launch_decode_split(const DecodeArgs& a, int BH, cudaStream_t s) {
  flash_decode_split_kernel<T, VEC, G, N>
      <<<dim3(BH, a.n_split), kDecodeWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

// The split pass, by head width: on the vector path G lanes of 16 bytes
// cover the wider row (G = 8, 16 or 32; two pieces a lane for f32 rows past
// 128), on the scalar path a warp with N elements a lane.
template <typename T>
cudaError_t launch_decode_t(const DecodeArgs& a, int BH, bool vec, cudaStream_t s) {
  if (a.n_split > 0) {
    cudaError_t e = cudaSuccess;
    const int width = a.dh > a.dv ? a.dh : a.dv;
    if (vec) {
      const int pieces = width * static_cast<int>(sizeof(T)) / 16;
      if (pieces <= 8) e = launch_decode_split<T, true, 8, 1>(a, BH, s);
      else if (pieces <= 16) e = launch_decode_split<T, true, 16, 1>(a, BH, s);
      else if (pieces <= 32) e = launch_decode_split<T, true, 32, 1>(a, BH, s);
      else if constexpr (sizeof(T) == 4) e = launch_decode_split<T, true, 32, 2>(a, BH, s);
    } else if (width <= 32) {
      e = launch_decode_split<T, false, 32, 1>(a, BH, s);
    } else if (width <= 64) {
      e = launch_decode_split<T, false, 32, 2>(a, BH, s);
    } else if (width <= 128) {
      e = launch_decode_split<T, false, 32, 4>(a, BH, s);
    } else {
      e = launch_decode_split<T, false, 32, 8>(a, BH, s);
    }
    if (e != cudaSuccess) return e;
  }
  flash_decode_combine_kernel<T>
      <<<BH, kCombineThreads, static_cast<size_t>(a.n_split) * sizeof(float), s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv), out (BH, Sq, dv), all of
// dtype; dh, dv <= 256; lse null or (BH, Sq) f32, each row's log-sum-exp of
// scale q k^T over its valid keys (-1e30 for a row with none). Rows are
// read four elements at a time when dh and dv are multiples of 4 and the
// bases 16-byte aligned. Returns the launch's cudaGetLastError() (or the
// shared-memory opt-in's error).
int flash_attention_simt_launch(const void* q, const void* k, const void* v, void* out,
                                float* lse, int dtype, int BH, int Sq, int Skv, int dh, int dv,
                                float scale, int causal, void* stream) {
  if (BH == 0 || Sq == 0 || dv == 0) return 0;
  if (dh > kMaxHeadDim || dv > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = dh % 4 == 0 && dv % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_attention_dv<float>(q, k, v, out, lse, BH, Sq, Skv, dh,
                                                         dv, scale, causal, vec, s));
    case kBF16:
      return static_cast<int>(launch_attention_dv<__nv_bfloat16>(
          q, k, v, out, lse, BH, Sq, Skv, dh, dv, scale, causal, vec, s));
    case kF16:
      return static_cast<int>(launch_attention_dv<__half>(q, k, v, out, lse, BH, Sq, Skv, dh,
                                                          dv, scale, causal, vec, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B, H, dh), k (B, S, Hkv, dh), v (B, S, Hkv, dv), out (B, H, dv), all
// of dtype; H a multiple of Hkv; dh, dv <= 256. lens (B,) i32, clamped to
// [0, S]. work:
// B*H*n_split*(dv + 2) f32 for the splits' partials, n_split =
// ceil(S / chunk) <= 4096. Key rows load 16
// bytes at a time when dh and dv rows are multiples of 16 bytes and k, v
// are 16-byte aligned. Two launches (split pass, combine) on the stream;
// returns the first error.
int flash_decode_launch(const void* q, const void* k, const void* v, const int* lens,
                        void* out, float* work, int dtype, int B, int H, int Hkv,
                        int S, int dh, int dv, int chunk, int n_split, float scale,
                        void* stream) {
  if (B == 0 || H == 0 || dv == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || dh > kMaxHeadDim || dv > kMaxHeadDim || S < 0 ||
      chunk <= 0 || n_split > kMaxSplits ||
      n_split != static_cast<int>((static_cast<long long>(S) + chunk - 1) / chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  const DecodeArgs a{q, k, v, lens, out, work,
                     work + static_cast<size_t>(BH) * n_split * dv,
                     H, Hkv, S, dh, dv, chunk, n_split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_decode_t<float>(
          a, BH, aligned && dh % 4 == 0 && dv % 4 == 0, s));
    case kBF16:
      return static_cast<int>(launch_decode_t<__nv_bfloat16>(
          a, BH, aligned && dh % 8 == 0 && dv % 8 == 0, s));
    case kF16:
      return static_cast<int>(launch_decode_t<__half>(
          a, BH, aligned && dh % 8 == 0 && dv % 8 == 0, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
