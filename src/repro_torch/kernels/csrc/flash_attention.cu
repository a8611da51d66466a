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
//   weight 0); tiles past the block's last query are skipped.
//   Shared memory: (BQ dh + 64 dh + 64 * 64 NCG + BQ * 68) floats.
//
// flash_decode — replaces repro/kernels/flash_attention.py:flash_decode
//   (Pallas body _flash_decode_kernel), reached through ops.flash_decode.
//   q (B, H, dh), k (B, S, H, dh), v (B, S, H, dv), lens (B,) -> (B, H, dv);
//   key s of batch row b is valid iff s < clamp(lens[b], 0, S).
//   Bound: bytes, the valid prefix of K and V (len * (dh + dv) * itemsize
//   per (b, h)); two flops per element read.
//   Design: one block per (b, h), eight warps; warp w takes keys w, w + 8,
//   ... in order, four keys in flight (K and V rows loaded before use), each
//   lane holding head-dim elements lane + 32j of q, k, v and its acc. A key's
//   score is a warp sum; each warp keeps its own online (m, l, acc), and the
//   eight are combined through shared memory at the end. No split over S
//   across blocks yet.

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
                            const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
                            int dh, int dv, float scale, int causal) {
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
                               int BH, int Sq, int Skv, int dh, int dv, float scale,
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
                                           Sq, Skv, dh, dv, scale, causal);
  return cudaGetLastError();
}

// 128-query tiles where two blocks fit an SM's 228 KB and the accumulator
// stays at 64 registers, else 64
constexpr size_t kTwoBlocks = 113 * 1024;

template <typename T>
cudaError_t launch_attention_dv(const void* q, const void* k, const void* v, void* out,
                                int BH, int Sq, int Skv, int dh, int dv, float scale,
                                int causal, bool vec, cudaStream_t s) {
  const int ncg = (dv + 63) / 64;
#define LAUNCH(RM, NCG) \
  launch_attention_t<T, RM, NCG>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, vec, s)
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
// flash_decode
// --------------------------------------------------------------------------
constexpr int kDecodeWarps = 8;
constexpr int kDecodeUnroll = 4;  // keys in flight per warp

template <typename T, int NJ>
__global__ void __launch_bounds__(kDecodeWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    T* __restrict__ out, int H, int S, int dh, int dv, float scale) {
  __shared__ float m_s[kDecodeWarps], l_s[kDecodeWarps];
  __shared__ float acc_s[kDecodeWarps][kMaxHeadDim];
  const size_t bh = blockIdx.x;
  const size_t b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lens[b], 0), S);
  // key s of this (b, h) sits at kb + s * ks: keys are H heads apart
  const size_t ks = static_cast<size_t>(H) * dh, vs = static_cast<size_t>(H) * dv;
  const T* kb = k + (b * S * H + h) * dh;
  const T* vb = v + (b * S * H + h) * dv;

  float qr[NJ], acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < dh ? to_f(q[bh * dh + d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (int base = 0; base < len; base += kDecodeWarps * kDecodeUnroll) {
    // all loads first, in the keys' type; converted when used
    T kr[kDecodeUnroll][NJ], vr[kDecodeUnroll][NJ];
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const size_t s = base + u * kDecodeWarps + warp;
      const bool ok = s < static_cast<size_t>(len);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        kr[u][j] = ok && d < dh ? kb[s * ks + d] : zero<T>();
        vr[u][j] = ok && d < dv ? vb[s * vs + d] : zero<T>();
      }
    }
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      if (base + u * kDecodeWarps + warp >= len) break;  // warp-uniform
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) dot = fmaf(qr[j], to_f(kr[u][j]), dot);
      const float sc = warp_sum(dot) * scale;
      const float m_new = fmaxf(m, sc);
      const float p = expf(sc - m_new);
      const float corr = expf(m - m_new);
      l = l * corr + p;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] = acc[j] * corr + p * to_f(vr[u][j]);
      m = m_new;
    }
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    if (d < dv) acc_s[warp][d] = acc[j];
  }
  __syncthreads();
  float mt = kNegInf;
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) mt = fmaxf(mt, m_s[w]);
  for (int d = threadIdx.x; d < dv; d += blockDim.x) {
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = expf(m_s[w] - mt);  // a warp with no key has l = acc = 0
      lt += l_s[w] * c;
      at += acc_s[w][d] * c;
    }
    store(out + bh * dv + d, at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int NJ>
cudaError_t launch_decode_t(const void* q, const void* k, const void* v, const int* lens,
                            void* out, int B, int H, int S, int dh, int dv, float scale,
                            cudaStream_t stream) {
  flash_decode_kernel<T, NJ><<<B * H, kDecodeWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      static_cast<T*>(out), H, S, dh, dv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_nj(const void* q, const void* k, const void* v, const int* lens,
                             void* out, int B, int H, int S, int dh, int dv, float scale,
                             cudaStream_t s) {
  const int width = dh > dv ? dh : dv;
  if (width <= 32) return launch_decode_t<T, 1>(q, k, v, lens, out, B, H, S, dh, dv, scale, s);
  if (width <= 64) return launch_decode_t<T, 2>(q, k, v, lens, out, B, H, S, dh, dv, scale, s);
  if (width <= 128) return launch_decode_t<T, 4>(q, k, v, lens, out, B, H, S, dh, dv, scale, s);
  return launch_decode_t<T, 8>(q, k, v, lens, out, B, H, S, dh, dv, scale, s);
}

}  // namespace

extern "C" {

// q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv), out (BH, Sq, dv), all of
// dtype; dh, dv <= 256. Rows are read four elements at a time when dh and dv
// are multiples of 4 and the bases 16-byte aligned. Returns the launch's
// cudaGetLastError() (or the shared-memory opt-in's error).
int flash_attention_simt_launch(const void* q, const void* k, const void* v, void* out,
                                int dtype, int BH, int Sq, int Skv, int dh, int dv,
                                float scale, int causal, void* stream) {
  if (BH == 0 || Sq == 0 || dv == 0) return 0;
  if (dh > kMaxHeadDim || dv > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = dh % 4 == 0 && dv % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_attention_dv<float>(q, k, v, out, BH, Sq, Skv, dh, dv,
                                                         scale, causal, vec, s));
    case kBF16:
      return static_cast<int>(launch_attention_dv<__nv_bfloat16>(q, k, v, out, BH, Sq, Skv,
                                                                 dh, dv, scale, causal, vec, s));
    case kF16:
      return static_cast<int>(launch_attention_dv<__half>(q, k, v, out, BH, Sq, Skv, dh, dv,
                                                          scale, causal, vec, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B, H, dh), k (B, S, H, dh), v (B, S, H, dv), out (B, H, dv), all of
// dtype; lens (B,) i32, clamped to [0, S]; dh, dv <= 256.
int flash_decode_launch(const void* q, const void* k, const void* v, const int* lens,
                        void* out, int dtype, int B, int H, int S, int dh, int dv,
                        float scale, void* stream) {
  if (B == 0 || H == 0 || dv == 0) return 0;
  if (dh > kMaxHeadDim || dv > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(
          launch_decode_nj<float>(q, k, v, lens, out, B, H, S, dh, dv, scale, s));
    case kBF16:
      return static_cast<int>(
          launch_decode_nj<__nv_bfloat16>(q, k, v, lens, out, B, H, S, dh, dv, scale, s));
    case kF16:
      return static_cast<int>(
          launch_decode_nj<__half>(q, k, v, lens, out, B, H, S, dh, dv, scale, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
