// Hopper (sm_90a) attention kernels, with a plain C interface for ctypes
// (see repro_torch/kernels/_build.py and flash_attention.py).
//
// Both compute the Pallas kernels' function: masked scores are the finite
// -1e30, so exp(m_prev - m_new) is never NaN, and the output is
// acc / max(l, 1e-30), so a row with no valid key comes out 0. Inputs are
// f32, bf16 or f16 (one type for q, k and v), accumulation is f32, the
// output is in the inputs' type. Index arithmetic is size_t throughout.
//
// flash_attention — replaces repro/kernels/flash_attention.py:flash_attention
//   (Pallas body _flash_fwd_kernel), reached through ops.flash_attention.
//   q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv) -> (BH, Sq, dv). Key j
//   is valid for query i iff j < Skv and, when causal, j <= i + Skv - Sq
//   (queries sit at the end of the KV window: bottom-right alignment).
//   Bound: operations, 2 * (dh + dv) per valid (query, key) pair; at the
//   prefill widths that is far above the bytes of q, k, v and the output.
//   Design: one block per (bh, 64-query tile), 256 threads as 16 x 16; thread
//   (ty, tx) owns query rows ty + 16a and key columns tx + 16b (a, b < 4) of
//   the 64 x 64 score tile, and value columns tx + 16c of the output. The Q
//   tile is staged once in shared memory as f32; each 64-key K and V tile is
//   staged, the scores are computed from shared memory (rows padded by one
//   float against bank conflicts), the online (m, l) are updated with row
//   reductions over the 16 lanes of a half-warp, P goes through shared
//   memory, and acc += P V accumulates in registers. Causal tiles past the
//   tile's last query are skipped. f32 SIMT arithmetic: no tensor cores yet.
//   Shared memory is (64 (dh + 1) * 2 + 64 dv + 64 * 65) floats, 115 KB at
//   dh = dv = 128 and 213 KB at 256, so the launch opts in above 48 KB.
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
// flash_attention
// --------------------------------------------------------------------------
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdp = kBK + 1;  // padded P row

size_t attention_smem(int dh, int dv) {
  return static_cast<size_t>(kBQ * (dh + 1) + kBK * (dh + 1) + kBK * dv + kBQ * kLdp) *
         sizeof(float);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
                       int dh, int dv, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldq = dh + 1;
  float* q_s = smem;               // kBQ x ldq
  float* k_s = q_s + kBQ * ldq;    // kBK x ldq
  float* v_s = k_s + kBK * ldq;    // kBK x dv
  float* p_s = v_s + kBK * dv;     // kBQ x kLdp
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int offset = Skv - Sq;
  const T* qg = q + bh * Sq * dh;
  const T* kg = k + bh * Skv * dh;
  const T* vg = v + bh * Skv * dv;

  for (int i = tid; i < kBQ * dh; i += kThreads) {
    const int r = i / dh, c = i - r * dh;
    const T x = q0 + r < Sq ? qg[static_cast<size_t>(q0 + r) * dh + c] : zero<T>();
    q_s[r * ldq + c] = to_f(x);
  }
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }

  // keys past the tile's last query (q0 + kBQ - 1 + offset) are masked for
  // every row of the tile
  const int k_end = causal ? min(Skv, q0 + kBQ + offset) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // Q staged; the previous tile's K, V, P consumed
    for (int i = tid; i < kBK * dh; i += kThreads) {
      const int r = i / dh, c = i - r * dh;
      const T x = k0 + r < Skv ? kg[static_cast<size_t>(k0 + r) * dh + c] : zero<T>();
      k_s[r * ldq + c] = to_f(x);
    }
    for (int i = tid; i < kBK * dv; i += kThreads) {
      const int r = i / dv, c = i - r * dv;
      const T x = k0 + r < Skv ? vg[static_cast<size_t>(k0 + r) * dv + c] : zero<T>();
      v_s[r * dv + c] = to_f(x);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = q_s[(ty + 16 * a) * ldq + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = k_s[(tx + 16 * b) * ldq + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty + 16 * a + offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kpos = k0 + tx + 16 * b;
        ok[b] = kpos < Skv && (!causal || kpos <= qpos);
        s[a][b] = ok[b] ? s[a][b] * scale : kNegInf;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], half_max(mx));
      const float corr = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = ok[b] ? expf(s[a][b] - m_new) : 0.f;
        rs += p;
        p_s[(ty + 16 * a) * kLdp + tx + 16 * b] = p;
      }
      l[a] = l[a] * corr + half_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_s[(ty + 16 * a) * kLdp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < dv ? v_s[j * dv + col] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    const float den = fmaxf(l[a], 1e-30f);
    T* o = out + (bh * Sq + row) * dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) store(o + col, acc[a][c] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_attention_t(const void* q, const void* k, const void* v, void* out,
                               int BH, int Sq, int Skv, int dh, int dv, float scale,
                               int causal, cudaStream_t stream) {
  const size_t smem = attention_smem(dh, dv);
  auto kernel = flash_attention_kernel<T, NC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(BH, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q),
                                           static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out),
                                           Sq, Skv, dh, dv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attention_dv(const void* q, const void* k, const void* v, void* out,
                                int BH, int Sq, int Skv, int dh, int dv, float scale,
                                int causal, cudaStream_t s) {
  if (dv <= 16) return launch_attention_t<T, 1>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, s);
  if (dv <= 32) return launch_attention_t<T, 2>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, s);
  if (dv <= 64) return launch_attention_t<T, 4>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, s);
  if (dv <= 128) return launch_attention_t<T, 8>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, s);
  return launch_attention_t<T, 16>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, s);
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
// dtype; dh, dv <= 256. Returns the launch's cudaGetLastError() (or the
// shared-memory opt-in's error).
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int dtype,
                           int BH, int Sq, int Skv, int dh, int dv, float scale, int causal,
                           void* stream) {
  if (BH == 0 || Sq == 0 || dv == 0) return 0;
  if (dh > kMaxHeadDim || dv > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(
          launch_attention_dv<float>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, s));
    case kBF16:
      return static_cast<int>(launch_attention_dv<__nv_bfloat16>(q, k, v, out, BH, Sq, Skv,
                                                                 dh, dv, scale, causal, s));
    case kF16:
      return static_cast<int>(
          launch_attention_dv<__half>(q, k, v, out, BH, Sq, Skv, dh, dv, scale, causal, s));
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
