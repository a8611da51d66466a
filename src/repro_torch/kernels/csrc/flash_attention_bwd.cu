// Hopper (sm_90a) attention backward, with a plain C interface for ctypes
// (see repro_torch/kernels/_build.py and flash_attention.py).
//
// flash_attention_bwd — replaces no TPU kernel: JAX differentiates its jnp
//   scan (repro/models/layers.py: blockwise_attention) with jax.grad and has
//   no Pallas backward. It is the gradient of flash_attention (forward in
//   flash_attention.cu / flash_attention_wgmma.cu), reached through the
//   autograd Function of flash_attention.py on a CUDA tensor.
//   q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv), the forward's out
//   (BH, Sq, dv) and its cotangent dout -> dq, dk, dv in the inputs' type
//   (f32, bf16 or f16; accumulation f32). Key j is valid for query i iff
//   j < Skv and, when causal, j <= i + Skv - Sq (bottom-right alignment), as
//   in the forward. With S = scale * q k^T over the valid pairs,
//   P = softmax(S) (0 off the valid pairs), Delta_i = sum_c dout_ic out_ic:
//     dv = P^T dout,  dP = dout v^T,  dS = P o (dP - Delta),
//     dq = scale * dS k,  dk = scale * dS^T q.
//   A query row with no valid key has P = 0, so its dq is 0 and it adds
//   nothing to dk and dv (the forward gives such a row 0).
//   Bound: operations, five products of 2 * d flops per valid (query, key)
//   pair (S, dP, dV, dK, dQ), at the card's f32 rate outside the tensor
//   cores (this route is SIMT; bf16 and f16 are converted to f32 on load).
//   Design: three launches, no float atomics, so a gradient is bit-equal
//   from run to run; the forward kernels are left as they are:
//   (a) row pass, one block per (bh, BQ-query tile): recomputes each query's
//       log-sum-exp from q k^T over the KV tiles (online max and sum, as the
//       forward does; the forward does not write it) and Delta = rowsum(
//       dout o out); writes both in f32 to a workspace;
//   (b) one block per (bh, BK-key tile): stages its K and V rows once, walks
//       the query tiles that can see them (from the first query whose window
//       reaches the tile when causal), recomputes the S and dP tiles,
//       writes P and dS to shared memory, and accumulates dK and dV in
//       registers;
//   (c) one block per (bh, BQ-query tile): stages its Q and dout rows once,
//       walks the KV tiles up to its last valid key, recomputes S and dP,
//       and accumulates dQ in registers.
//   256 threads as 16 x 16. In a (query, key) tile thread (ty, tx) holds the
//   RQ x RK scores of queries ty + 16 a and keys tx + 16 b: rows are staged
//   row-major in f32 with a row stride of an odd number of float4s, so the
//   16 threads of a row phase read 16 different keys' float4s without a bank
//   conflict, and a query row's 16 threads share a half-warp (its max and
//   sum are half-warp shuffles). In the accumulation a thread owns rows
//   ty + 16 a and the head columns 64 c + 4 tx + e (c < NC, the head width
//   in 64-column groups), and reads one P / dS value a row and one float4 of
//   q, dout or k per column group.
//   Tiles: BQ = BK = 64 (RQ = RK = 4) for heads up to 128, 32 (RQ = RK = 2)
//   for wider heads, so that a block's tiles fit the 227 KB of shared memory
//   and its accumulators stay in registers.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the forward's mask value
constexpr int kMaxHeadDim = 256;
constexpr int kThreads = 256;  // 16 x 16

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

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

// the row stride, in floats, of a staged row of D elements: D rounded up to
// float4s, then to an odd number of them
__host__ __device__ __forceinline__ int row_ld(int D) { return (((D + 3) / 4) | 1) * 4; }

// rows [row0, row0 + rows) of a (n_rows, D) matrix into dst[r * ld + d] as
// f32, zeros past n_rows and in the columns [D, 4 * ceil(D / 4)); consecutive
// threads take consecutive float4s of a row. vec: D % 4 == 0 and the base is
// 16-byte aligned (8-byte for 16-bit types), so four elements load at once
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int row0, int rows,
                                      int n_rows, int D, bool vec) {
  const int d4 = (D + 3) / 4;
  for (int i = threadIdx.x; i < rows * d4; i += kThreads) {
    const int r = i / d4, d = (i - r * d4) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) {
      const T* p = src + static_cast<size_t>(row0 + r) * D + d;
      if (vec) {
        if (sizeof(T) == 4) {
          const float4 f = *reinterpret_cast<const float4*>(p);
          x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(p);
          const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = to_f(h[e]);
        }
      } else {
        T raw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) raw[e] = d + e < D ? p[e] : zero<T>();
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = to_f(raw[e]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + d) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// s[a][b] = sum_d A[ty + 16 a][d] * B[tx + 16 b][d] over the d4 float4s of
// two staged tiles
template <int RQ, int RK>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ld, int d4, int ty,
                                         int tx, float (&s)[RQ][RK]) {
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int b = 0; b < RK; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < d4 * 4; d += 4) {
    float4 x[RQ], y[RK];
#pragma unroll
    for (int a = 0; a < RQ; ++a) x[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * ld + d);
#pragma unroll
    for (int b = 0; b < RK; ++b) y[b] = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * ld + d);
#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int b = 0; b < RK; ++b) {
        s[a][b] = fmaf(x[a].x, y[b].x, s[a][b]);
        s[a][b] = fmaf(x[a].y, y[b].y, s[a][b]);
        s[a][b] = fmaf(x[a].z, y[b].z, s[a][b]);
        s[a][b] = fmaf(x[a].w, y[b].w, s[a][b]);
      }
  }
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (BH, Sq)
  float* delta;  // (BH, Sq)
  int Sq, Skv, dh, dv_;
  float scale;
  int causal;
  bool vec;  // q, k, v, out, dout load four elements at once
};

__device__ __forceinline__ bool valid_pair(const BwdArgs& a, int i, int j) {
  return i < a.Sq && j < a.Skv && (!a.causal || j <= i + a.Skv - a.Sq);
}

// --------------------------------------------------------------------------
// (a) each query's log-sum-exp and Delta
// --------------------------------------------------------------------------
template <typename T, int RQ, int RK>
__global__ void __launch_bounds__(kThreads) bwd_rows_kernel(BwdArgs a) {
  constexpr int BQ = 16 * RQ, BK = 16 * RK;
  extern __shared__ float4 smem4[];
  const int ldh = row_ld(a.dh), d4 = (a.dh + 3) / 4;
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x ldh
  float* ks = qs + BQ * ldh;                     // BK x ldh
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ, off = a.Skv - a.Sq;
  const T* kg = static_cast<const T*>(a.k) + bh * a.Skv * a.dh;

  stage(qs, ldh, static_cast<const T*>(a.q) + bh * a.Sq * a.dh, q0, BQ, a.Sq, a.dh, a.vec);
  float m[RQ], l[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const int k_end = a.causal ? min(a.Skv, q0 + BQ + off) : a.Skv;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q staged; the previous K tile consumed
    stage(ks, ldh, kg, k0, BK, a.Skv, a.dh, a.vec);
    __syncthreads();
    float s[RQ][RK];
    tile_dot<RQ, RK>(qs, ks, ldh, d4, ty, tx, s);
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int i = q0 + ty + 16 * r;
      float mx = kNegInf;
      bool ok[RK];
#pragma unroll
      for (int b = 0; b < RK; ++b) {
        ok[b] = valid_pair(a, i, k0 + tx + 16 * b);
        s[r][b] = ok[b] ? s[r][b] * a.scale : kNegInf;
        mx = fmaxf(mx, s[r][b]);
      }
      const float m_new = fmaxf(m[r], half_max(mx));
      float add = 0.f;
#pragma unroll
      for (int b = 0; b < RK; ++b) add += ok[b] ? expf(s[r][b] - m_new) : 0.f;
      l[r] = l[r] * expf(m[r] - m_new) + add;  // this thread's keys
      m[r] = m_new;
    }
  }

  const T* og = static_cast<const T*>(a.out) + bh * a.Sq * a.dv_;
  const T* dog = static_cast<const T*>(a.dout) + bh * a.Sq * a.dv_;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = q0 + ty + 16 * r;
    const float l_row = half_sum(l[r]);
    float dl = 0.f;
    if (i < a.Sq)
      for (int c = tx; c < a.dv_; c += 16)
        dl = fmaf(to_f(dog[static_cast<size_t>(i) * a.dv_ + c]),
                  to_f(og[static_cast<size_t>(i) * a.dv_ + c]), dl);
    dl = half_sum(dl);
    if (i < a.Sq && tx == 0) {
      a.lse[bh * a.Sq + i] = m[r] + logf(fmaxf(l_row, 1e-30f));
      a.delta[bh * a.Sq + i] = dl;
    }
  }
}

// P and dS of one (query tile, key tile) pair from the staged tiles: thread
// (ty, tx) computes queries ty + 16 r and keys tx + 16 b, and writes them to
// ps / dss (row stride ldp; ps may be null)
template <int RQ, int RK>
__device__ __forceinline__ void p_and_ds(const BwdArgs& a, const float* qs, const float* ks,
                                         const float* dos, const float* vs, const float* lse_s,
                                         const float* dl_s, int q0, int k0, float* ps, float* dss,
                                         int ldp, int ty, int tx) {
  const int ldh = row_ld(a.dh), ldv = row_ld(a.dv_);
  float s[RQ][RK], dp[RQ][RK];
  tile_dot<RQ, RK>(qs, ks, ldh, (a.dh + 3) / 4, ty, tx, s);
  tile_dot<RQ, RK>(dos, vs, ldv, (a.dv_ + 3) / 4, ty, tx, dp);
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int il = ty + 16 * r;
#pragma unroll
    for (int b = 0; b < RK; ++b) {
      const int jl = tx + 16 * b;
      const float p = valid_pair(a, q0 + il, k0 + jl) ? expf(s[r][b] * a.scale - lse_s[il]) : 0.f;
      if (ps) ps[il * ldp + jl] = p;
      dss[il * ldp + jl] = p * (dp[r][b] - dl_s[il]);
    }
  }
}

// acc[r][c][e] += w[r] * X[64 c + 4 tx + e] for the float4s of a staged row X
// that lie within its d4 float4s
template <int R, int NC>
__device__ __forceinline__ void axpy_row(float (&acc)[R][NC][4], const float (&w)[R],
                                         const float* X, int d4, int tx) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (16 * c + tx >= d4) break;
    const float4 x = *reinterpret_cast<const float4*>(X + 64 * c + 4 * tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][c][0] = fmaf(w[r], x.x, acc[r][c][0]);
      acc[r][c][1] = fmaf(w[r], x.y, acc[r][c][1]);
      acc[r][c][2] = fmaf(w[r], x.z, acc[r][c][2]);
      acc[r][c][3] = fmaf(w[r], x.w, acc[r][c][3]);
    }
  }
}

// rows row0 + ty + 16 r (< n_rows) of acc * mul into a (n_rows, D) matrix
template <typename T, int R, int NC>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[R][NC][4], float mul,
                                           int row0, int n_rows, int D, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < D) store(dst + static_cast<size_t>(row) * D + col, acc[r][c][e] * mul);
      }
  }
}

template <int R, int NC>
__device__ __forceinline__ void zero_acc(float (&acc)[R][NC][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;
}

size_t tiles_smem(int bq, int bk, int dh, int dv, int n_p) {
  const int ldp = bk + 16;
  return (static_cast<size_t>(bq + bk) * (row_ld(dh) + row_ld(dv)) +
          static_cast<size_t>(n_p) * bq * ldp + 2 * bq) * sizeof(float);
}

// --------------------------------------------------------------------------
// (b) dK and dV, one block per key tile
// --------------------------------------------------------------------------
template <typename T, int RQ, int RK, int NC>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(BwdArgs a) {
  constexpr int BQ = 16 * RQ, BK = 16 * RK, LDP = BK + 16;
  extern __shared__ float4 smem4[];
  const int ldh = row_ld(a.dh), ldv = row_ld(a.dv_);
  const int d4h = (a.dh + 3) / 4, d4v = (a.dv_ + 3) / 4;
  float* ks = reinterpret_cast<float*>(smem4);  // BK x ldh
  float* vs = ks + BK * ldh;                     // BK x ldv
  float* qs = vs + BK * ldv;                     // BQ x ldh
  float* dos = qs + BQ * ldh;                    // BQ x ldv
  float* ps = dos + BQ * ldv;                    // BQ x LDP
  float* dss = ps + BQ * LDP;                    // BQ x LDP
  float* lse_s = dss + BQ * LDP;                 // BQ
  float* dl_s = lse_s + BQ;                      // BQ
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BK, off = a.Skv - a.Sq;
  const T* qg = static_cast<const T*>(a.q) + bh * a.Sq * a.dh;
  const T* dog = static_cast<const T*>(a.dout) + bh * a.Sq * a.dv_;

  stage(ks, ldh, static_cast<const T*>(a.k) + bh * a.Skv * a.dh, k0, BK, a.Skv, a.dh, a.vec);
  stage(vs, ldv, static_cast<const T*>(a.v) + bh * a.Skv * a.dv_, k0, BK, a.Skv, a.dv_, a.vec);
  float dk[RK][NC][4], dv[RK][NC][4];
  zero_acc(dk);
  zero_acc(dv);
  // the first query whose window reaches key k0
  const int q_begin = a.causal ? (max(0, k0 - off) / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < a.Sq; q0 += BQ) {
    __syncthreads();  // the previous tile's Q, dout, P, dS consumed
    stage(qs, ldh, qg, q0, BQ, a.Sq, a.dh, a.vec);
    stage(dos, ldv, dog, q0, BQ, a.Sq, a.dv_, a.vec);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool in = q0 + i < a.Sq;
      lse_s[i] = in ? a.lse[bh * a.Sq + q0 + i] : 0.f;
      dl_s[i] = in ? a.delta[bh * a.Sq + q0 + i] : 0.f;
    }
    __syncthreads();
    p_and_ds<RQ, RK>(a, qs, ks, dos, vs, lse_s, dl_s, q0, k0, ps, dss, LDP, ty, tx);
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < BQ; ++i) {
      float p[RK], d[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        p[r] = ps[i * LDP + ty + 16 * r];
        d[r] = dss[i * LDP + ty + 16 * r];
      }
      axpy_row<RK, NC>(dv, p, dos + i * ldv, d4v, tx);
      axpy_row<RK, NC>(dk, d, qs + i * ldh, d4h, tx);
    }
  }
  store_rows(static_cast<T*>(a.dk) + bh * a.Skv * a.dh, dk, a.scale, k0, a.Skv, a.dh, ty, tx);
  store_rows(static_cast<T*>(a.dv) + bh * a.Skv * a.dv_, dv, 1.f, k0, a.Skv, a.dv_, ty, tx);
}

// --------------------------------------------------------------------------
// (c) dQ, one block per query tile
// --------------------------------------------------------------------------
template <typename T, int RQ, int RK, int NC>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(BwdArgs a) {
  constexpr int BQ = 16 * RQ, BK = 16 * RK, LDP = BK + 16;
  extern __shared__ float4 smem4[];
  const int ldh = row_ld(a.dh), ldv = row_ld(a.dv_);
  const int d4h = (a.dh + 3) / 4;
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x ldh
  float* dos = qs + BQ * ldh;                    // BQ x ldv
  float* ks = dos + BQ * ldv;                    // BK x ldh
  float* vs = ks + BK * ldh;                     // BK x ldv
  float* dss = vs + BK * ldv;                    // BQ x LDP
  float* lse_s = dss + BQ * LDP;                 // BQ
  float* dl_s = lse_s + BQ;                      // BQ
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ, off = a.Skv - a.Sq;
  const T* kg = static_cast<const T*>(a.k) + bh * a.Skv * a.dh;
  const T* vg = static_cast<const T*>(a.v) + bh * a.Skv * a.dv_;

  stage(qs, ldh, static_cast<const T*>(a.q) + bh * a.Sq * a.dh, q0, BQ, a.Sq, a.dh, a.vec);
  stage(dos, ldv, static_cast<const T*>(a.dout) + bh * a.Sq * a.dv_, q0, BQ, a.Sq, a.dv_,
        a.vec);
  for (int i = tid; i < BQ; i += kThreads) {
    const bool in = q0 + i < a.Sq;
    lse_s[i] = in ? a.lse[bh * a.Sq + q0 + i] : 0.f;
    dl_s[i] = in ? a.delta[bh * a.Sq + q0 + i] : 0.f;
  }
  float dq[RQ][NC][4];
  zero_acc(dq);
  // keys past the tile's last query's window are masked for every row
  const int k_end = a.causal ? min(a.Skv, q0 + BQ + off) : a.Skv;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V, dS consumed
    stage(ks, ldh, kg, k0, BK, a.Skv, a.dh, a.vec);
    stage(vs, ldv, vg, k0, BK, a.Skv, a.dv_, a.vec);
    __syncthreads();
    p_and_ds<RQ, RK>(a, qs, ks, dos, vs, lse_s, dl_s, q0, k0, nullptr, dss, LDP, ty, tx);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float d[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) d[r] = dss[(ty + 16 * r) * LDP + j];
      axpy_row<RQ, NC>(dq, d, ks + j * ldh, d4h, tx);
    }
  }
  store_rows(static_cast<T*>(a.dq) + bh * a.Sq * a.dh, dq, a.scale, q0, a.Sq, a.dh, ty, tx);
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int R, int NC>
cudaError_t launch_bwd_t(const BwdArgs& a, int BH, cudaStream_t s) {
  constexpr int B = 16 * R;
  cudaError_t e;
  if (a.Sq > 0) {
    const size_t smem = static_cast<size_t>(2 * B) * row_ld(a.dh) * sizeof(float);
    if ((e = opt_in(bwd_rows_kernel<T, R, R>, smem)) != cudaSuccess) return e;
    bwd_rows_kernel<T, R, R><<<dim3(BH, (a.Sq + B - 1) / B), kThreads, smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (a.Skv > 0) {
    const size_t smem = tiles_smem(B, B, a.dh, a.dv_, 2);
    if ((e = opt_in(bwd_dkdv_kernel<T, R, R, NC>, smem)) != cudaSuccess) return e;
    bwd_dkdv_kernel<T, R, R, NC><<<dim3(BH, (a.Skv + B - 1) / B), kThreads, smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (a.Sq > 0) {
    const size_t smem = tiles_smem(B, B, a.dh, a.dv_, 1);
    if ((e = opt_in(bwd_dq_kernel<T, R, R, NC>, smem)) != cudaSuccess) return e;
    bwd_dq_kernel<T, R, R, NC><<<dim3(BH, (a.Sq + B - 1) / B), kThreads, smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// tiles of 64 up to heads of 128, of 32 above; NC 64-column groups cover
// the wider head
template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int BH, cudaStream_t s) {
  const int nc = ((a.dh > a.dv_ ? a.dh : a.dv_) + 63) / 64;
  switch (nc) {
    case 1: return launch_bwd_t<T, 4, 1>(a, BH, s);
    case 2: return launch_bwd_t<T, 4, 2>(a, BH, s);
    case 3: return launch_bwd_t<T, 2, 3>(a, BH, s);
    default: return launch_bwd_t<T, 2, 4>(a, BH, s);
  }
}

}  // namespace

extern "C" {

// q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv), out and dout (BH, Sq,
// dv), dq, dk, dv_out like q, k, v, all of dtype; dh, dv <= 256. work:
// 2 * BH * Sq f32 (each query's log-sum-exp, then Delta). Every element of
// dq, dk and dv_out is written. Three launches on the stream; returns the
// first error (a refused launch or shared-memory opt-in).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, void* dq, void* dk, void* dv_out, float* work,
                               int dtype, int BH, int Sq, int Skv, int dh, int dv, float scale,
                               int causal, void* stream) {
  if (BH == 0) return 0;
  if (dh <= 0 || dv <= 0 || dh > kMaxHeadDim || dv > kMaxHeadDim || Sq < 0 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t item = dtype == kF32 ? 4 : 2;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(dout);
  const bool vec = dh % 4 == 0 && dv % 4 == 0 && bases % (4 * item) == 0;
  const BwdArgs a{q, k, v, out, dout, dq, dk, dv_out, work,
                  work + static_cast<size_t>(BH) * Sq, Sq, Skv, dh, dv, scale, causal, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return static_cast<int>(launch_bwd<float>(a, BH, s));
    case kBF16: return static_cast<int>(launch_bwd<__nv_bfloat16>(a, BH, s));
    case kF16: return static_cast<int>(launch_bwd<__half>(a, BH, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
