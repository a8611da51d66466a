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
//   P = softmax(S) = exp(S - lse) (0 off the valid pairs), Delta_i =
//   sum_c dout_ic out_ic:
//     dv = P^T dout,  dP = dout v^T,  dS = P o (dP - Delta),
//     dq = scale * dS k,  dk = scale * dS^T q.
//   A query row with no valid key has P = 0, so its dq is 0 and it adds
//   nothing to dk and dv (the forward gives such a row 0).
//   Bound: operations, five products of 2 * d flops per valid (query, key)
//   pair (S, dP, dV, dK, dQ): at the f32 rate outside the tensor cores on
//   the SIMT route, three TF32 products each on the TF32 route.
//
//   Every route is two passes after a prologue, and uses no float atomics,
//   so a gradient is bit-equal from run to run:
//   prologue: Delta = rowsum(dout o out), one warp a row; when the caller
//       has no log-sum-exp (the forward writes it under autograd,
//       flash_attention.py), the SIMT row pass recomputes it from q k^T
//       (one more product) together with Delta;
//   (b) one block per (bh, key tile): walks the query tiles that can see its
//       keys (from the first query whose window reaches the tile when
//       causal), recomputes S^T and dP^T, and accumulates dK and dV;
//   (c) one block per (bh, query tile): walks the key tiles up to its last
//       valid key, recomputes S and dP, and accumulates dQ.
//   Seven products per valid pair when the forward's log-sum-exp is given.
//   The 16-bit tensor-core route (wgmma, TMA) is flash_attention_bwd_
//   wgmma.cu; it shares the prologue.
//
//   SIMT route (route 0: heads above 128, widths not multiples of 8, and
//   16-bit shapes the wgmma route does not take): 256 threads as 16 x 16. In
//   a (query, key) tile thread (ty, tx) holds the RQ x RK scores of queries
//   ty + 16 a and keys tx + 16 b: rows are staged row-major in f32 with a
//   row stride of an odd number of float4s, so the 16 threads of a row phase
//   read 16 different keys' float4s without a bank conflict, and a query
//   row's 16 threads share a half-warp (its max and sum are half-warp
//   shuffles). In the accumulation a thread owns rows ty + 16 a and the head
//   columns 64 c + 4 tx + e (c < NC, the head width in 64-column groups), and
//   reads one P / dS value a row and one float4 of q, dout or k per column
//   group. Tiles: BQ = BK = 64 (RQ = RK = 4) for heads up to 128, 32
//   (RQ = RK = 2) for wider heads, so that a block's tiles fit the 227 KB of
//   shared memory and its accumulators stay in registers.
//
//   TF32 route (route 1: f32, dh and dv multiples of 8 up to 128): every
//   product on the tensor cores as 3xTF32 (mma.sync m16n8k8): each operand
//   x is split into hi = tf32(x) (rounded to nearest) and lo = x - hi, and
//   a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in f32: about 21 of
//   f32's 24 bits, where one TF32 product keeps 11. Four warps a block, each
//   owns 16 rows of the pass's own side (keys in (b), queries in (c)); the
//   other side's tiles are double-buffered through cp.async (16-byte copies,
//   zeros past every edge and past the head in the padded columns), so the
//   next tile's copy runs under this tile's products. Rows are staged in f32
//   with a stride of width + 4 floats, so the fragment loads of a warp (rows
//   g = lane / 4, columns t = lane % 4 or rows 2t, columns g) hit 32
//   different banks. S^T and dP^T (or S and dP) stay in the accumulator
//   registers, P and dS are formed there and are the A operand of the next
//   product as they are: the accumulator holds columns (2t, 2t + 1) of each
//   8-column block where the A fragment names (t, t + 4), so the B fragment
//   is read at rows (2t, 2t + 1) too, the same permutation of the reduction
//   on both sides. Tiles: 64 x 64 for heads up to 64; 64 own rows x 32 for
//   wider ones, so two blocks share an SM at heads of 64 (the launch bounds
//   ask for two). The split's rounding is two integer operations: the
//   conversion instruction costs more issue slots, and a split precedes
//   every product.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the forward's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHeadDim = 256;
constexpr int kThreads = 256;  // 16 x 16

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Route { kSimt = 0, kTf32 = 1 };

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
  float* lse;    // (BH, Sq), natural log
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
// prologue: Delta (and, without the forward's, each query's log-sum-exp)
// --------------------------------------------------------------------------
constexpr int kDeltaWarps = 8;

// delta[row] = sum_c dout[row][c] out[row][c], one warp a row, in a fixed
// order (lane-strided sums, then a shuffle tree)
template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32) bwd_delta_kernel(BwdArgs a, size_t rows) {
  const size_t row = static_cast<size_t>(blockIdx.x) * kDeltaWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(a.out) + row * a.dv_;
  const T* d = static_cast<const T*>(a.dout) + row * a.dv_;
  float acc = 0.f;
  for (int c = lane; c < a.dv_; c += 32) acc = fmaf(to_f(d[c]), to_f(o[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[row] = acc;
}

// each query's log-sum-exp recomputed from q k^T, and Delta; one block per
// (bh, BQ-query tile)
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

// --------------------------------------------------------------------------
// SIMT route
// --------------------------------------------------------------------------
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

// (b) dK and dV, one block per key tile
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

// (c) dQ, one block per query tile
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

// --------------------------------------------------------------------------
// TF32 route (f32 only)
// --------------------------------------------------------------------------
constexpr int kTfThreads = 128;  // four warps, 16 own rows each
constexpr int kOwn = 64;         // a block's own rows (keys in (b), queries in (c))

// x rounded to TF32, to nearest with ties away from zero (cvt.rna's
// rounding, for finite x), in two integer operations
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo: hi rounded to TF32, lo the rest as f32 bits (the tensor core
// reads its top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small cross terms first. a: the A fragment split
// (rows g, g + 8; reduction slots t, t + 4), b0/b1 the B values at slots
// t and t + 4 of column g
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// the A fragment of rows r0 + g, r0 + g + 8 and columns c0 + t, c0 + t + 4
// of a staged tile (row stride ld), split
__device__ __forceinline__ void load_a(const float* X, int ld, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(X[0], ah[0], al[0]);
  split(X[8 * ld], ah[1], al[1]);
  split(X[4], ah[2], al[2]);
  split(X[8 * ld + 4], ah[3], al[3]);
}

// the A fragment of an 8-wide slice of an accumulator (c0: row g column 2t,
// c1: g, 2t + 1, c2: g + 8, 2t, c3: g + 8, 2t + 1), split: slot t takes
// column 2t and slot t + 4 column 2t + 1, so the B side reads its rows
// 2t and 2t + 1 in those slots
__device__ __forceinline__ void acc_a(const float (&c)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// acc (16 own rows x 8 N columns) = A (16 x D) B^T with B (8 N rows x D):
// both staged row-major, A at its rows' first element, B at the block of 8
template <int N>
__device__ __forceinline__ void rows_dot(float (&acc)[N / 8][4], const float* A, int lda,
                                         const float* B, int ldb, int D, int g, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ah[4], al[4];
    load_a(A + g * lda + kk + t, lda, ah, al);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float* b = B + (8 * j + g) * ldb + kk + t;
      mma3(acc[j], ah, al, b[0], b[4]);
    }
  }
}

// acc (16 own rows x DP) += W (16 x 8 M, in accumulator registers) X with
// X (M rows x DP) staged row-major
template <int M, int DP>
__device__ __forceinline__ void acc_dot(float (&acc)[DP / 8][4], const float (&w)[M / 8][4],
                                        const float* X, int ld, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < M / 8; ++kk) {
    uint32_t ah[4], al[4];
    acc_a(w[kk], ah, al);
    const float* x = X + (8 * kk + 2 * t) * ld + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) mma3(acc[n], ah, al, x[8 * n], x[ld + 8 * n]);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (n_rows, D) f32 matrix into dst (row stride
// DP + 4) by 16-byte copies, zeros past n_rows and in the columns [D, DP)
template <int ROWS, int DP>
__device__ __forceinline__ void stage_async(float* dst, const float* src, int row0, int n_rows,
                                            int D) {
  constexpr int C = DP / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += kTfThreads) {
    const int r = i / C, c = i - r * C;
    const bool in = row0 + r < n_rows && 4 * c < D;
    cp_async16(dst + r * (DP + 4) + 4 * c,
               in ? src + static_cast<size_t>(row0 + r) * D + 4 * c : src, in);
  }
}

// acc * mul into rows row0 + g (+ 8) and columns 8 n + 2t (+ 1) of a
// (n_rows, D) f32 matrix
template <int DP>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[DP / 8][4], float mul,
                                          int row0, int n_rows, int D, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * D + col) =
            make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  }
}

// P and dS in place of the scores s and dp: element e of 8-column block j is
// row r0 + g + 8 (e >> 1) (an own row) and column c0 + 8 j + 2t + (e & 1);
// lse2 (log2 domain) and delta per element come from `stat` (the other
// side's staged values) or per own row
template <int N, bool OWN_KEYS>
__device__ __forceinline__ void p_ds(const BwdArgs& a, float (&s)[N / 8][4],
                                     float (&dp)[N / 8][4], const float* lse2, const float* dl,
                                     int own0, int other0, bool mask, float scale2, int g,
                                     int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int own = own0 + g + 8 * (e >> 1), oc = 8 * j + 2 * t + (e & 1);
      const int other = other0 + oc;
      const int qi = OWN_KEYS ? other : own, kj = OWN_KEYS ? own : other;
      // per query: a column of S^T, a row of S
      const float l2 = OWN_KEYS ? lse2[oc] : lse2[e >> 1];
      const float d = OWN_KEYS ? dl[oc] : dl[e >> 1];
      float p = exp2f(s[j][e] * scale2 - l2);
      if (mask && !valid_pair(a, qi, kj)) p = 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - d);
    }
}

// a tile needs the mask where a pair may be invalid
__device__ __forceinline__ bool needs_mask(const BwdArgs& a, int q0, int bq, int k0, int bk) {
  return q0 + bq > a.Sq || k0 + bk > a.Skv || (a.causal && k0 + bk - 1 > q0 + a.Skv - a.Sq);
}

template <int DHP, int DVP, int BQ>
constexpr size_t dkdv_tf32_smem() {
  return (static_cast<size_t>(kOwn) * (DHP + DVP + 8) + 2 * BQ * (DHP + DVP + 8) + 4 * BQ) *
         sizeof(float);
}

// (b) on the tensor cores: one block per (bh, 64-key tile), warp w owns keys
// k0 + 16 w .. + 15; Q and dout tiles of BQ queries double-buffered
template <int DHP, int DVP, int BQ>
__global__ void __launch_bounds__(kTfThreads, 2) bwd_dkdv_tf32_kernel(BwdArgs a) {
  constexpr int LDH = DHP + 4, LDV = DVP + 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kOwn x LDH
  float* vs = ks + kOwn * LDH;                   // kOwn x LDV
  float* qs = vs + kOwn * LDV;                   // 2 x BQ x LDH
  float* dos = qs + 2 * BQ * LDH;                // 2 x BQ x LDV
  float* lse_s = dos + 2 * BQ * LDV;             // 2 x BQ, log2 domain
  float* dl_s = lse_s + 2 * BQ;                  // 2 x BQ
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kOwn, off = a.Skv - a.Sq;
  const float scale2 = a.scale * kLog2e;
  const float* qg = static_cast<const float*>(a.q) + bh * a.Sq * a.dh;
  const float* dog = static_cast<const float*>(a.dout) + bh * a.Sq * a.dv_;
  const float* lse_g = a.lse + bh * a.Sq;
  const float* dl_g = a.delta + bh * a.Sq;
  const int q_begin = a.causal ? (max(0, k0 - off) / BQ) * BQ : 0;
  const int n_tiles = q_begin < a.Sq ? (a.Sq - q_begin + BQ - 1) / BQ : 0;

  auto stage_tile = [&](int it) {
    const int q0 = q_begin + it * BQ, b = it & 1;
    stage_async<BQ, DHP>(qs + b * BQ * LDH, qg, q0, a.Sq, a.dh);
    stage_async<BQ, DVP>(dos + b * BQ * LDV, dog, q0, a.Sq, a.dv_);
    for (int i = threadIdx.x; i < BQ; i += kTfThreads) {
      const bool in = q0 + i < a.Sq;
      lse_s[b * BQ + i] = in ? lse_g[q0 + i] * kLog2e : 0.f;
      dl_s[b * BQ + i] = in ? dl_g[q0 + i] : 0.f;
    }
  };
  stage_async<kOwn, DHP>(ks, static_cast<const float*>(a.k) + bh * a.Skv * a.dh, k0, a.Skv,
                         a.dh);
  stage_async<kOwn, DVP>(vs, static_cast<const float*>(a.v) + bh * a.Skv * a.dv_, k0, a.Skv,
                         a.dv_);
  if (n_tiles > 0) stage_tile(0);
  cp_commit();

  float dk[DHP / 8][4], dv[DVP / 8][4];
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < DVP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;
  const float* kw = ks + 16 * warp * LDH;
  const float* vw = vs + 16 * warp * LDV;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ, b = it & 1;
    if (it + 1 < n_tiles) {
      stage_tile(it + 1);  // into the buffer the last iteration released
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* qb = qs + b * BQ * LDH;
    const float* db = dos + b * BQ * LDV;
    float s[BQ / 8][4], dp[BQ / 8][4];
    rows_dot<BQ>(s, kw, LDH, qb, LDH, DHP, g, t);   // S^T = K Q^T
    rows_dot<BQ>(dp, vw, LDV, db, LDV, DVP, g, t);  // dP^T = V dout^T
    p_ds<BQ, true>(a, s, dp, lse_s + b * BQ, dl_s + b * BQ, k0 + 16 * warp, q0,
                   needs_mask(a, q0, BQ, k0, kOwn), scale2, g, t);
    acc_dot<BQ, DVP>(dv, s, db, LDV, g, t);   // dV += P^T dout
    acc_dot<BQ, DHP>(dk, dp, qb, LDH, g, t);  // dK += dS^T Q
    __syncthreads();  // this buffer is free for the tile after next
  }
  const int own0 = k0 + 16 * warp;
  store_acc<DHP>(static_cast<float*>(a.dk) + bh * a.Skv * a.dh, dk, a.scale, own0, a.Skv, a.dh,
                 g, t);
  store_acc<DVP>(static_cast<float*>(a.dv) + bh * a.Skv * a.dv_, dv, 1.f, own0, a.Skv, a.dv_,
                 g, t);
}

template <int DHP, int DVP, int BK>
constexpr size_t dq_tf32_smem() {
  return (static_cast<size_t>(kOwn) * (DHP + DVP + 8) + 2 * BK * (DHP + DVP + 8)) *
         sizeof(float);
}

// (c) on the tensor cores: one block per (bh, 64-query tile), warp w owns
// queries q0 + 16 w .. + 15; K and V tiles of BK keys double-buffered
template <int DHP, int DVP, int BK>
__global__ void __launch_bounds__(kTfThreads, 2) bwd_dq_tf32_kernel(BwdArgs a) {
  constexpr int LDH = DHP + 4, LDV = DVP + 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kOwn x LDH
  float* dos = qs + kOwn * LDH;                  // kOwn x LDV
  float* ks = dos + kOwn * LDV;                  // 2 x BK x LDH
  float* vs = ks + 2 * BK * LDH;                 // 2 x BK x LDV
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kOwn, off = a.Skv - a.Sq;
  const float scale2 = a.scale * kLog2e;
  const float* kg = static_cast<const float*>(a.k) + bh * a.Skv * a.dh;
  const float* vg = static_cast<const float*>(a.v) + bh * a.Skv * a.dv_;
  const int k_end = a.causal ? min(a.Skv, q0 + kOwn + off) : a.Skv;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  auto stage_tile = [&](int it) {
    const int b = it & 1;
    stage_async<BK, DHP>(ks + b * BK * LDH, kg, it * BK, a.Skv, a.dh);
    stage_async<BK, DVP>(vs + b * BK * LDV, vg, it * BK, a.Skv, a.dv_);
  };
  stage_async<kOwn, DHP>(qs, static_cast<const float*>(a.q) + bh * a.Sq * a.dh, q0, a.Sq, a.dh);
  stage_async<kOwn, DVP>(dos, static_cast<const float*>(a.dout) + bh * a.Sq * a.dv_, q0, a.Sq,
                         a.dv_);
  if (n_tiles > 0) stage_tile(0);
  cp_commit();

  // this thread's own rows' statistics (rows g and g + 8 of its warp's)
  const int own0 = q0 + 16 * warp;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = own0 + g + 8 * h;
    lse2[h] = i < a.Sq ? a.lse[bh * a.Sq + i] * kLog2e : 0.f;
    dl[h] = i < a.Sq ? a.delta[bh * a.Sq + i] : 0.f;
  }
  float dq[DHP / 8][4];
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float* qw = qs + 16 * warp * LDH;
  const float* dw = dos + 16 * warp * LDV;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK, b = it & 1;
    if (it + 1 < n_tiles) {
      stage_tile(it + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* kb = ks + b * BK * LDH;
    const float* vb = vs + b * BK * LDV;
    float s[BK / 8][4], dp[BK / 8][4];
    rows_dot<BK>(s, qw, LDH, kb, LDH, DHP, g, t);   // S = Q K^T
    rows_dot<BK>(dp, dw, LDV, vb, LDV, DVP, g, t);  // dP = dout V^T
    p_ds<BK, false>(a, s, dp, lse2, dl, own0, k0, needs_mask(a, q0, kOwn, k0, BK), scale2, g, t);
    acc_dot<BK, DHP>(dq, dp, kb, LDH, g, t);  // dQ += dS K
    __syncthreads();
  }
  store_acc<DHP>(static_cast<float*>(a.dq) + bh * a.Sq * a.dh, dq, a.scale, own0, a.Sq, a.dh, g,
                 t);
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch_prologue(const BwdArgs& a, int BH, bool lse_given, cudaStream_t s) {
  if (a.Sq == 0) return cudaSuccess;
  if (lse_given) {
    const size_t rows = static_cast<size_t>(BH) * a.Sq;
    bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kDeltaWarps - 1) / kDeltaWarps),
                          kDeltaWarps * 32, 0, s>>>(a, rows);
    return cudaGetLastError();
  }
  // tiles of 64 up to heads of 128, of 32 above
  const int R = a.dh > 128 ? 2 : 4, B = 16 * R;
  const size_t smem = static_cast<size_t>(2 * B) * row_ld(a.dh) * sizeof(float);
  auto kernel = R == 4 ? bwd_rows_kernel<T, 4, 4> : bwd_rows_kernel<T, 2, 2>;
  cudaError_t e = opt_in(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(BH, (a.Sq + B - 1) / B), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int R, int NC>
cudaError_t launch_simt_t(const BwdArgs& a, int BH, cudaStream_t s) {
  constexpr int B = 16 * R;
  cudaError_t e;
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
cudaError_t launch_simt(const BwdArgs& a, int BH, cudaStream_t s) {
  const int nc = ((a.dh > a.dv_ ? a.dh : a.dv_) + 63) / 64;
  switch (nc) {
    case 1: return launch_simt_t<T, 4, 1>(a, BH, s);
    case 2: return launch_simt_t<T, 4, 2>(a, BH, s);
    case 3: return launch_simt_t<T, 2, 3>(a, BH, s);
    default: return launch_simt_t<T, 2, 4>(a, BH, s);
  }
}

// the other side's tile: 64 rows at heads up to 64, 32 past that
template <int DHP, int DVP>
cudaError_t launch_tf32_t(const BwdArgs& a, int BH, cudaStream_t s) {
  constexpr int BO = DHP <= 64 && DVP <= 64 ? 64 : 32;
  cudaError_t e;
  if (a.Skv > 0) {
    constexpr size_t smem = dkdv_tf32_smem<DHP, DVP, BO>();
    if ((e = opt_in(bwd_dkdv_tf32_kernel<DHP, DVP, BO>, smem)) != cudaSuccess) return e;
    bwd_dkdv_tf32_kernel<DHP, DVP, BO>
        <<<dim3(BH, (a.Skv + kOwn - 1) / kOwn), kTfThreads, smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (a.Sq > 0) {
    constexpr size_t smem = dq_tf32_smem<DHP, DVP, BO>();
    if ((e = opt_in(bwd_dq_tf32_kernel<DHP, DVP, BO>, smem)) != cudaSuccess) return e;
    bwd_dq_tf32_kernel<DHP, DVP, BO>
        <<<dim3(BH, (a.Sq + kOwn - 1) / kOwn), kTfThreads, smem, s>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// head widths padded to 64 or 128 (the copies fill the padding with zeros)
cudaError_t launch_tf32(const BwdArgs& a, int BH, cudaStream_t s) {
  const bool wide_h = a.dh > 64, wide_v = a.dv_ > 64;
  if (!wide_h && !wide_v) return launch_tf32_t<64, 64>(a, BH, s);
  if (!wide_h) return launch_tf32_t<64, 128>(a, BH, s);
  if (!wide_v) return launch_tf32_t<128, 64>(a, BH, s);
  return launch_tf32_t<128, 128>(a, BH, s);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, void* dq, void* dk, void* dv_out, float* lse, float* delta,
                  int dtype, int Sq, int Skv, int dh, int dv, float scale, int causal) {
  const size_t item = dtype == kF32 ? 4 : 2;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(dout);
  const bool vec = dh % 4 == 0 && dv % 4 == 0 && bases % (4 * item) == 0;
  return BwdArgs{q, k, v, out, dout, dq, dk, dv_out, lse, delta, Sq, Skv, dh, dv, scale, causal,
                 vec};
}

bool bad_shape(int BH, int Sq, int Skv, int dh, int dv) {
  return BH < 0 || dh <= 0 || dv <= 0 || dh > kMaxHeadDim || dv > kMaxHeadDim || Sq < 0 ||
         Skv < 0;
}

}  // namespace

extern "C" {

// The prologue of every route: delta (BH, Sq) f32 = rowsum(dout o out);
// with lse_given == 0 also lse (BH, Sq) f32, each query's log-sum-exp of
// scale q k^T over its valid keys (the SIMT row pass), else lse is read
// later as given. One launch on the stream; returns its error.
int flash_attention_bwd_prologue(const void* q, const void* k, const void* out,
                                 const void* dout, float* lse, float* delta, int lse_given,
                                 int dtype, int BH, int Sq, int Skv, int dh, int dv, float scale,
                                 int causal, void* stream) {
  if (BH == 0) return 0;
  if (bad_shape(BH, Sq, Skv, dh, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(q, k, nullptr, out, dout, nullptr, nullptr, nullptr, lse, delta,
                              dtype, Sq, Skv, dh, dv, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return static_cast<int>(launch_prologue<float>(a, BH, lse_given != 0, s));
    case kBF16: return static_cast<int>(launch_prologue<__nv_bfloat16>(a, BH, lse_given != 0, s));
    case kF16: return static_cast<int>(launch_prologue<__half>(a, BH, lse_given != 0, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv), dout (BH, Sq, dv), dq,
// dk, dv_out like q, k, v, all of dtype; dh, dv <= 256; lse and delta from
// the prologue. route 0 (SIMT, any dtype) or 1 (TF32: f32, dh and dv
// multiples of 8 up to 128, every base 16-byte aligned). Every element of
// dq, dk and dv_out is written. Two launches on the stream; returns the
// first error (a refused launch or shared-memory opt-in).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                               void* dq, void* dk, void* dv_out, const float* lse,
                               const float* delta, int dtype, int BH, int Sq, int Skv, int dh,
                               int dv, float scale, int causal, int route, void* stream) {
  if (BH == 0) return 0;
  if (bad_shape(BH, Sq, Skv, dh, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = make_args(q, k, v, nullptr, dout, dq, dk, dv_out, const_cast<float*>(lse),
                              const_cast<float*>(delta), dtype, Sq, Skv, dh, dv, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kTf32) {
    if (dtype != kF32 || dh % 8 || dv % 8 || dh > 128 || dv > 128 ||
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
         reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
         reinterpret_cast<uintptr_t>(dv_out)) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_tf32(a, BH, s));
  }
  if (route != kSimt) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return static_cast<int>(launch_simt<float>(a, BH, s));
    case kBF16: return static_cast<int>(launch_simt<__nv_bfloat16>(a, BH, s));
    case kF16: return static_cast<int>(launch_simt<__half>(a, BH, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
