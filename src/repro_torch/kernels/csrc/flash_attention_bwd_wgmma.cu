// Hopper (sm_90a) tensor-core attention backward for 16-bit inputs, with a
// plain C interface for ctypes (see repro_torch/kernels/_build.py and
// flash_attention.py, whose _backward_route sends bf16/f16 with dh and dv
// multiples of 8 up to 128 here).
//
// flash_attention_bwd (wgmma route) — replaces no TPU kernel (JAX
//   differentiates the jnp scan of repro/models/layers.py:
//   blockwise_attention with jax.grad). The function of
//   flash_attention_bwd.cu: q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv,
//   dv), dout (BH, Sq, dv) -> dq, dk, dv in the inputs' type, with each
//   query's f32 log-sum-exp (written by the forward) and Delta = rowsum(
//   dout o out) (the prologue in flash_attention_bwd.cu) as inputs. Key j
//   is valid for query i iff j < Skv and, when causal, j <= i + Skv - Sq.
//   Bound: operations, five products of 2 d per valid pair at the dense
//   16-bit tensor-core rate (this route runs seven: S and dP in both
//   passes), or the bytes of q, k, v, out, dout read and dq, dk, dv written.
//   Design: two launches, no float atomics, so a gradient is bit-equal from
//   run to run. Both have the forward kernel's shape (flash_attention_
//   wgmma.cu, whose copy helpers are in tma.cuh): three warpgroups, one
//   producer whose registers setmaxnreg lowers and whose thread 0 issues
//   TMA copies of 128-byte swizzled tiles, and two consumers that own 64
//   rows each; a block's own tile is copied once, the other side's tiles go
//   through a ring of three stages with "full" and "empty" mbarriers.
//   (b) dK, dV: one block per (bh, 128-key tile), heavy tiles first (key
//       tile 0 sees every query when causal); the ring holds Q and dout
//       tiles of 64 queries, and warp 1 of the producer writes the tile's
//       log-sum-exp (log2 domain) and Delta beside them. Per tile a
//       consumer computes S^T = K Q^T and dP^T = V dout^T (wgmma with both
//       operands in shared memory, K-major), forms P^T = exp2(S^T scale
//       log2 e - lse log2 e) and dS^T = P^T o (dP^T - Delta) in the f32
//       accumulator registers, rounds them to the 16-bit type as register A
//       fragments, and accumulates dV += P^T dout and dK += dS^T Q (register
//       A, B read MN-major from the same tiles).
//   (c) dQ: one block per (bh, 128-query tile), last tile first when
//       causal; the ring holds K and V tiles of 64 keys. Per tile: S = Q K^T,
//       dP = dout V^T (shared-memory operands), P and dS in registers with
//       each own row's statistics, dQ += dS K (dS as the register A operand,
//       K read MN-major).
//   Head widths are padded to 64 or 128 by the copy, which fills columns
//   past the tensor with zeros, as it does rows past Sq or Skv. A consumer
//   waits for each product group before it touches the registers it names.

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kRow = 128;         // bytes per swizzled row (64 16-bit elements)
constexpr int kOwn = 128;         // a block's own rows, 64 per consumer
constexpr int kOther = 64;        // rows of the other side's tile in the ring
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8; // arrivals that release a stage

enum DType { kBF16 = 1, kF16 = 2 };

struct Args {
  void* dq;
  void* dk;
  void* dv;
  const float* lse;    // (BH, Sq), natural log
  const float* delta;  // (BH, Sq)
  int BH, Sq, Skv, dh, dv_;
  float scale2;  // scale * log2 e
  float scale;
  int causal;
};

__device__ __forceinline__ bool valid(const Args& a, int i, int j) {
  return i < a.Sq && j < a.Skv && (!a.causal || j <= i + a.Skv - a.Sq);
}
__device__ __forceinline__ bool needs_mask(const Args& a, int q0, int bq, int k0, int bk) {
  return q0 + bq > a.Sq || k0 + bk > a.Skv || (a.causal && k0 + bk - 1 > q0 + a.Skv - a.Sq);
}

// d (64 own rows x N) = A B^T over the padded reduction width dp: A's 64
// rows at a_s (its 64-column chunks a_chunk bytes apart), B's N rows at b_s
// (chunks b_chunk apart), both K-major
template <typename T, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a_s, uint32_t a_chunk,
                                         uint32_t b_s, uint32_t b_chunk, int dp) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  wgmma::SS<N, kBF16>::run0(d, desc(a_s, 16, 1024), desc(b_s, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma::SS<N, kBF16>::run(d, desc(a_s + kk * 32, 16, 1024), desc(b_s + kk * 32, 16, 1024), 1);
  for (int c = 1; c < dp / 64; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::SS<N, kBF16>::run(d, desc(a_s + c * a_chunk + kk * 32, 16, 1024),
                               desc(b_s + c * b_chunk + kk * 32, 16, 1024), 1);
  }
}

// d (64 own rows x DP) += W X: W (64 x M) as register A fragments, X (M rows
// x DP) read MN-major from its tile of `rows` rows at x_s
template <typename T, int DP, int M>
__device__ __forceinline__ void issue_rs(float (&d)[DP / 2], const uint32_t (&w)[M / 16][4],
                                         uint32_t x_s, uint32_t rows) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
#pragma unroll
  for (int kk = 0; kk < M / 16; ++kk)
    wgmma::RS<DP, kBF16>::run(d, w[kk], desc(x_s + kk * 16 * kRow, rows * kRow, 1024));
}

template <int M>
__device__ __forceinline__ void fence_frags(uint32_t (&w)[M / 16][4]) {
#pragma unroll
  for (int i = 0; i < M / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(w[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// rows own_lo (+ 8) of acc * mul into a (n_rows, D) matrix: accumulator
// index 4 j + 2 r + e is row own_lo + 8 r, column 8 j + 2 (lane % 4) + e
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[DP / 2], float mul,
                                           int own_lo, int n_rows, int D, int lane) {
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = own_lo + 8 * r;
    if (row >= n_rows) continue;
    T* o = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D)
        *reinterpret_cast<uint32_t*>(o + col) =
            pack2<T>(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// P and dS of one tile in place of s and dp, then both as 16-bit A
// fragments. Element 4 j + e is own row own_lo + 8 (e >> 1) and other-side
// column other0 + 8 j + 2 (lane % 4) + (e & 1); lse2 / dl give the query's
// statistics: per column when the own rows are keys, per row otherwise
template <typename T, int N, bool OWN_KEYS>
__device__ __forceinline__ void p_ds(const Args& a, float (&s)[N / 2], float (&dp)[N / 2],
                                     const float* lse2, const float* dl, int own_lo, int other0,
                                     bool mask, int lane, uint32_t (&pf)[N / 16][4],
                                     uint32_t (&df)[N / 16][4]) {
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int oc = 8 * j + col0 + (e & 1);
      const int own = own_lo + 8 * (e >> 1), other = other0 + oc;
      const float l2 = OWN_KEYS ? lse2[oc] : lse2[e >> 1];
      const float d = OWN_KEYS ? dl[oc] : dl[e >> 1];
      float p = ex2(s[4 * j + e] * a.scale2 - l2);
      if (mask && !(OWN_KEYS ? valid(a, other, own) : valid(a, own, other))) p = 0.f;
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - d);
    }
    const int kk = j >> 1, r0 = (j & 1) * 2;
    pf[kk][r0] = pack2<T>(s[4 * j], s[4 * j + 1]);
    pf[kk][r0 + 1] = pack2<T>(s[4 * j + 2], s[4 * j + 3]);
    df[kk][r0] = pack2<T>(dp[4 * j], dp[4 * j + 1]);
    df[kk][r0 + 1] = pack2<T>(dp[4 * j + 2], dp[4 * j + 3]);
  }
}

// The producer's last wait: until the consumers have released every stage
// and the block's own tiles have landed. A copy that never lands (a tensor
// map or a byte count that disagrees with the tiles) leaves the consumers
// waiting in plain loops; this bounded wait then traps, and the launch fails
// with an error instead of hanging. `empty` is the first stage's barrier.
__device__ __forceinline__ void drain(uint32_t empty, int stage, uint32_t phase,
                                      uint32_t own_full) {
  for (int i = 0; i < kStages; ++i) {
    mbar_wait_or_trap(empty + stage * 8, phase ^ 1);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait_or_trap(own_full, 0);
}

constexpr size_t dkdv_smem(int dp) {
  // own K and V, the ring of Q and dout tiles, its statistics, the barriers
  return 1024 + static_cast<size_t>(kOwn) * 2 * dp * 2 +
         static_cast<size_t>(kStages) * kOther * 2 * dp * 2 + kStages * 2 * kOther * 4 +
         (2 * kStages + 1) * 8;
}

// (b) dK and dV
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + kOwn * DP * 2;
  const uint32_t half_bytes = kOther * DP * 2, stage_bytes = 2 * half_bytes;
  const uint32_t ring = v_s + kOwn * DP * 2;
  const uint32_t stats = ring + kStages * stage_bytes;  // [stage][lse2 | delta][kOther] f32
  const uint32_t bars = stats + kStages * 2 * kOther * 4;  // full, empty, kv_full
  const uint32_t kv_full = bars + 2 * kStages * 8;
  float* stats_p = reinterpret_cast<float*>(smem_raw + (stats - smem_u32(smem_raw)));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  const int kt = blockIdx.x / a.BH, bh = blockIdx.x - kt * a.BH;
  const int k0 = kt * kOwn, off = a.Skv - a.Sq;
  const int q_begin = a.causal ? (max(0, k0 - off) / kOther) * kOther : 0;
  const int n_tiles = q_begin < a.Sq ? (a.Sq - q_begin + kOther - 1) / kOther : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + st * 8, 1 + 32);  // the copy's arrival, warp 1's 32
      mbar_init(bars + (kStages + st) * 8, kConsumerWarps);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp > 1 || (warp == 0 && lane != 0)) return;
    if (warp == 0) {
      mbar_expect_tx(kv_full, 2 * kOwn * DP * 2);
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(k_s + c * kOwn * kRow, &tm_k, 64 * c, k0, bh, kv_full);
        tma_load(v_s + c * kOwn * kRow, &tm_v, 64 * c, k0, bh, kv_full);
      }
    }
    const float* lse_g = a.lse + static_cast<size_t>(bh) * a.Sq;
    const float* dl_g = a.delta + static_cast<size_t>(bh) * a.Sq;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = q_begin + t * kOther;
      mbar_wait_or_trap(bars + (kStages + stage) * 8, phase ^ 1);
      if (warp == 0) {
        const uint32_t full = bars + stage * 8, q_st = ring + stage * stage_bytes;
        mbar_expect_tx(full, stage_bytes);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load(q_st + c * kOther * kRow, &tm_q, 64 * c, q0, bh, full);
          tma_load(q_st + half_bytes + c * kOther * kRow, &tm_do, 64 * c, q0, bh, full);
        }
      } else {
        float* st = stats_p + stage * 2 * kOther;
        for (int i = lane; i < kOther; i += 32) {
          const bool in = q0 + i < a.Sq;
          st[i] = in ? lse_g[q0 + i] * kLog2e : 0.f;
          st[kOther + i] = in ? dl_g[q0 + i] : 0.f;
        }
        mbar_arrive(bars + stage * 8);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (warp == 0) drain(bars + kStages * 8, stage, phase, kv_full);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int own0 = k0 + 64 * c, own_lo = own0 + 16 * warp + (lane >> 2);
  const uint32_t k_w = k_s + c * 64 * kRow, v_w = v_s + c * 64 * kRow;
  float dk[DP / 2], dv[DP / 2];
  zero(dk);
  zero(dv);
  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kOther;
    const uint32_t q_st = ring + stage * stage_bytes, do_st = q_st + half_bytes;
    mbar_wait(bars + stage * 8, phase);
    float s[kOther / 2], dp[kOther / 2];
    wgmma::fence();
    issue_ss<T, kOther>(s, k_w, kOwn * kRow, q_st, kOther * kRow, DP);    // S^T = K Q^T
    issue_ss<T, kOther>(dp, v_w, kOwn * kRow, do_st, kOther * kRow, DP);  // dP^T = V dout^T
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);
    const float* st = stats_p + stage * 2 * kOther;
    uint32_t pf[kOther / 16][4], df[kOther / 16][4];
    p_ds<T, kOther, true>(a, s, dp, st, st + kOther, own_lo, q0,
                          needs_mask(a, q0, kOther, own0, 64), lane, pf, df);
    fence_frags<kOther>(pf);
    fence_frags<kOther>(df);
    wgmma::fence_operands(dv);
    wgmma::fence_operands(dk);
    wgmma::fence();
    issue_rs<T, DP, kOther>(dv, pf, do_st, kOther);  // dV += P^T dout
    issue_rs<T, DP, kOther>(dk, df, q_st, kOther);   // dK += dS^T Q
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(dv);
    wgmma::fence_operands(dk);
    fence_frags<kOther>(pf);
    fence_frags<kOther>(df);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + (kStages + stage) * 8);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<T, DP>(static_cast<T*>(a.dk) + static_cast<size_t>(bh) * a.Skv * a.dh, dk, a.scale,
                    own_lo, a.Skv, a.dh, lane);
  store_rows<T, DP>(static_cast<T*>(a.dv) + static_cast<size_t>(bh) * a.Skv * a.dv_, dv, 1.f,
                    own_lo, a.Skv, a.dv_, lane);
}

constexpr size_t dq_smem(int dp) {
  // own Q and dout, the ring of K and V tiles, the barriers
  return 1024 + static_cast<size_t>(kOwn) * 2 * dp * 2 +
         static_cast<size_t>(kStages) * kOther * 2 * dp * 2 + (2 * kStages + 1) * 8;
}

// (c) dQ
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kOwn * DP * 2;
  const uint32_t half_bytes = kOther * DP * 2, stage_bytes = 2 * half_bytes;
  const uint32_t ring = do_s + kOwn * DP * 2;
  const uint32_t bars = ring + kStages * stage_bytes;  // full, empty, q_full
  const uint32_t q_full = bars + 2 * kStages * 8;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  const int n_qt = (a.Sq + kOwn - 1) / kOwn;
  const int rank = blockIdx.x / a.BH, bh = blockIdx.x - rank * a.BH;
  const int q0 = (a.causal ? n_qt - 1 - rank : rank) * kOwn, off = a.Skv - a.Sq;
  const int k_end = a.causal ? min(a.Skv, q0 + kOwn + off) : a.Skv;
  const int n_tiles = k_end > 0 ? (k_end + kOther - 1) / kOther : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + st * 8, 1);
      mbar_init(bars + (kStages + st) * 8, kConsumerWarps);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_full, 2 * kOwn * DP * 2);
    for (int c = 0; c < DP / 64; ++c) {
      tma_load(q_s + c * kOwn * kRow, &tm_q, 64 * c, q0, bh, q_full);
      tma_load(do_s + c * kOwn * kRow, &tm_do, 64 * c, q0, bh, q_full);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const uint32_t full = bars + stage * 8, k_st = ring + stage * stage_bytes;
      mbar_wait_or_trap(bars + (kStages + stage) * 8, phase ^ 1);
      mbar_expect_tx(full, stage_bytes);
      for (int c = 0; c < DP / 64; ++c) {
        tma_load(k_st + c * kOther * kRow, &tm_k, 64 * c, t * kOther, bh, full);
        tma_load(k_st + half_bytes + c * kOther * kRow, &tm_v, 64 * c, t * kOther, bh, full);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    drain(bars + kStages * 8, stage, phase, q_full);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int own0 = q0 + 64 * c, own_lo = own0 + 16 * warp + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = own_lo + 8 * r;
    const size_t at = static_cast<size_t>(bh) * a.Sq + i;
    lse2[r] = i < a.Sq ? a.lse[at] * kLog2e : 0.f;
    dl[r] = i < a.Sq ? a.delta[at] : 0.f;
  }
  const uint32_t q_w = q_s + c * 64 * kRow, do_w = do_s + c * 64 * kRow;
  float dq[DP / 2];
  zero(dq);
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kOther;
    const uint32_t k_st = ring + stage * stage_bytes, v_st = k_st + half_bytes;
    mbar_wait(bars + stage * 8, phase);
    float s[kOther / 2], dp[kOther / 2];
    wgmma::fence();
    issue_ss<T, kOther>(s, q_w, kOwn * kRow, k_st, kOther * kRow, DP);    // S = Q K^T
    issue_ss<T, kOther>(dp, do_w, kOwn * kRow, v_st, kOther * kRow, DP);  // dP = dout V^T
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);
    uint32_t pf[kOther / 16][4], df[kOther / 16][4];
    p_ds<T, kOther, false>(a, s, dp, lse2, dl, own_lo, k0, needs_mask(a, own0, 64, k0, kOther),
                           lane, pf, df);
    fence_frags<kOther>(df);
    wgmma::fence_operands(dq);
    wgmma::fence();
    issue_rs<T, DP, kOther>(dq, df, k_st, kOther);  // dQ += dS K
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(dq);
    fence_frags<kOther>(df);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + (kStages + stage) * 8);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<T, DP>(static_cast<T*>(a.dq) + static_cast<size_t>(bh) * a.Sq * a.dh, dq, a.scale,
                    own_lo, a.Sq, a.dh, lane);
}

template <typename T, int DP>
cudaError_t launch_t(const void* q, const void* k, const void* v, const void* dout,
                     const Args& a, cudaStream_t s) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  cudaError_t e;
  {  // (b): own K and V tiles of kOwn rows, Q and dout tiles of kOther
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    if (!tensor_map(&tm_q, q, type, a.dh, a.Sq, a.BH, kOther) ||
        !tensor_map(&tm_k, k, type, a.dh, a.Skv, a.BH, kOwn) ||
        !tensor_map(&tm_v, v, type, a.dv_, a.Skv, a.BH, kOwn) ||
        !tensor_map(&tm_do, dout, type, a.dv_, a.Sq, a.BH, kOther))
      return cudaErrorInvalidValue;
    const size_t smem = dkdv_smem(DP);
    auto kernel = bwd_dkdv_wgmma_kernel<T, DP>;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
      return e;
    kernel<<<(a.Skv + kOwn - 1) / kOwn * a.BH, kThreads, smem, s>>>(tm_q, tm_k, tm_v, tm_do, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  {  // (c): own Q and dout tiles of kOwn rows, K and V tiles of kOther
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    if (!tensor_map(&tm_q, q, type, a.dh, a.Sq, a.BH, kOwn) ||
        !tensor_map(&tm_k, k, type, a.dh, a.Skv, a.BH, kOther) ||
        !tensor_map(&tm_v, v, type, a.dv_, a.Skv, a.BH, kOther) ||
        !tensor_map(&tm_do, dout, type, a.dv_, a.Sq, a.BH, kOwn))
      return cudaErrorInvalidValue;
    const size_t smem = dq_smem(DP);
    auto kernel = bwd_dq_wgmma_kernel<T, DP>;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
      return e;
    kernel<<<(a.Sq + kOwn - 1) / kOwn * a.BH, kThreads, smem, s>>>(tm_q, tm_k, tm_v, tm_do, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// both head widths padded to the wider one's 64 or 128
template <typename T>
cudaError_t launch_dp(const void* q, const void* k, const void* v, const void* dout,
                      const Args& a, cudaStream_t s) {
  return a.dh > 64 || a.dv_ > 64 ? launch_t<T, 128>(q, k, v, dout, a, s)
                                 : launch_t<T, 64>(q, k, v, dout, a, s);
}

}  // namespace

extern "C" {

// q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv), dout (BH, Sq, dv), dq,
// dk, dv_out like q, k, v, bf16 or f16; dh, dv multiples of 8 up to 128;
// every base 16-byte aligned. lse and delta (BH, Sq) f32: each query's
// natural log-sum-exp and rowsum(dout o out). Every element of dq, dk and
// dv_out is written (zeros where the other side is empty). Two launches on
// the stream; returns the first error, or cudaErrorInvalidValue for a shape
// or alignment it does not take or a tensor map it cannot encode.
int flash_attention_bwd_wgmma_launch(const void* q, const void* k, const void* v,
                                     const void* dout, void* dq, void* dk, void* dv_out,
                                     const float* lse, const float* delta, int dtype, int BH,
                                     int Sq, int Skv, int dh, int dv, float scale, int causal,
                                     void* stream) {
  if (BH == 0) return 0;
  if (BH < 0 || Sq < 0 || Skv < 0 || dh <= 0 || dv <= 0 || dh % 8 || dv % 8 || dh > 128 ||
      dv > 128 || (dtype != kBF16 && dtype != kF16) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv_out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || Skv == 0) {  // no pair: every gradient is 0
    cudaError_t e = cudaMemsetAsync(dq, 0, static_cast<size_t>(BH) * Sq * dh * 2, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dk, 0, static_cast<size_t>(BH) * Skv * dh * 2, s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(dv_out, 0, static_cast<size_t>(BH) * Skv * dv * 2, s);
    return static_cast<int>(e);
  }
  const Args a{dq, dk, dv_out, lse, delta, BH, Sq, Skv, dh, dv, scale * kLog2e, scale, causal};
  return static_cast<int>(dtype == kBF16 ? launch_dp<__nv_bfloat16>(q, k, v, dout, a, s)
                                         : launch_dp<__half>(q, k, v, dout, a, s));
}

}  // extern "C"
