// Hopper (sm_90a) tensor-core attention for 16-bit inputs, with a plain C
// interface for ctypes (see repro_torch/kernels/_build.py and
// flash_attention.py, which routes bf16/f16 with dh % 8 == dv % 8 == 0 here).
//
// flash_attention (wgmma route) — replaces repro/kernels/flash_attention.py:
//   flash_attention (Pallas body _flash_fwd_kernel), reached through
//   ops.flash_attention. q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv)
//   -> (BH, Sq, dv), bf16 or f16, f32 accumulation. Key j is valid for query
//   i iff j < Skv and, when causal, j <= i + Skv - Sq. The Pallas function
//   exactly: masked scores are the finite -1e30 (their weight is 0), the
//   output is acc / max(l, 1e-30), so a row with no valid key comes out 0.
//   Bound: operations, 2 (dh + dv) per valid (query, key) pair at the dense
//   16-bit tensor-core rate.
//   Design: a persistent grid of one block per SM walks the
//   (bh, 128-query tile) items most work first, so the long causal tiles
//   start first: item i is head i % BH of query tile i / BH, counted from
//   the last tile when causal (a tile's keys grow with its index) and from
//   the first otherwise (every tile reads all keys). A block is three warpgroups: one
//   producer, whose registers are lowered with setmaxnreg and whose one
//   elected thread issues TMA copies, and two consumers of 64 query rows
//   each. Q is copied once per item; K and V tiles (128 keys; 64 where a
//   head pads past 128, 32 at dv 256) go through a ring of three stages in
//   shared memory (two at dv 192),
//   each with a "full" mbarrier (the copy's bytes landed) and an "empty" one
//   (both consumers are done with it). Every tile is in the 128-byte
//   swizzled layout that both the tensor map and the wgmma descriptors name
//   (64 columns per 128-byte row, 16-byte chunk c of row r at c ^ (r % 8)).
//   S = Q K^T is a wgmma with both operands in shared memory (K-major),
//   accumulated in f32 registers; the online softmax runs on those
//   registers (row max and sum over the four threads of a row, exp2 with
//   scale * log2(e) folded in); P is rounded to the inputs' type in
//   registers and is the register A operand of O += P V, with V read
//   MN-major from shared memory (bf16 P as hi + lo, see PFrag). A
//   consumer issues S of tile t and P V of tile t - 1 back to back and runs
//   tile t's softmax while they execute; the two consumers take turns
//   issuing (named barriers), so one's softmax overlaps the other's
//   products. Only tiles that cross the diagonal or the end of the keys
//   compute a mask. Head dims
//   are padded to 64 by the copy, which fills columns past the tensor with
//   zeros, as it does rows past Sq or Skv: zeros add nothing to either
//   product. The tensor maps are encoded per call on the host from the
//   tensors' pointers (cuTensorMapEncodeTiled, taken from the driver
//   through the runtime, so the library does not link libcuda).

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;          // query rows per block
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kRow = 128;         // bytes per swizzled row (64 16-bit elements)
constexpr int kConsumerWarps = 8; // arrivals that release a stage or Q

enum DType { kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor of a 128-byte swizzled operand at shared address
// `addr` (1024-byte aligned atoms): lbo, sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// wait until the phase of parity `parity` has completed (a plain loop: a
// branch out of it, such as a timeout, would put the consumers' products
// on a divergent path, which ptxas serializes)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// the producer's wait, which is outside every product: if a copy never
// lands (a tensor map or a byte count that disagrees with the tiles), the
// consumers wait for it forever and so does this; past 2^34 cycles
// (seconds; a stage is freed within microseconds) it traps, and the launch
// fails with an error instead of hanging
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// box {64 columns, rows, 1} at (c0, c1, c2) of a 3-D tensor map into `dst`;
// completes `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 2^x on the special-function unit: no branches, so it can run while a
// product is in flight (|rel err| < 2^-22, far below the 16-bit P)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to the 16-bit type, the first in the low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as bf16 pairs hi + lo: lo is what rounding a and b to bf16 lost,
// itself rounded, so hi + lo keeps about 16 bits of each
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack2<__nv_bfloat16>(a - f.x, b - f.y);
}

// The pieces of one K/V tile for one warpgroup: S = Q K^T (issue_s), the
// online softmax of S in place (softmax), P in the 16-bit type (pack),
// O += P V (issue_pv). The consumer loop overlaps them: S of tile t and P V
// of tile t - 1 are issued back to back, and the softmax of tile t runs
// while P V of tile t - 1 is in flight. No register that an issued product
// reads is written before that product's wait (the packing of P waits for
// the P V before it), or ptxas serializes the products.
//
// s index 4j + e: row lo (e < 2) or lo + 8, key 8j + 2 (lane % 4) + (e & 1).
// In bf16, P (8 significant bits) would cost up to 2^-9 of each weight, an
// error of several output ulps on a row with few keys, so P goes in as
// hi + lo, two products; f16 P keeps 11 bits and goes in once.
template <typename T, int BK>
struct PFrag {
  static constexpr bool kSplit = std::is_same<T, __nv_bfloat16>::value;
  uint32_t hi[BK / 16][4], lo[kSplit ? BK / 16 : 1][4];
  // keeps the registers live, unmoved, until here: a product in flight
  // reads them
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < BK / 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        asm volatile("" : "+r"(hi[i][j])::"memory");
        if (kSplit) asm volatile("" : "+r"(lo[kSplit ? i : 0][j])::"memory");
      }
  }
};

template <typename T, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_s, uint32_t k_s,
                                        int dhp) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  // the first step writes S afresh: the last tile's weights in s are not an
  // input, so nothing has to move them into place inside the stage
  wgmma::SS<BK, kBF16>::run0(s, desc(q_s, 16, 1024), desc(k_s, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma::SS<BK, kBF16>::run(s, desc(q_s + kk * 32, 16, 1024), desc(k_s + kk * 32, 16, 1024),
                              1);
  for (int a = 1; a < dhp / 64; ++a) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::SS<BK, kBF16>::run(s, desc(q_s + a * kBQ * kRow + kk * 32, 16, 1024),
                                desc(k_s + a * BK * kRow + kk * 32, 16, 1024), 1);
  }
}

template <typename T, int DVP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DVP / 2], const PFrag<T, BK>& p,
                                         uint32_t v_s) {
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv_kk = desc(v_s + kk * 16 * kRow, BK * kRow, 1024);
    wgmma::RS<DVP, kBF16>::run(o, p.hi[kk], dv_kk);
    if constexpr (PFrag<T, BK>::kSplit) wgmma::RS<DVP, kBF16>::run(o, p.lo[kk], dv_kk);
  }
}

// The online softmax of one tile, in place: s becomes the tile's weights
// exp2(s * scale2 - m) (0 where masked), (m, l) are updated, and corr is
// the rescale of the rows' earlier sums. key0: this thread's first key of
// the tile; row hi's limit is lim_lo + 8.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], float scale2, int key0, int lim_lo,
                                        int Skv) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale2;
      if (MASK) {
        const int key = key0 + 8 * j + (e & 1);
        if (key >= Skv || key > lim_lo + (e >> 1) * 8) x = kNegInf;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float w = ex2(s[4 * j + e] - m[e >> 1]);
      if (MASK) {
        const int key = key0 + 8 * j + (e & 1);
        if (key >= Skv || key > lim_lo + (e >> 1) * 8) w = 0.f;
      }
      s[4 * j + e] = w;
      l[e >> 1] += w;
    }
  }
}

// the tile's weights as the A fragments of P V: keys 16 kk .. 16 kk + 15 are
// rows lo/hi of the first 8 keys, then of the next 8
template <typename T, int BK>
__device__ __forceinline__ void pack(const float (&s)[BK / 2], PFrag<T, BK>& p) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int kk = j >> 1, r0 = (j & 1) * 2;
    if constexpr (PFrag<T, BK>::kSplit) {
      split2(s[4 * j], s[4 * j + 1], p.hi[kk][r0], p.lo[kk][r0]);
      split2(s[4 * j + 2], s[4 * j + 3], p.hi[kk][r0 + 1], p.lo[kk][r0 + 1]);
    } else {
      p.hi[kk][r0] = pack2<T>(s[4 * j], s[4 * j + 1]);
      p.hi[kk][r0 + 1] = pack2<T>(s[4 * j + 2], s[4 * j + 3]);
    }
  }
}

// The two consumer warpgroups take turns issuing their products (named
// barriers 1 and 2), so one's softmax runs while the other's products do.
__device__ __forceinline__ void turn_begin(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_end(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

// Q, a ring of `stages` K/V tiles, the barriers and the slack that aligns
// the swizzled tiles to 1024 bytes
constexpr size_t smem_bytes(int dhp, int dvp, int bk, int stages) {
  return 1024 + static_cast<size_t>(kBQ) * dhp * 2 +
         static_cast<size_t>(stages) * bk * (dhp + dvp) * 2 + (2 * stages + 2) * 8;
}

// an item's query tile, (b, h) row and number of K/V tiles
struct Item {
  int q0, bh, n_tiles;
};
template <int BK>
__device__ __forceinline__ Item decode(int item, int BH, int Sq, int Skv, int causal) {
  Item it;
  const int i_qt = item / BH;
  it.bh = item - i_qt * BH;
  it.q0 = (causal ? (Sq + kBQ - 1) / kBQ - 1 - i_qt : i_qt) * kBQ;
  const int k_end = causal ? min(Skv, it.q0 + kBQ + Skv - Sq) : Skv;
  it.n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  return it;
}

template <typename T, int DVP, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
                             int n_items, int BH, int Sq, int Skv, int dv, int dhp,
                             float scale2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_bytes = BK * dhp * 2, stage_bytes = BK * (dhp + DVP) * 2;
  const uint32_t ring = q_s + kBQ * dhp * 2;
  // barriers after the ring: full[STAGES], empty[STAGES], q_full, q_empty
  const uint32_t bars = ring + STAGES * stage_bytes;
  const uint32_t q_full = bars + 2 * STAGES * 8, q_empty = q_full + 8;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);  // warp-uniform
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + st * 8, 1);
      mbar_init(bars + (STAGES + st) * 8, kConsumerWarps);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
      const Item it = decode<BK>(i, BH, Sq, Skv, causal);
      mbar_wait_or_trap(q_empty, (n & 1) ^ 1);  // the previous item's Q is consumed
      mbar_expect_tx(q_full, kBQ * dhp * 2);
      for (int a = 0; a < dhp / 64; ++a)
        tma_load(q_s + a * kBQ * kRow, &tm_q, 64 * a, it.q0, it.bh, q_full);
      for (int t = 0; t < it.n_tiles; ++t) {
        const uint32_t full = bars + stage * 8, empty = bars + (STAGES + stage) * 8;
        const uint32_t k_s = ring + stage * stage_bytes;
        mbar_wait_or_trap(empty, phase ^ 1);
        mbar_expect_tx(full, stage_bytes);
        for (int a = 0; a < dhp / 64; ++a)
          tma_load(k_s + a * BK * kRow, &tm_k, 64 * a, t * BK, it.bh, full);
#pragma unroll
        for (int a = 0; a < DVP / 64; ++a)
          tma_load(k_s + k_bytes + a * BK * kRow, &tm_v, 64 * a, t * BK, it.bh, full);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows 64 c .. 64 c + 63 of the tile.
  // Both walk every tile of every item (a tile past a warpgroup's last query
  // is all masked, an exact no-op), so their turns pair up.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row_lo = c * 64 + warp * 16 + (lane >> 2);  // within the tile
  const int offset = Skv - Sq;
  const uint32_t q_w = q_s + c * 64 * kRow;
  if (c == 1) turn_end(c);  // warpgroup 0 issues first
  int stage = 0;
  uint32_t phase = 0;
  auto next = [&]() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + (STAGES + st) * 8);
  };
  for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
    const Item it = decode<BK>(i, BH, Sq, Skv, causal);
    // key j is valid for row i iff j <= i + offset; non-causal: always
    const int lim_lo = causal ? it.q0 + row_lo + offset : 0x3fffffff;
    const int wg_first = it.q0 + c * 64 + offset;  // the warpgroup's least limit
    const int key0 = 2 * (lane & 3);  // this thread's first key of a tile, less k0
    float o[DVP / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int j = 0; j < DVP / 2; ++j) o[j] = 0.f;
    float s[BK / 2];
    PFrag<T, BK> p;

    // tiles [0, n_full) need no mask for this warpgroup's rows: every key
    // of them is below Skv and, when causal, within its first row's limit
    int n_full = Skv / BK;
    if (causal) n_full = min(n_full, max(wg_first + 1, 0) / BK);

    mbar_wait(q_full, n & 1);
    if (it.n_tiles > 0) {
      // tile 0: S, then its softmax (nothing else in flight)
      mbar_wait(bars + stage * 8, phase);
      turn_begin(c);
      wgmma::fence();
      issue_s<T, BK>(s, q_w, ring + stage * stage_bytes, dhp);
      wgmma::commit();
      turn_end(c);
      wgmma::wait<0>();
      wgmma::fence_operands(s);
      if (n_full > 0)
        softmax<BK, false>(s, m, l, corr, scale2, key0, lim_lo, Skv);
      else
        softmax<BK, true>(s, m, l, corr, scale2, key0, lim_lo, Skv);
      pack<T, BK>(s, p);
      int prev = stage;
      next();
      // tile t: S of tile t and P V of tile t - 1 back to back, tile t's
      // softmax while P V runs, the rows' rescale once it has landed. The
      // masked tiles get their own loop, so no branch sits between a
      // product's issue and its wait.
      auto step = [&](int t, auto masked) {
        mbar_wait(bars + stage * 8, phase);
        turn_begin(c);
        // every register a product reads is settled before its fence
        wgmma::fence_operands(o);
        p.fence();
        wgmma::fence();
        issue_s<T, BK>(s, q_w, ring + stage * stage_bytes, dhp);
        wgmma::commit();
        wgmma::fence_operands(o);
        wgmma::fence();
        issue_pv<T, DVP, BK>(o, p, ring + prev * stage_bytes + k_bytes);
        wgmma::commit();
        turn_end(c);
        wgmma::wait<1>();
        wgmma::fence_operands(s);
        softmax<BK, decltype(masked)::value>(s, m, l, corr, scale2, key0 + t * BK, lim_lo,
                                             Skv);
        wgmma::wait<0>();
        wgmma::fence_operands(o);
        p.fence();
        release(prev);
#pragma unroll
        for (int j = 0; j < DVP / 2; ++j) o[j] *= corr[(j >> 1) & 1];
        pack<T, BK>(s, p);
        // the rescale and the packing happen here, not past the next issue
        wgmma::fence_operands(o);
        p.fence();
        prev = stage;
        next();
      };
      int t = 1;
      for (; t < n_full; ++t) step(t, std::false_type{});
      for (; t < it.n_tiles; ++t) step(t, std::true_type{});
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);  // the last S has landed
      turn_begin(c);
      wgmma::fence_operands(o);
      p.fence();
      wgmma::fence();
      issue_pv<T, DVP, BK>(o, p, ring + prev * stage_bytes + k_bytes);
      wgmma::commit();
      turn_end(c);
      wgmma::wait<0>();
      wgmma::fence_operands(o);
      p.fence();
      release(prev);
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = it.q0 + row_lo + 8 * r;
      if (row >= Sq) continue;
      T* orow = out + (static_cast<size_t>(it.bh) * Sq + row) * dv;
#pragma unroll
      for (int j = 0; j < DVP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < dv)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack2<T>(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (BH, rows, D) 16-bit tensor as 3-D tiles of {64 columns, box_rows rows,
// one bh}, 128-byte swizzle, zeros past every edge
bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int D, int rows,
                int BH, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows > 0 ? rows : 1),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(D) * 2 * (rows > 0 ? rows : 1)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the device that holds `p` (cached per device)
int sm_count(const void* p) {
  static int counts[64] = {0};
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, p) != cudaSuccess || attr.device < 0 || attr.device >= 64)
    return 0;
  if (!counts[attr.device] &&
      cudaDeviceGetAttribute(&counts[attr.device], cudaDevAttrMultiProcessorCount,
                             attr.device) != cudaSuccess)
    return 0;
  return counts[attr.device];
}

template <typename T, int DVP, int BK, int STAGES>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out, int n_items,
                     int BH, int Sq, int Skv, int dh, int dv, int dhp,
                     float scale2, int causal, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __nv_bfloat16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // with no keys no K/V tile is read; the maps then name q's rows
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_q, q, type, dh, Sq, BH, kBQ) ||
      !tensor_map(&tm_k, Skv > 0 ? k : q, type, dh, Skv, BH, BK) ||
      !tensor_map(&tm_v, Skv > 0 ? v : q, type, Skv > 0 ? dv : dh, Skv, BH, BK))
    return cudaErrorInvalidValue;
  const int sms = sm_count(q);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const size_t smem = smem_bytes(dhp, DVP, BK, STAGES);
  auto kernel = flash_attention_wgmma_kernel<T, DVP, BK, STAGES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<n_items < sms ? n_items : sms, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), n_items, BH, Sq, Skv, dv, dhp, scale2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* out, int n_items,
                      int BH, int Sq, int Skv, int dh, int dv, float scale2,
                      int causal, cudaStream_t s) {
  const int dhp = (dh + 63) / 64 * 64, dvp = (dv + 63) / 64 * 64;
  // keys per tile: 128 up to 128-wide heads; past that 64 (32 at dv 256),
  // which keeps the ring in shared memory and the two P fragments, S and O
  // in a consumer's 240 registers
  const int bk = dhp <= 128 && dvp <= 128 ? 128 : dvp == 256 ? 32 : 64;
  // a ring of three stages, two at dv 192 (three would pass 227 KB at dh 256)
#define LAUNCH(DVP, BK)                                                                  \
  launch_t<T, DVP, BK, DVP == 192 ? 2 : 3>(q, k, v, out, n_items, BH, Sq, Skv, dh, dv, dhp, \
                                           scale2, causal, s)
  switch (dvp) {
    case 64: return bk == 128 ? LAUNCH(64, 128) : LAUNCH(64, 64);
    case 128: return bk == 128 ? LAUNCH(128, 128) : LAUNCH(128, 64);
    case 192: return LAUNCH(192, 64);
    default: return LAUNCH(256, 32);
  }
#undef LAUNCH
}

}  // namespace

extern "C" {

// q (BH, Sq, dh), k (BH, Skv, dh), v (BH, Skv, dv), out (BH, Sq, dv), bf16 or
// f16; dh, dv multiples of 8 in [8, 256]; every base 16-byte aligned.
// min(items, SMs) blocks walk the ceil(Sq / 128) * BH items. Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue if a tensor map
// cannot be encoded.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* out,
                                 int dtype, int BH, int Sq, int Skv, int dh, int dv,
                                 float scale, int causal, void* stream) {
  const int n_items = (Sq + kBQ - 1) / kBQ * BH;
  if (n_items == 0 || dv == 0) return 0;
  if (dh % 8 || dv % 8 || dh > 256 || dv > 256 || dh <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16:
      return static_cast<int>(
          launch_dv<__nv_bfloat16>(q, k, v, out, n_items, BH, Sq, Skv, dh, dv, scale2, causal, s));
    case kF16:
      return static_cast<int>(
          launch_dv<__half>(q, k, v, out, n_items, BH, Sq, Skv, dh, dv, scale2, causal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
