// Hopper (sm_90a) kernels of the bi-metric beam step, with a plain C
// interface for ctypes (see repro_torch/kernels/_build.py and l2_topk.py).
//
// gather_score — replaces repro/kernels/l2_topk.py:gather_score (Pallas
//   bodies _gather_score_kernel, _gather_score_mm_kernel,
//   _gather_score_mm_quant_kernel). Per (b, k) lane: score corpus[ids[b, k]]
//   against query b under l2 / sqeuclidean / ip / cosine; ids < 0 -> +inf.
//   Bound: bytes. Each live lane reads one row (dim * itemsize bytes) plus
//   its metadata; arithmetic is 2-3 flops per element, far below the card's
//   rate, so the floor is B*K*dim*itemsize / 3.35 TB/s.
//   Design: one warp per lane, eight lanes of one query per block; the block
//   stages query b in shared memory once, each warp streams its row with
//   16-byte vector loads (when dim is a multiple of 16 / itemsize) and
//   accumulates in f32 in a fixed order, then reduces with a fixed xor
//   shuffle tree. A lane's result depends only on (query row, corpus row),
//   never on B, K or its position, so batched and single-query searches
//   agree bit for bit on the card.
//   Forms: MM=false gather-then-reduce; MM=true norm-cache form over the
//   packed (N, 2) [|x|^2, 1/|x|] or (N, 4) [.., scale, zp] metadata;
//   QUANT=true dequantizes the codes in registers as (code - zp) * scale,
//   exactly ref.dequant_rows_ref (rounded steps, no contraction).
//
// gather_score_local — replaces repro/kernels/l2_topk.py:gather_score_local
//   (Pallas bodies _gather_score_local_kernel, _gather_score_local_mm_kernel,
//   _gather_score_local_mm_quant_kernel), reached through the sharded
//   search's wave (distributed/collectives.wave_gather_score). Each shard
//   holds a contiguous block of n_local rows starting at global row offset;
//   a lane is owned iff 0 <= id - offset < n_local. Owned lanes run the
//   lane body of gather_score (score_row) on the local row, so they equal
//   the unsharded lane bit for bit; foreign and padding lanes write 0.0 and
//   load nothing, so summing the S partials rebuilds the wave exactly.
//   Bound: bytes, the owned lanes' rows (about K/S lanes of each query).
//   Same forms and row types as gather_score. The 16-byte path is chosen
//   from (dim, row type) alone, never from the block's address, so every
//   shard splits its rows across the warp as the unsharded kernel does.
//   Design: only owned lanes cost work. One block of 32 warps per (query,
//   chunk of up to 256 of its K lanes) reads the chunk's ids, zeroes the
//   lanes it does not own in one coalesced store, compacts the owned ones
//   into shared memory (warp ballots), and leaves at once if it owns none
//   (__syncthreads_count); otherwise it stages the query once and its
//   warps run score_row over the owned lanes. At K = 64 and S = 4 that is
//   B blocks, not 8B, each staging its query once, and every warp that
//   runs scores a row it owns.
//
// beam_merge — replaces repro/kernels/l2_topk.py:beam_merge_topk (Pallas
//   bodies _merge_kernel, _xor_permute), reached through
//   ops.merge_pool_batch. Per row: the best P of (pool ‖ candidates), the
//   pool's expanded flags riding along.
//   Bound: bytes (the row's ids, dists and flags read once, P of each
//   written).
//   Design: one block per row; each lane gets a 64-bit key (order-preserving
//   image of the f32 distance, input position), so the order is total and
//   stable: ids, dists and flags equal the stable oracle
//   ref.merge_pool_batch_ref, and an all-masked wave is an exact no-op.
//   The engine only ever hands in a sorted pool (it starts all +inf and
//   every later pool is this merge's output), so the block first checks
//   that the pool's keys are non-decreasing (__syncthreads_and). If they
//   are, only the K candidates are sorted (a bitonic network over the next
//   power of two, in one warp when that is <= 64 lanes), and every element
//   goes straight to its output rank: pool lane i to i + #(candidates below
//   it), sorted candidate j to j + #(pool keys below it), each count a
//   binary search of the other run; ranks >= P are dropped. That is O(P + K)
//   work and two block barriers. An unsorted pool (the public
//   beam_merge_topk takes any) runs the full bitonic network of
//   (pool ‖ candidates) padded to a power of two, in the same kernel: the
//   branch follows the data, so the function stays total.

#include <cuda_fp8.h>
#include <stdint.h>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // lanes (warps) per gather_score block
// gather_score_local: K lanes per block, scoring warps per block (twice
// the owned lanes of a K = 64 wave at S = 4, the sharded search's stage-2
// wave, so there a warp rarely scores two rows), and the ints of shared
// memory in front of the staged query (per-warp counts, then the compacted
// lanes and rows; 544 ints keep the query 16-byte aligned)
constexpr int kLocalLanes = 256;
constexpr int kLocalWarps = 32;
constexpr int kLocalSmemInts = kLocalWarps + 2 * kLocalLanes;

enum Metric { kL2 = 0, kSqEuclidean = 1, kIp = 2, kCosine = 3 };
enum RowType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kE4M3 = 4, kE5M2 = 5 };

// to_f of the quantized types (the float ones are in common.cuh)
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

template <bool MM, bool QUANT>
struct Acc {
  float a0 = 0.f;  // sum (q - r)^2 (reduce l2) or sum q*r
  float a1 = 0.f;  // sum r*r (reduce cosine)
  float a2 = 0.f;  // sum q*q (cosine, norm-cache l2)

  __device__ __forceinline__ void add(float q, float code, float zp,
                                      float scale, int metric) {
    float r = QUANT ? __fmul_rn(__fsub_rn(code, zp), scale) : code;
    if (!MM && (metric == kL2 || metric == kSqEuclidean)) {
      float d = __fsub_rn(q, r);
      a0 = __fmaf_rn(d, d, a0);
      return;
    }
    a0 = __fmaf_rn(q, r, a0);
    if (metric == kCosine || (MM && metric != kIp)) a2 = __fmaf_rn(q, q, a2);
    if (!MM && metric == kCosine) a1 = __fmaf_rn(r, r, a1);
  }
};

// The arguments of both gather kernels. n_rows is N for gather_score and
// n_local for the shard-local kernel, whose block starts at global row
// offset (0 for gather_score).
struct GatherArgs {
  const void* rows;
  const float* meta;
  int meta_cols;
  const float* queries;
  const int* ids;
  float* out;
  int B, K, n_rows, offset, dim, metric, vec;
};

// Stages query blockIdx.y in shared memory. Returns the flat index b*K + k
// of this warp's lane, or -1 for a warp past K.
__device__ __forceinline__ long long stage_query(const GatherArgs& a, float* q_s) {
  const int b = blockIdx.y;
  const float* qg = a.queries + static_cast<size_t>(b) * a.dim;
  for (int i = threadIdx.x; i < a.dim; i += blockDim.x) q_s[i] = qg[i];
  __syncthreads();
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  return k < a.K ? static_cast<long long>(b) * a.K + k : -1;
}

// The lane body both gather kernels share: one warp scores the staged query
// against row r of the block it was given. The value depends only on the
// query, the row and its metadata (fixed accumulation order, fixed xor
// tree, every rounding step explicit so the compiler contracts nothing), so
// an owned shard-local lane equals the gather_score lane bit for bit.
template <typename T, bool MM, bool QUANT>
__device__ __forceinline__ float score_row(const GatherArgs& a, const float* q_s,
                                           int r) {
  const int lane = threadIdx.x & 31;
  const int dim = a.dim, metric = a.metric;
  const float* m = (MM || QUANT) ? a.meta + static_cast<size_t>(r) * a.meta_cols
                                 : nullptr;
  const float scale = QUANT ? m[2] : 1.f;
  const float zp = QUANT ? m[3] : 0.f;
  const T* row = static_cast<const T*>(a.rows) + static_cast<size_t>(r) * dim;

  Acc<MM, QUANT> acc;
  if (a.vec) {
    constexpr int per = 16 / sizeof(T);
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    const int nvec = dim / per;
    for (int v = lane; v < nvec; v += 32) {
      const uint4 u = __ldg(rv + v);
      T e[per];
      memcpy(e, &u, sizeof(u));
#pragma unroll
      for (int j = 0; j < per; ++j)
        acc.add(q_s[v * per + j], to_f(e[j]), zp, scale, metric);
    }
  } else {
    for (int i = lane; i < dim; i += 32) acc.add(q_s[i], to_f(row[i]), zp, scale, metric);
  }
  const float a0 = warp_sum(acc.a0);
  const float a1 = warp_sum(acc.a1);
  const float a2 = warp_sum(acc.a2);

  if (!MM) {
    if (metric == kL2) return sqrtf(a0);
    if (metric == kSqEuclidean) return a0;
    if (metric == kIp) return -a0;
    return __fsub_rn(1.f, __fmul_rn(__fmul_rn(a0, rsqrtf(__fadd_rn(a2, 1e-12f))),
                                    rsqrtf(__fadd_rn(a1, 1e-12f))));
  }
  const float nsq = m[0], ninv = m[1];
  if (metric == kL2 || metric == kSqEuclidean) {
    // the expansion can dip below 0
    const float d = fmaxf(__fadd_rn(__fsub_rn(nsq, __fmul_rn(2.f, a0)), a2), 0.f);
    return metric == kL2 ? sqrtf(d) : d;
  }
  if (metric == kIp) return -a0;
  return __fsub_rn(1.f, __fmul_rn(__fmul_rn(a0, rsqrtf(__fadd_rn(a2, 1e-12f))), ninv));
}

template <typename T, bool MM, bool QUANT>
__global__ void gather_score_kernel(const GatherArgs a) {
  extern __shared__ float q_s[];
  const long long o = stage_query(a, q_s);
  if (o < 0) return;
  const int id = a.ids[o];
  const bool lead = (threadIdx.x & 31) == 0;
  if (id < 0 || id >= a.n_rows) {
    // padding -> +inf; an id past the corpus is a caller bug -> NaN
    if (lead) a.out[o] = id < 0 ? INFINITY : NAN;
    return;
  }
  const float d = score_row<T, MM, QUANT>(a, q_s, id);
  if (lead) a.out[o] = d;
}

// gather_score_local: lane owned iff 0 <= id - offset < n_local. An owned
// lane scores local row id - offset exactly as gather_score scores global
// row id (score_row); a foreign or padding lane writes +0.0 (the identity
// of the sum over shards) and loads no row, so the S launches of a wave
// read each gathered row once in total. Block (chunk c, query b) takes
// lanes [c * kLocalLanes, ..) of query b (the design: file header).
template <typename T, bool MM, bool QUANT>
__global__ void __launch_bounds__(kLocalWarps * 32)
gather_score_local_kernel(const GatherArgs a) {
  extern __shared__ float smem[];
  int* count_s = reinterpret_cast<int*>(smem);  // owned lanes per warp
  int* lane_s = count_s + kLocalWarps;          // owned lanes, in lane order
  int* row_s = lane_s + kLocalLanes;            // and their local rows
  float* q_s = smem + kLocalSmemInts;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const size_t o0 = static_cast<size_t>(blockIdx.y) * a.K;
  const int k = blockIdx.x * kLocalLanes + t;
  const bool mine = t < kLocalLanes && k < a.K;
  int r = -1;
  if (mine) {
    const int id = a.ids[o0 + k];
    r = id < 0 ? -1 : id - a.offset;  // offset >= 0: no overflow
  }
  const bool owned = r >= 0 && r < a.n_rows;
  if (mine && !owned) a.out[o0 + k] = 0.f;
  const unsigned ballot = __ballot_sync(0xffffffffu, owned);
  if (lane == 0) count_s[warp] = __popc(ballot);
  const int n_owned = __syncthreads_count(owned);
  if (n_owned == 0) return;
  if (owned) {
    int slot = __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) slot += count_s[w];
    lane_s[slot] = k;
    row_s[slot] = r;
  }
  const float* qg = a.queries + static_cast<size_t>(blockIdx.y) * a.dim;
  for (int i = t; i < a.dim; i += blockDim.x) q_s[i] = qg[i];
  __syncthreads();
  for (int j = warp; j < n_owned; j += kLocalWarps) {
    const float d = score_row<T, MM, QUANT>(a, q_s, row_s[j]);
    if (lane == 0) a.out[o0 + lane_s[j]] = d;
  }
}

template <bool LOCAL, typename T, bool MM, bool QUANT>
cudaError_t launch_gather_t(const GatherArgs& a, cudaStream_t stream) {
  if constexpr (LOCAL) {
    const dim3 grid((a.K + kLocalLanes - 1) / kLocalLanes, a.B);
    const size_t smem = (kLocalSmemInts + static_cast<size_t>(a.dim)) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(gather_score_local_kernel<T, MM, QUANT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    gather_score_local_kernel<T, MM, QUANT><<<grid, kLocalWarps * 32, smem, stream>>>(a);
  } else {
    const dim3 grid((a.K + kWarps - 1) / kWarps, a.B);
    const size_t smem = static_cast<size_t>(a.dim) * sizeof(float);
    gather_score_kernel<T, MM, QUANT><<<grid, kWarps * 32, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <bool LOCAL, typename T>
cudaError_t launch_gather_form(const GatherArgs& a, int matmul, cudaStream_t stream) {
  const bool quant = a.meta_cols == 4;
  if (matmul)
    return quant ? launch_gather_t<LOCAL, T, true, true>(a, stream)
                 : launch_gather_t<LOCAL, T, true, false>(a, stream);
  return quant ? launch_gather_t<LOCAL, T, false, true>(a, stream)
               : launch_gather_t<LOCAL, T, false, false>(a, stream);
}

template <bool LOCAL>
int launch_gather(const GatherArgs& a, int row_type, int matmul, void* stream) {
  if (a.B == 0 || a.K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case kF32: return launch_gather_form<LOCAL, float>(a, matmul, s);
    case kBF16: return launch_gather_form<LOCAL, __nv_bfloat16>(a, matmul, s);
    case kF16: return launch_gather_form<LOCAL, __half>(a, matmul, s);
    case kI8: return launch_gather_form<LOCAL, int8_t>(a, matmul, s);
    case kE4M3: return launch_gather_form<LOCAL, __nv_fp8_e4m3>(a, matmul, s);
    case kE5M2: return launch_gather_form<LOCAL, __nv_fp8_e5m2>(a, matmul, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// order-preserving image of an f32 distance: -0 folds onto +0 (they compare
// equal) and every NaN onto the largest key (after +inf)
__device__ __forceinline__ uint32_t dist_key(float d) {
  if (d != d) return 0xffffffffu;
  uint32_t u = __float_as_uint(d);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a lane past the real ones: after every real key, NaN included, in
// position order
constexpr unsigned long long kPadKey = 0xffffffffull << 32;

__device__ __forceinline__ unsigned long long merge_key(float d, int pos) {
  return (static_cast<unsigned long long>(dist_key(d)) << 32) | static_cast<uint32_t>(pos);
}

// ascending bitonic sort of a[0, n), n a power of two, by `lanes` threads
// numbered t; one warp (WARP) or the whole block syncs after each pass
template <bool WARP>
__device__ void bitonic_sort(unsigned long long* a, int n, int t, int lanes) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = t; p < (n >> 1); p += lanes) {
        const int i = 2 * j * (p / j) + (p % j);
        const int l = i + j;
        const bool up = (i & size) == 0;
        const unsigned long long x = a[i], y = a[l];
        if ((x > y) == up) {
          a[i] = y;
          a[l] = x;
        }
      }
      if (WARP) __syncwarp();
      else __syncthreads();
    }
  }
}

// #{i < n : a[i] < key} for ascending a
__device__ __forceinline__ int count_below(const unsigned long long* a, int n,
                                           unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void beam_merge_kernel(const int* __restrict__ pool_ids,
                                  const float* __restrict__ pool_dists,
                                  const uint8_t* __restrict__ pool_flags,
                                  const int* __restrict__ cand_ids,
                                  const float* __restrict__ cand_dists,
                                  int* __restrict__ out_ids,
                                  float* __restrict__ out_dists,
                                  uint8_t* __restrict__ out_flags, int P, int K,
                                  int k_pad, int n_pad) {
  extern __shared__ unsigned long long keys[];  // pool [0, P), candidates after
  unsigned long long* cand = keys + P;
  const size_t row = blockIdx.x;
  const int* pi = pool_ids + row * P;
  const float* pd = pool_dists + row * P;
  const uint8_t* pf = pool_flags ? pool_flags + row * P : nullptr;
  const int* ci = cand_ids + row * K;
  const float* cd = cand_dists + row * K;
  int* oi = out_ids + row * P;
  float* od = out_dists + row * P;
  uint8_t* of = out_flags ? out_flags + row * P : nullptr;

  bool sorted = true;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const uint32_t key = dist_key(pd[i]);
    keys[i] = (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(i);
    if (i > 0 && dist_key(pd[i - 1]) > key) sorted = false;
  }
  for (int j = threadIdx.x; j < k_pad; j += blockDim.x)
    cand[j] = j < K ? merge_key(cd[j], P + j) : (kPadKey | static_cast<uint32_t>(P + j));

  if (__syncthreads_and(sorted)) {
    if (k_pad <= 64) {
      if (threadIdx.x < 32) bitonic_sort<true>(cand, k_pad, threadIdx.x, 32);
    } else {
      bitonic_sort<false>(cand, k_pad, threadIdx.x, blockDim.x);
    }
    __syncthreads();
    // a candidate's position is above every pool position, so a candidate
    // lands before pool lane i only if its distance is strictly smaller
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
      const int r = i + count_below(cand, K, keys[i]);
      if (r < P) {
        oi[r] = pi[i];
        od[r] = pd[i];
        if (of) of[r] = pf ? pf[i] : 0;
      }
    }
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      const unsigned long long key = cand[j];
      const int r = j + count_below(keys, P, key);
      if (r < P) {
        const int c = static_cast<int>(key & 0xffffffffull) - P;
        oi[r] = ci[c];
        od[r] = cd[c];
        if (of) of[r] = 0;
      }
    }
    return;
  }

  // unsorted pool: the full network over n_pad lanes (P + K <= n_pad, so
  // every lane past n_pad is padding)
  for (int i = P + k_pad + threadIdx.x; i < n_pad; i += blockDim.x)
    keys[i] = kPadKey | static_cast<uint32_t>(i);
  __syncthreads();
  bitonic_sort<false>(keys, n_pad, threadIdx.x, blockDim.x);
  for (int t = threadIdx.x; t < P; t += blockDim.x) {
    const int pos = static_cast<int>(keys[t] & 0xffffffffull);
    if (pos < P) {
      oi[t] = pi[pos];
      od[t] = pd[pos];
      if (of) of[t] = pf ? pf[pos] : 0;
    } else {
      oi[t] = ci[pos - P];
      od[t] = cd[pos - P];
      if (of) of[t] = 0;
    }
  }
}

}  // namespace

extern "C" {

// rows: (N, dim) of row_type; meta: (N, meta_cols) f32 or null (meta_cols 0);
// queries (B, dim) f32; ids (B, K) i32; out (B, K) f32. vec: 16-byte row
// loads (dim a multiple of 16 / itemsize, rows 16-byte aligned). Returns the
// launch's cudaGetLastError().
int gather_score_launch(const void* rows, int row_type, const float* meta,
                        int meta_cols, int matmul, const float* queries,
                        const int* ids, float* out, int B, int K, int N, int dim,
                        int metric, int vec, void* stream) {
  return launch_gather<false>(
      GatherArgs{rows, meta, meta_cols, queries, ids, out, B, K, N, 0, dim, metric, vec},
      row_type, matmul, stream);
}

// The shard-local twin: rows/meta are the (n_local, ..) block of global rows
// [offset, offset + n_local); ids are global. Owned lanes -> the value
// gather_score_launch gives on the same row; every other lane -> 0.0.
int gather_score_local_launch(const void* rows, int row_type, const float* meta,
                              int meta_cols, int matmul, const float* queries,
                              const int* ids, float* out, int B, int K, int n_local,
                              int offset, int dim, int metric, int vec, void* stream) {
  return launch_gather<true>(
      GatherArgs{rows, meta, meta_cols, queries, ids, out, B, K, n_local, offset, dim,
                 metric, vec},
      row_type, matmul, stream);
}

// pool (B, P) ids/dists/flags (flags nullable), cand (B, K) ids/dists;
// out (B, P) ids/dists/flags (flags nullable). n_pad: power of two >= P + K.
// Shared memory: max(n_pad, P + k_pad) 8-byte keys, k_pad the power of two
// >= K (the wrapper checks that against MAX_MERGE_PAD).
int beam_merge_launch(const int* pool_ids, const float* pool_dists,
                      const uint8_t* pool_flags, const int* cand_ids,
                      const float* cand_dists, int* out_ids, float* out_dists,
                      uint8_t* out_flags, int B, int P, int K, int n_pad,
                      void* stream) {
  if (B == 0 || P == 0) return 0;
  int k_pad = 1;
  while (k_pad < K) k_pad <<= 1;
  const int lanes = n_pad > P + k_pad ? n_pad : P + k_pad;
  const size_t smem = static_cast<size_t>(lanes) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        beam_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int threads = n_pad / 2;
  if (threads < 32) threads = 32;
  if (threads > 512) threads = 512;
  beam_merge_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      pool_ids, pool_dists, pool_flags, cand_ids, cand_dists, out_ids, out_dists,
      out_flags, P, K, k_pad, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
