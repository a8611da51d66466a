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
//
// beam_merge — replaces repro/kernels/l2_topk.py:beam_merge_topk (Pallas
//   bodies _merge_kernel, _xor_permute), reached through
//   ops.merge_pool_batch. Per row: sort (pool ‖ candidates), keep the best P,
//   the pool's expanded flags riding along.
//   Bound: bytes (the row's ids, dists and flags read once, P written);
//   the sort is O(n log^2 n) compare-exchanges in shared memory.
//   Design: one block per row; 64-bit keys (order-preserving image of the
//   f32 distance, input position) in dynamic shared memory, bitonic network
//   padded to a power of two with keys that sort after every real lane.
//   Ordering by position makes the merge stable: ids, dists and flags equal
//   the stable oracle ref.merge_pool_batch_ref, and an all-masked wave is an
//   exact no-op. No 128-lane padding (that was the TPU's vector width).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <cstring>

namespace {

constexpr int kWarps = 8;  // lanes (warps) per gather block

enum Metric { kL2 = 0, kSqEuclidean = 1, kIp = 2, kCosine = 3 };
enum RowType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kE4M3 = 4, kE5M2 = 5 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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
// row id; a foreign or padding lane writes 0.0 (the identity of the sum
// over shards) and loads no row, so the S launches of a wave read each
// gathered row once in total.
template <typename T, bool MM, bool QUANT>
__global__ void gather_score_local_kernel(const GatherArgs a) {
  extern __shared__ float q_s[];
  const long long o = stage_query(a, q_s);
  if (o < 0) return;
  const int id = a.ids[o];
  const int r = id < 0 ? -1 : id - a.offset;  // offset >= 0: no overflow
  const bool lead = (threadIdx.x & 31) == 0;
  if (r < 0 || r >= a.n_rows) {
    if (lead) a.out[o] = 0.f;
    return;
  }
  const float d = score_row<T, MM, QUANT>(a, q_s, r);
  if (lead) a.out[o] = d;
}

template <bool LOCAL, typename T, bool MM, bool QUANT>
cudaError_t launch_gather_t(const GatherArgs& a, cudaStream_t stream) {
  dim3 grid((a.K + kWarps - 1) / kWarps, a.B);
  size_t smem = static_cast<size_t>(a.dim) * sizeof(float);
  if constexpr (LOCAL)
    gather_score_local_kernel<T, MM, QUANT><<<grid, kWarps * 32, smem, stream>>>(a);
  else
    gather_score_kernel<T, MM, QUANT><<<grid, kWarps * 32, smem, stream>>>(a);
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

__global__ void beam_merge_kernel(const int* __restrict__ pool_ids,
                                  const float* __restrict__ pool_dists,
                                  const uint8_t* __restrict__ pool_flags,
                                  const int* __restrict__ cand_ids,
                                  const float* __restrict__ cand_dists,
                                  int* __restrict__ out_ids,
                                  float* __restrict__ out_dists,
                                  uint8_t* __restrict__ out_flags, int P, int K,
                                  int n_pad) {
  extern __shared__ unsigned long long keys[];
  const size_t row = blockIdx.x;
  const int n = P + K;
  const int* pi = pool_ids + row * P;
  const float* pd = pool_dists + row * P;
  const int* ci = cand_ids + row * K;
  const float* cd = cand_dists + row * K;

  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    uint32_t key;
    if (i < P) key = dist_key(pd[i]);
    else if (i < n) key = dist_key(cd[i - P]);
    else key = 0xffffffffu;  // padding: position i >= n sorts after NaNs too
    keys[i] = (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(i);
  }
  __syncthreads();

  const int half = n_pad >> 1;
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = 2 * j * (p / j) + (p % j);
        const int l = i + j;
        const bool up = (i & size) == 0;
        const unsigned long long a = keys[i], c = keys[l];
        if ((a > c) == up) {
          keys[i] = c;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
  }

  int* oi = out_ids + row * P;
  float* od = out_dists + row * P;
  for (int t = threadIdx.x; t < P; t += blockDim.x) {
    const int pos = static_cast<int>(keys[t] & 0xffffffffull);
    if (pos < P) {
      oi[t] = pi[pos];
      od[t] = pd[pos];
      if (out_flags) out_flags[row * P + t] = pool_flags ? pool_flags[row * P + pos] : 0;
    } else {
      oi[t] = ci[pos - P];
      od[t] = cd[pos - P];
      if (out_flags) out_flags[row * P + t] = 0;
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
int beam_merge_launch(const int* pool_ids, const float* pool_dists,
                      const uint8_t* pool_flags, const int* cand_ids,
                      const float* cand_dists, int* out_ids, float* out_dists,
                      uint8_t* out_flags, int B, int P, int K, int n_pad,
                      void* stream) {
  if (B == 0 || P == 0) return 0;
  const size_t smem = static_cast<size_t>(n_pad) * sizeof(unsigned long long);
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
      out_flags, P, K, n_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
