// Hopper (sm_90a) embedding-bag kernel, with a plain C interface for ctypes
// (see repro_torch/kernels/_build.py and embedding_bag.py).
//
// embedding_bag — replaces repro/kernels/embedding_bag.py:embedding_bag
//   (Pallas body _bag_kernel), reached through ops.embedding_bag. Per bag b:
//   the sum of table[idx[b, l]] over the bag's ids >= 0, or that sum over
//   max(count, 1) for the mean. Ids < 0 are pads that add 0. f32
//   accumulation, output in the table's dtype. An id >= V is a caller
//   error: its bag comes out NaN and no row outside the table is read.
//   Bound: bytes. Each valid id reads one row (D * itemsize bytes), the bag
//   reads its L ids and writes one row; one add per element read. Rows are
//   read at random, in whole 32-byte sectors (a 72-byte DIN row spans
//   three); a table past the 50 MB L2 (DIN's is 75.5 MB) serves most of
//   them from HBM, so the time is set by row loads in flight and HBM, not
//   by the arithmetic.
//   Design, from embedding_bag.bag_plan (the shapes and the table's
//   alignment alone, so a launch never waits on the card):
//   - Lane groups sized to the row. A lane loads VW bytes at once, the
//     widest of 16, 8, 4, 2 that divides the row stride and the table's
//     base; G = row_bytes / VW lanes read one row and a warp reads
//     R = 32 / G rows per pass (D = 18 f32: 8-byte loads, G = 9, R = 3).
//     Rows wider than 32 * VW bytes loop over column chunks of 32 lanes.
//   - Rows in flight. A warp reads up to kIdChunk of its ids at once
//     (coalesced, streaming), compacts the valid ones into shared memory in
//     bag order (ballots), then issues kPasses passes of row loads through
//     the read-only path before its first add: R * kPasses rows in flight
//     per warp (24 at D = 18), and pads cost no pass.
//   - The work split. One block per bag, of W warps: W = 1 when the bags
//     fill the card (DIN train_batch, B = 65,536), else 2, 4 or 8 (B = 512:
//     4), warp w taking ids [w * S, (w + 1) * S), S = ceil(L / W), their
//     partial sums meeting in shared memory. Small blocks also balance the
//     card: a block frees its SM's slot as soon as its own bag is done, not
//     when the longest of several bags in it is.
//   - A fixed order. A group adds its rows in list order, the R groups fold
//     by a fixed tree of shuffles, the W warps add in warp order: two calls
//     give the same bits.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;   // warps per bag (and block)
constexpr int kIdChunk = 128;  // ids a warp stages at once, four a lane
constexpr int kPasses = 8;     // passes of row loads issued before the first add

enum TableType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// VW raw bytes of a row held as 32-bit words (the low half of one word for
// VW = 2), element 0 in the low bits
template <int VW> struct Words { unsigned w[VW >= 4 ? VW / 4 : 1]; };

template <int VW> __device__ __forceinline__ Words<VW> load_row(const char* p);
template <> __device__ __forceinline__ Words<16> load_row<16>(const char* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return {{v.x, v.y, v.z, v.w}};
}
template <> __device__ __forceinline__ Words<8> load_row<8>(const char* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return {{v.x, v.y}};
}
template <> __device__ __forceinline__ Words<4> load_row<4>(const char* p) {
  return {{__ldg(reinterpret_cast<const unsigned*>(p))}};
}
template <> __device__ __forceinline__ Words<2> load_row<2>(const char* p) {
  return {{static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))}};
}

template <int VW> __device__ __forceinline__ void store_row(char* p, const Words<VW>& r);
template <> __device__ __forceinline__ void store_row<16>(char* p, const Words<16>& r) {
  *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
}
template <> __device__ __forceinline__ void store_row<8>(char* p, const Words<8>& r) {
  *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
}
template <> __device__ __forceinline__ void store_row<4>(char* p, const Words<4>& r) {
  *reinterpret_cast<unsigned*>(p) = r.w[0];
}
template <> __device__ __forceinline__ void store_row<2>(char* p, const Words<2>& r) {
  *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(r.w[0]);
}

// element i of a lane's raw bytes, as f32
template <typename T> __device__ __forceinline__ float elem(const unsigned* w, int i);
template <> __device__ __forceinline__ float elem<float>(const unsigned* w, int i) {
  return __uint_as_float(w[i]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const unsigned* w, int i) {
  const unsigned x = w[i >> 1];
  return __uint_as_float(i & 1 ? x & 0xffff0000u : x << 16);
}
template <> __device__ __forceinline__ float elem<__half>(const unsigned* w, int i) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w[i >> 1] >> (16 * (i & 1)))));
}

// the raw bits of an f32 rounded to nearest into T (in the low bits)
__device__ __forceinline__ unsigned bits_of(float x, float*) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned bits_of(float x, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned bits_of(float x, __half*) {
  return __half_as_ushort(__float2half_rn(x));
}

template <typename T, int VW>
__global__ void __launch_bounds__(kMaxWarps * 32)
embedding_bag_kernel(const char* __restrict__ table, const int* __restrict__ idx,
                     char* __restrict__ out, int L, int V, int row_bytes, int G, int mean) {
  constexpr int E = VW / static_cast<int>(sizeof(T));  // elements a lane loads
  constexpr unsigned kAll = 0xffffffffu;
  const int W = blockDim.x >> 5;  // the bag's warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // dynamic shared memory: each warp's staged ids, then, when W > 1, each
  // warp's partial row (E x 32 floats), count and bad flag
  extern __shared__ int smem[];
  int* list = smem + warp * kIdChunk;
  float(*part)[E][32] = reinterpret_cast<float(*)[E][32]>(smem + W * kIdChunk);
  int* part_count = reinterpret_cast<int*>(part + W);
  int* part_bad = part_count + W;

  const int bag = blockIdx.x;
  const int nvec = row_bytes / VW;
  const int R = 32 / G, g = lane / G, sub = lane - g * G;
  const int top = R > 1 ? 1 << (31 - __clz(R - 1)) : 0;  // largest power of 2 < R
  const long long S = (static_cast<long long>(L) + W - 1) / W;  // ids a warp
  const long long lo = min(warp * S, static_cast<long long>(L));
  const long long hi = min(lo + S, static_cast<long long>(L));
  const int* ids = idx + static_cast<size_t>(bag) * L;
  const unsigned below = (1u << lane) - 1u;

  for (int c0 = 0; c0 < nvec; c0 += 32) {  // column chunks, block-uniform
    const int col = c0 + sub;
    const bool reads = g < R && col < nvec;
    float acc[E];
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = 0.f;
    int count = 0;
    bool bad = false;
    for (long long base = lo; base < hi; base += kIdChunk) {
      int mine[kIdChunk / 32];  // all four id loads issue before the ballots
#pragma unroll
      for (int k = 0; k < kIdChunk / 32; ++k) {
        const long long l = base + k * 32 + lane;
        // streaming when read once; a row of several column chunks reads its
        // ids once per chunk, and keeps them cached
        mine[k] = l < hi ? (nvec <= 32 ? __ldcs(ids + l) : __ldg(ids + l)) : -1;
      }
      int n = 0;  // valid ids staged, warp-uniform
#pragma unroll
      for (int k = 0; k < kIdChunk / 32; ++k) {
        const int id = mine[k];
        const bool ok = id >= 0 && id < V;
        const unsigned valid = __ballot_sync(kAll, ok);
        count += __popc(__ballot_sync(kAll, id >= 0));
        bad |= __any_sync(kAll, id >= V);
        if (ok) list[n + __popc(valid & below)] = id;
        n += __popc(valid);
      }
      __syncwarp();
      for (int j = 0; j < n; j += R * kPasses) {
        Words<VW> r[kPasses];  // a pass past the list loads nothing and adds 0
#pragma unroll
        for (int u = 0; u < kPasses; ++u) {
          const int k = j + u * R + g;
          r[u] = Words<VW>{};
          if (reads && k < n)
            r[u] = load_row<VW>(table + static_cast<size_t>(list[k]) * row_bytes +
                                static_cast<size_t>(col) * VW);
        }
#pragma unroll
        for (int u = 0; u < kPasses; ++u)
#pragma unroll
          for (int i = 0; i < E; ++i) acc[i] = __fadd_rn(acc[i], elem<T>(r[u].w, i));
      }
      __syncwarp();  // the list is read before the next chunk overwrites it
    }
    // fold the R groups into group 0: a fixed tree
    for (int s = top; s > 0; s >>= 1) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float v = __shfl_down_sync(kAll, acc[i], s * G);
        if (g < s && g + s < R) acc[i] = __fadd_rn(acc[i], v);
      }
    }
    if (W > 1) {  // the bag's warps add in warp order
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < E; ++i) part[warp][i][sub] = acc[i];
      }
      if (lane == 0) {
        part_count[warp] = count;
        part_bad[warp] = bad;
      }
      __syncthreads();
      if (warp == 0 && g == 0) {
        for (int w = 1; w < W; ++w) {
#pragma unroll
          for (int i = 0; i < E; ++i) acc[i] = __fadd_rn(acc[i], part[w][i][sub]);
          count += part_count[w];
          bad |= part_bad[w] != 0;
        }
      }
      __syncthreads();  // read before the next column chunk writes
    }
    if (warp == 0 && g == 0 && col < nvec) {
      const float div = fmaxf(static_cast<float>(count), 1.f);
      Words<VW> res = {};
#pragma unroll
      for (int i = 0; i < E; ++i) {
        float val = acc[i];
        if (bad) val = NAN;
        else if (mean) val = __fdiv_rn(val, div);
        res.w[i * sizeof(T) / 4] |= bits_of(val, static_cast<T*>(nullptr))
                                    << (8 * ((i * sizeof(T)) & 3));
      }
      store_row<VW>(out + static_cast<size_t>(bag) * row_bytes + static_cast<size_t>(col) * VW,
                    res);
    }
  }
}

template <typename T, int VW>
cudaError_t launch_vw(const void* table, const int* idx, void* out, int B, int L, int V,
                      int row_bytes, int G, int W, int mean, cudaStream_t stream) {
  constexpr int E = VW / static_cast<int>(sizeof(T));
  const size_t smem_bytes = W * kIdChunk * sizeof(int) + (W > 1 ? W * (E * 32 + 2) * 4 : 0);
  embedding_bag_kernel<T, VW><<<B, 32 * W, smem_bytes, stream>>>(
      static_cast<const char*>(table), idx, static_cast<char*>(out), L, V, row_bytes, G, mean);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* table, const int* idx, void* out, int B, int L, int V,
                     int row_bytes, int width, int G, int W, int mean, cudaStream_t s) {
  switch (width) {
    case 16: return launch_vw<T, 16>(table, idx, out, B, L, V, row_bytes, G, W, mean, s);
    case 8: return launch_vw<T, 8>(table, idx, out, B, L, V, row_bytes, G, W, mean, s);
    case 4: return launch_vw<T, 4>(table, idx, out, B, L, V, row_bytes, G, W, mean, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_vw<T, 2>(table, idx, out, B, L, V, row_bytes, G, W, mean, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// table (V, D) of table_type; idx (B, L) i32 (< 0 pads); out (B, D) of
// table_type. mean: divide each bag by max(count of ids >= 0, 1). The plan
// (embedding_bag.bag_plan): width bytes a lane loads, G lanes a row
// (min(row / width, 32)), W warps a bag (1, 2, 4 or 8); one block a bag.
// A plan the kernel cannot run (a width that does not divide the row or the
// table's or out's address, another G or W) launches nothing and returns
// cudaErrorInvalidValue; else the launch's cudaGetLastError().
int embedding_bag_launch(const void* table, int table_type, const int* idx, void* out,
                         int B, int L, int V, int D, int width, int G, int W, int mean,
                         void* stream) {
  if (table_type < kF32 || table_type > kF16) return static_cast<int>(cudaErrorInvalidValue);
  const int item = table_type == kF32 ? 4 : 2;
  const long long row = static_cast<long long>(D) * item;
  const bool fits = (width == 16 || width == 8 || width == 4 || width == 2) && width >= item &&
                    row > 0 && row <= INT32_MAX && row % width == 0 &&
                    reinterpret_cast<uintptr_t>(table) % width == 0 &&
                    reinterpret_cast<uintptr_t>(out) % width == 0 &&
                    G == (row / width < 32 ? row / width : 32) &&
                    (W == 1 || W == 2 || W == 4 || W == kMaxWarps) && B > 0 && L >= 0 && V > 0;
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = static_cast<int>(row);
  switch (table_type) {
    case kF32:
      return static_cast<int>(launch_t<float>(table, idx, out, B, L, V, rb, width, G, W, mean, s));
    case kBF16:
      return static_cast<int>(
          launch_t<__nv_bfloat16>(table, idx, out, B, L, V, rb, width, G, W, mean, s));
    default:
      return static_cast<int>(launch_t<__half>(table, idx, out, B, L, V, rb, width, G, W, mean, s));
  }
}

}  // extern "C"
