// Hopper (sm_90a) embedding-bag kernel, with a plain C interface for ctypes
// (see repro_torch/kernels/_build.py and embedding_bag.py).
//
// embedding_bag — replaces repro/kernels/embedding_bag.py:embedding_bag
//   (Pallas body _bag_kernel), reached through ops.embedding_bag. Per bag b:
//   the sum of table[idx[b, l]] over the bag's ids >= 0, or that sum over
//   max(count, 1) for the mean. Ids < 0 are pads that add 0. f32
//   accumulation in bag order, output in the table's dtype.
//   Bound: bytes. Each valid id reads one row (D * itemsize bytes), the bag
//   reads its L ids and writes one row; one add per element read.
//   Design: one warp per bag, its lanes over the row's columns (chunks of 32
//   when D > 32). A row of D = 18 f32 (DIN's width, 72 bytes) is not 16-byte
//   aligned, so the loads are scalar: one coalesced request per row. The
//   warp reads 32 ids at a time, one per lane, and broadcasts them by
//   shuffle; four rows are loaded before they are added, so several loads
//   are in flight per warp. An id >= V is a caller error: its bag comes out
//   NaN and no row outside the table is read.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // bags per block
constexpr int kUnroll = 4;  // rows in flight per warp

enum TableType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
__global__ void embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                     T* __restrict__ out, int B, int L, int V, int D,
                                     int mean) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= B) return;  // warp-uniform
  const int* ids = idx + static_cast<size_t>(bag) * L;
  T* o = out + static_cast<size_t>(bag) * D;
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < D;
    float acc = 0.f;
    int count = 0;
    bool bad = false;
    for (int l0 = 0; l0 < L; l0 += 32) {
      // ids past L read as pads
      const int mine = l0 + lane < L ? __ldg(ids + l0 + lane) : -1;
      const int n = min(32, L - l0);
      for (int j = 0; j < n; j += kUnroll) {  // j + u <= 31
        T r[kUnroll];  // a pad or a lane past D loads a zero, converted after
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int id = __shfl_sync(0xffffffffu, mine, j + u);
          count += id >= 0;
          bad |= id >= V;
          const bool live = id >= 0 && id < V && col;
          r[u] = live ? table[static_cast<size_t>(id) * D + c] : zero<T>();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, to_f(r[u]));
      }
    }
    if (col) {
      float val = acc;
      if (bad) val = NAN;
      else if (mean) val = __fdiv_rn(val, fmaxf(static_cast<float>(count), 1.f));
      store(o + c, val);
    }
  }
}

template <typename T>
cudaError_t launch_t(const void* table, const int* idx, void* out, int B, int L, int V,
                     int D, int mean, cudaStream_t stream) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  embedding_bag_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), B, L, V, D, mean);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table (V, D) of table_type; idx (B, L) i32 (< 0 pads); out (B, D) of
// table_type. mean: divide each bag by max(count of ids >= 0, 1). Returns
// the launch's cudaGetLastError().
int embedding_bag_launch(const void* table, int table_type, const int* idx, void* out,
                         int B, int L, int V, int D, int mean, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_type) {
    case kF32: return static_cast<int>(launch_t<float>(table, idx, out, B, L, V, D, mean, s));
    case kBF16:
      return static_cast<int>(launch_t<__nv_bfloat16>(table, idx, out, B, L, V, D, mean, s));
    case kF16: return static_cast<int>(launch_t<__half>(table, idx, out, B, L, V, D, mean, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
