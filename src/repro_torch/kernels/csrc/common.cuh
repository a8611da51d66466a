// Device helpers shared by the kernels in this directory: the conversion of
// an element to f32, a raw zero of each type, the rounding store of an f32
// result, and a warp sum. Included by each .cu; _build.py hashes this header
// into every library's cache key, so an edit here rebuilds them all.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// a masked element is loaded as a raw zero of its type and converted after
// the load: a conversion inside the condition would make each load be waited
// for before the next one issues
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}
template <> __device__ __forceinline__ __half zero<__half>() { return __ushort_as_half(0); }

// an f32 result rounded to nearest into the output's type
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) { *o = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* o, float x) { *o = __float2half_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
