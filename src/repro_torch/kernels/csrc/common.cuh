// Device helpers shared by the kernels in this directory: the conversion of
// an element to f32, a raw zero of each type, the rounding store of an f32
// result, 2^x on the special-function unit, two f32 values packed as a
// 16-bit pair (a register operand of wgmma), and a warp sum. Included by
// each .cu; _build.py hashes this header into every library's cache key, so
// an edit here rebuilds them all.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
