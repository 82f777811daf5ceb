// Shared helpers of the port's kernels: I/O type <-> accumulation type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace prfdd {

// bf16 and f32 fields accumulate in f32, f64 fields in f64.
template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

template <typename Acc> __device__ __forceinline__ Acc to_acc(__nv_bfloat16 v) {
  return static_cast<Acc>(__bfloat162float(v));
}
template <typename Acc> __device__ __forceinline__ Acc to_acc(float v) {
  return static_cast<Acc>(v);
}
template <typename Acc> __device__ __forceinline__ Acc to_acc(double v) {
  return static_cast<Acc>(v);
}

__device__ __forceinline__ void store_io(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_io(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_io(double* p, double v) { *p = v; }

// Round-to-nearest add and multiply that the compiler may not contract
// into an FMA: K2 must round exactly where its plain twin rounds.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// dtype codes of the C interface (ops/kernels.py _CODE)
enum DType { kBF16 = 0, kF32 = 1, kF64 = 2 };

}  // namespace prfdd
