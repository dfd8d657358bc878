// The dtype axes of the port's kernels.
//
// Storage (poisson_ellipse_tpu_torch/ops/precision.py): the exact upcast
// of a stored value to f32, for kernels that read narrow arrays. bf16 and
// f16 are subsets of f32, so each conversion is exact and a kernel that
// widens its loads computes, bit for bit, what its f32 form computes on the
// upcast arrays.
//
// Compute: a kernel templated on its compute type TC keeps every value in
// a float register and rounds a value to TC (rn<TC>) where it stores it
// (ops/whole_solve.py:rounder). rn<float> is the identity, so the float
// instantiation compiles to the arithmetic of the untemplated kernel.
// down<TC> converts to TC with the same rounding: exact on a value rn<TC>
// has already rounded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

__device__ __forceinline__ float up(float x) { return x; }
__device__ __forceinline__ float up(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float up(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ float rn(float x);
template <>
__device__ __forceinline__ float rn<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rn<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T down(float x);
template <>
__device__ __forceinline__ float down<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 down<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
