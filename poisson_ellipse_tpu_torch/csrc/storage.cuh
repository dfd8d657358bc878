// The exact upcast of a stored value to f32, for kernels that read the
// storage axis's narrow arrays (poisson_ellipse_tpu_torch/ops/precision.py):
// bf16 and f16 are subsets of f32, so each conversion is exact and a kernel
// that widens its loads computes, bit for bit, what its f32 form computes
// on the upcast arrays.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

__device__ __forceinline__ float up(float x) { return x; }
__device__ __forceinline__ float up(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float up(__half x) { return __half2float(x); }
