// K-a: the 5-point variable-coefficient stencil A·w for Hopper (sm_90a).
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py:_stencil_kernel
// (launched by apply_a_block_pallas / apply_a_pallas), the TPU form of the
// reference's stage-4 apply_A_kernel (poisson_mpi_cuda2.cu:507-536).
//
// Computes, for every owned node of a halo-extended (bm+2, bn+2) block,
//   ax = -(a[i+1,j]*(w[i+1,j]-w[i,j])/h1 - a[i,j]*(w[i,j]-w[i-1,j])/h1)/h1
//   ay = -(b[i,j+1]*(w[i,j+1]-w[i,j])/h2 - b[i,j]*(w[i,j]-w[i,j-1])/h2)/h2
//   out = ax + ay
// term for term in the reference's order (each difference divided by h
// before the terms are combined). Built with -fmad=false, so no product is
// contracted into an FMA and the result is bitwise the plain PyTorch
// version's on the same card.
//
// What bounds it: bytes. Per node it reads w, a, b once and writes one
// value (4 array passes); at 2401x3201 f32 that is 123 MB, 36.7 us at
// 3.35 TB/s. The arithmetic (6 divisions, 12 other flops) is far below the
// card's rate.
//
// Design: one thread per output node, 32x8 blocks with threadIdx.x along
// the contiguous column axis, so each warp reads and writes whole 128-byte
// rows. Neighbour values come from L1/L2: the rows above and below were
// just read by the neighbouring warps. The TPU kernel's aligned (TM+8)-row
// DMA windows and its (8,128) padding have no counterpart here: the
// kernel indexes the unpadded arrays directly and masks the ragged edge.
//
// Layouts: with pad == 0 the output is the (bm, bn) block; with pad == 1
// it is the full (bm+2, bn+2) grid with a zero ring (apply_a_pallas's
// jnp.pad), written by the kernel itself so no second pass is needed.
//
// K-e, the lane-batched form, is this kernel with the lane on gridDim.z:
// A·w for B lanes of w with lane-shared a and b, so lane l of the output is
// K-a on lane l by construction.
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py:_batched_stencil_kernel
// (launched by apply_a_batched_block_pallas / apply_a_batched_pallas), the
// batched engines' stencil (poisson_ellipse_tpu/batch/batched_pcg.py:280-296).
//
// What bounds it: bytes. Read a and b once and each lane's w and out once:
// (2 + 2B) passes of one lane's grid; at 401x601 f32 with B = 32 that is
// 66 passes of 0.964 MB, 19.0 us at 3.35 TB/s. Each lane's blocks read a
// and b again, but after the first lane they come from L2 (the pair is
// 1.9 MB at 401x601, 7.7 MB at 801x1201, both inside the 50 MB L2).
//
// K-g, the mixed-precision form, is this kernel with typed loads: w in the
// storage type (bf16 or f16) or f32, a and b in the storage type, out f32.
// Each load is upcast with __bfloat162float / __half2float, which are
// exact, and the arithmetic is K-a's in f32, so a narrow input gives bit
// for bit what K-a gives on the upcast input.
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py:_stencil_kernel_mixed
// (launched by apply_a_block_mixed_pallas / apply_a_mixed_pallas), the
// storage-axis stencil of the pallas loop, of pipelined-pallas's rebuilds
// and of sstep-pallas's basis chain.
//
// What bounds it: bytes. Per node it reads w, a, b once at their widths and
// writes one f32: 10 B with w narrow, 12 B with w f32; at 2401x3201 that is
// 76.9 MB (22.9 us at 3.35 TB/s) and 92.2 MB (27.5 us).
//
// Design: K-a's. The TPU kernel's storage-width DMA windows and their
// (8,128) padding have no counterpart: each thread loads its narrow values
// and widens them in registers.

#include <cuda_runtime.h>
#include <cstdint>

#include "storage.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// TW: the type of w; TC: the type of a and b (float for K-a and K-e)
template <typename TW, typename TC>
__global__ void stencil_kernel(const TW* __restrict__ w,
                               const TC* __restrict__ a,
                               const TC* __restrict__ b,
                               float* __restrict__ out, int bm, int bn,
                               int pad, float h1, float h2) {
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  const int oj = blockIdx.x * blockDim.x + threadIdx.x;
  const int oi = blockIdx.y * blockDim.y + threadIdx.y;
  if (oi >= om || oj >= on) return;
  // this block's lane (0 in a one-lane launch): its slice of w and out
  w += blockIdx.z * (int64_t)(bm + 2) * (bn + 2);
  out += blockIdx.z * (int64_t)om * on;
  const int i = oi - pad;
  const int j = oj - pad;
  float val = 0.0f;
  if (i >= 0 && i < bm && j >= 0 && j < bn) {
    const int64_t ld = bn + 2;
    const int64_t c = (int64_t)(i + 1) * ld + (j + 1);
    const float wc = up(w[c]);
    const float ax = -(up(a[c + ld]) * (up(w[c + ld]) - wc) / h1
                       - up(a[c]) * (wc - up(w[c - ld])) / h1) / h1;
    const float ay = -(up(b[c + 1]) * (up(w[c + 1]) - wc) / h2
                       - up(b[c]) * (wc - up(w[c - 1])) / h2) / h2;
    val = ax + ay;
  }
  out[(int64_t)oi * on + oj] = val;
}

template <typename TW, typename TC>
int launch(const TW* w, const TC* a, const TC* b, float* out, int lanes,
           int bm, int bn, int pad, float h1, float h2, void* stream) {
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((on + kBlockX - 1) / kBlockX, (om + kBlockY - 1) / kBlockY,
            lanes);
  stencil_kernel<TW, TC><<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      w, a, b, out, bm, bn, pad, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int pe_stencil_f32(const float* w, const float* a, const float* b, float* out,
                   int bm, int bn, int pad, float h1, float h2, void* stream) {
  return launch(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

// K-e: w (lanes, bm+2, bn+2), a and b (bm+2, bn+2) shared by every lane,
// out (lanes, bm+2*pad, bn+2*pad).
int pe_batched_stencil_f32(const float* w, const float* a, const float* b,
                           float* out, int lanes, int bm, int bn, int pad,
                           float h1, float h2, void* stream) {
  if (lanes < 1 || lanes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(w, a, b, out, lanes, bm, bn, pad, h1, h2, stream);
}

// K-g: w (bm+2, bn+2) in the storage type or f32, a and b (bm+2, bn+2) in
// the storage type, out (bm+2*pad, bn+2*pad) f32.
int pe_stencil_mixed_bf16_bf16(const __nv_bfloat16* w,
                               const __nv_bfloat16* a,
                               const __nv_bfloat16* b, float* out, int bm,
                               int bn, int pad, float h1, float h2,
                               void* stream) {
  return launch(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

int pe_stencil_mixed_f32_bf16(const float* w, const __nv_bfloat16* a,
                              const __nv_bfloat16* b, float* out, int bm,
                              int bn, int pad, float h1, float h2,
                              void* stream) {
  return launch(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

int pe_stencil_mixed_f16_f16(const __half* w, const __half* a,
                             const __half* b, float* out, int bm, int bn,
                             int pad, float h1, float h2, void* stream) {
  return launch(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

int pe_stencil_mixed_f32_f16(const float* w, const __half* a,
                             const __half* b, float* out, int bm, int bn,
                             int pad, float h1, float h2, void* stream) {
  return launch(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

const char* pe_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
