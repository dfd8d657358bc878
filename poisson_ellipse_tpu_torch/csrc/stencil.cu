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

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void stencil_kernel(const float* __restrict__ w,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
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
    const float wc = w[c];
    const float ax = -(a[c + ld] * (w[c + ld] - wc) / h1
                       - a[c] * (wc - w[c - ld]) / h1) / h1;
    const float ay = -(b[c + 1] * (w[c + 1] - wc) / h2
                       - b[c] * (wc - w[c - 1]) / h2) / h2;
    val = ax + ay;
  }
  out[(int64_t)oi * on + oj] = val;
}

int launch(const float* w, const float* a, const float* b, float* out,
           int lanes, int bm, int bn, int pad, float h1, float h2,
           void* stream) {
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((on + kBlockX - 1) / kBlockX, (om + kBlockY - 1) / kBlockY,
            lanes);
  stencil_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
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

const char* pe_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
