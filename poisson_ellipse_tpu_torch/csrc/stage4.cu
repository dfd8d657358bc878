// The reference's stage-4 vector kernels for Hopper (sm_90a): z = r/D, the
// weighted dot product, the fused w/r update with its step norm, and the
// direction update.
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py
//   _dinv_kernel      (apply_dinv_pallas, pallas_call at :570)
//   _dot_kernel       (dot_pallas, :610)
//   _update_wr_kernel (update_w_r_pallas, :662)
//   _update_p_kernel  (update_p_pallas, :699)
// the TPU forms of the reference's apply_Dinv_kernel, dot_kernel,
// update_w_r_kernel and update_p_kernel (poisson_mpi_cuda2.cu:541-676).
//
// Computes, over every node of a (g1, g2) grid, in T (float or double):
//   dinv:       z = d != 0 ? r / d : 0
//   dot:        out = (T)(sum x*y) * h1 * h2
//   update_w_r: w_new = w + alpha*p;  r_new = r - alpha*ap;
//               dw2 = (T)(sum (w_new - w)^2)   (unweighted)
//   update_p:   p_new = z + beta*p
// alpha and beta are 0-d device tensors read through a pointer, as the TPU
// kernels read them from SMEM: the host never reads them back. Built with
// -fmad=false, so a*b + c is a rounded product and then a rounded sum, and
// every array is bitwise the plain PyTorch version's (the same two
// operations, each rounded once).
//
// What bounds them: bytes. Per node dinv reads r, d and writes z (3
// passes), dot reads x, y (2), update_w_r reads w, r, p, ap and writes
// w_new, r_new (6), update_p reads z, p and writes p_new (3); one f32 pass
// at 2401x3201 is 30.74 MB, 9.18 us at 3.35 TB/s, so 27.5, 18.4, 55.1 and
// 27.5 us. The arithmetic (1-4 flops a node) is far below the card's rate.
//
// Design:
// - The elementwise kernels take one node a thread, 256 threads a block,
//   over the flat array: the four TPU kernels tile rows only to fit VMEM,
//   and the row padding they need (a multiple of 8) has no counterpart.
// - Sums (dot, dw2): the TPU grid runs in order and carries one SMEM
//   accumulator; here blocks run in no order. Each product is taken in
//   double (exact for f32 operands), each thread sums a grid-stride run in
//   double, each block adds its threads in a fixed order (shuffles within a
//   warp, then the warps in index order) and writes its partial. The block
//   that arrives last (an atomic ticket after __threadfence, as in
//   csrc/stencil_dots.cu) adds the partials in block-index order and
//   rounds once to T. The grid size is a function of the node count
//   alone, so two launches on one shape add in the same order and give the
//   same bits; there is no float atomic.
// - update_w_r keeps w_old in a register and forms the increment from the
//   value it stores, so dw2 is the realised step in one launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the reductions' grid: at most this many blocks, each thread striding
constexpr int kMaxReduceBlocks = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dinv_kernel(const T* __restrict__ r, const T* __restrict__ d,
            T* __restrict__ z, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= n) return;
  const T dv = d[i];
  z[i] = dv != T(0) ? r[i] / dv : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_p_kernel(const T* __restrict__ beta, const T* __restrict__ z,
                const T* __restrict__ p, T* __restrict__ out, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = z[i] + *beta * p[i];
}

// The block's sum of v, threads in a fixed order; valid in thread 0.
__device__ double block_sum(double v, double* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int q = 0; q < kWarps; ++q) s += s_warp[q];
  }
  __syncthreads();  // s_warp may be written again by the caller
  return s;
}

// Writes this block's partial; the last block to arrive adds every
// partial in block-index order and returns true in thread 0 with the
// total in *total.
__device__ bool finish_sum(double acc, double* partials, int* ticket,
                           double* total) {
  __shared__ double s_warp[kWarps];
  __shared__ int s_last;
  const double bsum = block_sum(acc, s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = bsum;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  double s = 0.0;
  for (int q = threadIdx.x; q < (int)gridDim.x; q += kThreads) {
    s += __ldcg(&partials[q]);
  }
  *total = block_sum(s, s_warp);
  return threadIdx.x == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ x, const T* __restrict__ y, int64_t n,
           T h1, T h2, double* partials, int* ticket, T* __restrict__ out) {
  double acc = 0.0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += stride) {
    acc += (double)x[i] * (double)y[i];
  }
  double total;
  if (finish_sum(acc, partials, ticket, &total)) {
    const T s = (T)total;
    *out = s * h1 * h2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_w_r_kernel(const T* __restrict__ alpha, const T* __restrict__ w,
                  const T* __restrict__ r, const T* __restrict__ p,
                  const T* __restrict__ ap, T* __restrict__ w_new,
                  T* __restrict__ r_new, int64_t n, double* partials,
                  int* ticket, T* __restrict__ dw2) {
  const T a = *alpha;
  double acc = 0.0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += stride) {
    const T w_old = w[i];
    const T wn = w_old + a * p[i];
    w_new[i] = wn;
    r_new[i] = r[i] - a * ap[i];
    const T dw = wn - w_old;
    acc += (double)dw * (double)dw;
  }
  double total;
  if (finish_sum(acc, partials, ticket, &total)) *dw2 = (T)total;
}

int elementwise_blocks(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

int reduce_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxReduceBlocks ? (b < 1 ? 1 : b)
                                               : kMaxReduceBlocks);
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

template <typename T>
int dinv(const T* r, const T* d, T* z, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  dinv_kernel<T><<<elementwise_blocks(n), kThreads, 0, as_stream(stream)>>>(
      r, d, z, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dot(const T* x, const T* y, int64_t n, T h1, T h2, double* partials,
        int* ticket, T* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  dot_kernel<T><<<reduce_blocks(n), kThreads, 0, as_stream(stream)>>>(
      x, y, n, h1, h2, partials, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_w_r(const T* alpha, const T* w, const T* r, const T* p,
               const T* ap, T* w_new, T* r_new, int64_t n, double* partials,
               int* ticket, T* dw2, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  update_w_r_kernel<T><<<reduce_blocks(n), kThreads, 0,
                         as_stream(stream)>>>(
      alpha, w, r, p, ap, w_new, r_new, n, partials, ticket, dw2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_p(const T* beta, const T* z, const T* p, T* out, int64_t n,
             void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  update_p_kernel<T><<<elementwise_blocks(n), kThreads, 0,
                       as_stream(stream)>>>(beta, z, p, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The partials scratch of dot and update_w_r at n nodes: this many
// doubles. ticket: one int, 0 before the launch.
int pe_stage4_reduce_blocks(int64_t n) { return reduce_blocks(n); }

// Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for an empty array. n is the node count g1*g2;
// every array is contiguous.
int pe_dinv_f32(const float* r, const float* d, float* z, int64_t n,
                void* stream) {
  return dinv(r, d, z, n, stream);
}

int pe_dinv_f64(const double* r, const double* d, double* z, int64_t n,
                void* stream) {
  return dinv(r, d, z, n, stream);
}

int pe_dot_f32(const float* x, const float* y, int64_t n, float h1,
               float h2, double* partials, int* ticket, float* out,
               void* stream) {
  return dot(x, y, n, h1, h2, partials, ticket, out, stream);
}

int pe_dot_f64(const double* x, const double* y, int64_t n, double h1,
               double h2, double* partials, int* ticket, double* out,
               void* stream) {
  return dot(x, y, n, h1, h2, partials, ticket, out, stream);
}

int pe_update_w_r_f32(const float* alpha, const float* w, const float* r,
                      const float* p, const float* ap, float* w_new,
                      float* r_new, int64_t n, double* partials, int* ticket,
                      float* dw2, void* stream) {
  return update_w_r(alpha, w, r, p, ap, w_new, r_new, n, partials, ticket,
                    dw2, stream);
}

int pe_update_w_r_f64(const double* alpha, const double* w, const double* r,
                      const double* p, const double* ap, double* w_new,
                      double* r_new, int64_t n, double* partials,
                      int* ticket, double* dw2, void* stream) {
  return update_w_r(alpha, w, r, p, ap, w_new, r_new, n, partials, ticket,
                    dw2, stream);
}

int pe_update_p_f32(const float* beta, const float* z, const float* p,
                    float* out, int64_t n, void* stream) {
  return update_p(beta, z, p, out, n, stream);
}

int pe_update_p_f64(const double* beta, const double* z, const double* p,
                    double* out, int64_t n, void* stream) {
  return update_p(beta, z, p, out, n, stream);
}

const char* pe_stage4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
