// What the three whole-solve kernels (resident_pcg.cu, streamed_pcg.cu,
// xl_pcg.cu) share: the grid barrier, the deterministic cross-block sum,
// the scalar tail of one PCG iteration, the span halo of the resident and
// streamed kernels, and the cooperative launch.
//
// A whole-solve kernel is persistent: one launch runs every iteration, and
// the two scalar sync points of PCG (alpha needs the global (Ap, p), beta
// the global (z, r)) become grid barriers. The TPU kernels need no barrier:
// their grid runs in order on one core and a sum rides in SMEM from one
// step to the next. Here blocks run in parallel, so:
//
// - grid_barrier() is cooperative_groups::this_grid().sync(), valid only
//   under cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//   resident all at once (cudaErrorCooperativeLaunchTooLarge) instead of
//   letting it deadlock;
// - a sum over the grid is deterministic without float atomics: each block
//   writes its partial, then after the barrier EVERY block adds all
//   partials in one fixed order (grid_sum). Every block runs the same
//   instructions on the same values, so each holds the same bits, takes
//   the same exit decision, and a rerun repeats them. The next barrier of
//   the loop separates these reads from the partials' next writes, so no
//   ticket and no last-block election is needed (the fused K1/K2 pair
//   needs one because each of its launches ends where the sum is made).
// - the sums are accumulated in double, from the float terms, and rounded
//   once to float. The plain versions sum the same float terms the same
//   way (torch.sum(..., dtype=torch.float64)), so the two agree bitwise
//   unless a double sum falls within its own rounding error of a float
//   rounding boundary. With float sums the order alone moves alpha and
//   beta in their last bits, and the resident form's cancelling stencil
//   (d*pn - ...) grows that to 6e-5 of w's scale within 7 iterations at
//   401x601 (measured on the CPU between two summation orders).
//
// Values other blocks wrote during the launch are read with __ldcg (L2,
// not the SM's L1, which is not coherent across SMs).
//
// The compute type TC (float or __nv_bfloat16) of a kernel's instantiation
// is a template parameter of the pieces below. Every value is computed in
// float; a value the kernel stores (an array element, a grid sum, a scalar
// of the carry) is rounded to TC there (rn<TC>, storage.cuh), where the
// plain version rounds it (ops/whole_solve.py:rounder). A sum is
// accumulated in double from its float terms and rounded to float, then
// to TC. rn<float> is the identity: the float forms are the untemplated
// arithmetic. The span halo (zpub, ppub) is float in every form, so a
// neighbour rebuilds pn from the owner's unrounded z.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "storage.cuh"

namespace pe {

// the PCG breakdown guard on the (Ap, p) denominator, in float
// (stage0/Withoutopenmp1.cpp:128; DENOM_GUARD in solver/pcg.py)
constexpr float kDenomGuard = 1e-15f;

// doubles of shared memory each block keeps for block_sum/grid_sum: one per
// warp of a 1024-thread block and the broadcast slot; at the start of the
// dynamic shared memory of the resident and streamed kernels
constexpr int kReduceDoubles = 40;
constexpr int kReduceBytes = kReduceDoubles * static_cast<int>(sizeof(double));

// Status word the kernels leave for the host: iterations, converged,
// breakdown, and 1 once the kernel ran to its end (ops/whole_solve.py).
enum Status { kIters = 0, kConverged = 1, kBreakdown = 2, kDone = 3 };

__device__ __forceinline__ void grid_barrier() {
  cooperative_groups::this_grid().sync();
}

// Sum of v over a 1-D block in a fixed order: a shuffle tree in each warp,
// then warp 0 over the warp sums. Every thread gets the sum. ``scratch``
// holds kReduceDoubles doubles of shared memory.
__device__ __forceinline__ double block_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double s = lane < nwarps ? scratch[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) scratch[32] = s;
  }
  __syncthreads();
  return scratch[32];
}

// Sum of partials[0..n) in block-index order after a grid barrier: lane l
// of warp 0 adds partials[l], partials[l+32], ... in turn, then a fixed
// shuffle tree. The same bits in every block. Every thread gets the sum.
__device__ __forceinline__ double grid_sum(const double* partials, int n,
                                           double* scratch) {
  __syncthreads();  // the previous call's readers are done with scratch
  if (threadIdx.x < 32) {
    double s = 0.0;
    for (int q = threadIdx.x; q < n; q += 32) s += __ldcg(partials + q);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) scratch[32] = s;
  }
  __syncthreads();
  return scratch[32];
}

// Block sum of v stored as this block's partial, the barrier, and the
// grid's sum of all partials rounded once to float, in every block.
__device__ __forceinline__ float grid_reduce(double v, double* partials,
                                             double* scratch) {
  const double b = block_sum(v, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = b;
  grid_barrier();
  return static_cast<float>(grid_sum(partials, gridDim.x, scratch));
}

// Two sums with one barrier.
__device__ __forceinline__ void grid_reduce2(double v0, double v1,
                                             double* partials0,
                                             double* partials1,
                                             double* scratch, float* s0,
                                             float* s1) {
  const double b0 = block_sum(v0, scratch);
  const double b1 = block_sum(v1, scratch);
  if (threadIdx.x == 0) {
    partials0[blockIdx.x] = b0;
    partials1[blockIdx.x] = b1;
  }
  grid_barrier();
  *s0 = static_cast<float>(grid_sum(partials0, gridDim.x, scratch));
  *s1 = static_cast<float>(grid_sum(partials1, gridDim.x, scratch));
}

// kSums sums at once, for the xl kernel: the block's sums of v[k] in a
// fixed order (a shuffle tree in each warp, then warp 0 over the warp
// sums), each stored as this block's partials[k], one barrier, and then
// the grid's sums of all partials, added by every thread of every block
// (thread t adds partials t, t + blockDim.x, ... in order, then the same
// block tree), each rounded once to float, in every block. grid_sum's
// one warp adds the partials of a 528-block grid in 17 dependent loads a
// lane; here each thread has at most a few. ``scratch`` holds
// kWideDoubles doubles of shared memory.
constexpr int kWideDoubles = 2 * 33;

template <int kSums>
__device__ __forceinline__ void block_sums(double (&v)[kSums],
                                           double* scratch) {
  static_assert(kSums <= 2, "scratch holds two sums");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    }
  }
  __syncthreads();  // the previous call's readers are done with scratch
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) scratch[33 * k + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      double s = lane < nwarps ? scratch[33 * k + lane] : 0.0;
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, o);
      }
      if (lane == 0) scratch[33 * k + 32] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = scratch[33 * k + 32];
}

template <int kSums>
__device__ __forceinline__ void grid_reduce_wide(double (&v)[kSums],
                                                 double* const (&partials)[kSums],
                                                 double* scratch,
                                                 float (&out)[kSums]) {
  block_sums<kSums>(v, scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) partials[k][blockIdx.x] = v[k];
  }
  grid_barrier();
  double s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = 0.0;
  for (int q = threadIdx.x; q < static_cast<int>(gridDim.x);
       q += blockDim.x) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] += __ldcg(partials[k] + q);
  }
  block_sums<kSums>(s, scratch);
#pragma unroll
  for (int k = 0; k < kSums; ++k) out[k] = static_cast<float>(s[k]);
}

// The span halo of the resident and streamed kernels. A block owns the
// nodes [s, s + len) of the row-major grid; its stencil needs pn one row
// (g2 nodes) beyond either end, owned by blocks whose pn is computed in
// the same phase. So each block publishes z and p for its nodes within one
// row of its span's ends (at_span_edge) in the update phase, and a
// neighbour forms pn = z + beta*p from them after the barrier, with the
// owner's roundings in the owner's order: the same bits. The barrier that
// closes the update phase separates those writes from the reads, and the
// one that closes the stencil phase separates the reads from the next
// writes, so one buffer suffices.
__device__ __forceinline__ bool at_span_edge(int l, int len, int g2) {
  return l < g2 || l >= len - g2;
}

// pn at global node x: from the block's shared memory inside its span,
// else rebuilt from the published z and p.
template <typename TC>
__device__ __forceinline__ float span_pn(int x, int s, int len, const TC* s_p,
                                        const float* zpub, const float* ppub,
                                        float beta) {
  const int l = x - s;
  if (l >= 0 && l < len) return up(s_p[l]);
  return rn<TC>(__ldcg(zpub + x) + beta * __ldcg(ppub + x));
}

// The breakdown test on the (Ap, p) denominator, with the guard rounded to
// TC as a PyTorch comparison of a TC tensor with the Python float rounds it.
template <typename TC>
__device__ __forceinline__ bool below_guard(float denom) {
  return denom < rn<TC>(kDenomGuard);
}

// alpha = zr / denom, forced to 0 when the guard trips.
template <typename TC>
__device__ __forceinline__ float guarded_alpha(float zr, float denom) {
  const bool guard = below_guard<TC>(denom);
  const float alpha = rn<TC>(zr / (guard ? 1.f : denom));
  return guard ? 0.f : alpha;
}

// The loop's scalar carry, the same in every block.
struct Carry {
  float zr;
  float beta;
  float diff;
  bool converged;
  bool breakdown;
};

// The scalar tail of one iteration of the resident and streamed loops
// (resident_pcg.py:179-184 there): convergence on the realised step norm,
// and on breakdown zr, beta and diff held, as the reference exits before
// touching them.
// dw2 and zr_raw are the grid sums, rounded to TC.
template <typename TC>
__device__ __forceinline__ void next_carry(Carry& c, bool breakdown,
                                           float dw2, float zr_raw,
                                           float h1h2, float delta,
                                           int weighted) {
  const float zr_new = rn<TC>(zr_raw * h1h2);
  float nd = rn<TC>(weighted ? sqrtf(dw2 * h1h2) : sqrtf(dw2));
  const bool conv = !breakdown && nd < delta;
  nd = breakdown ? c.diff : nd;
  c.beta = breakdown ? c.beta : rn<TC>(zr_new / c.zr);
  c.zr = breakdown ? c.zr : zr_new;
  c.diff = nd;
  c.converged = conv;
  c.breakdown = breakdown;
}

template <typename TC>
__device__ __forceinline__ void write_status(int* status, TC* diff_out,
                                             int iters, const Carry& c) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[kIters] = iters;
    status[kConverged] = c.converged ? 1 : 0;
    status[kBreakdown] = c.breakdown ? 1 : 0;
    status[kDone] = 1;
    diff_out[0] = down<TC>(c.diff);
  }
}

// The cooperative launch of a whole-solve kernel: raises the dynamic
// shared-memory limit (needed above 48 KB), then launches. A grid larger
// than the card can hold at once is refused with
// cudaErrorCooperativeLaunchTooLarge; nothing runs and nothing hangs.
template <typename Kernel>
int cooperative_launch(Kernel kernel, int nblocks, int threads, int smem,
                       void** args, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) {
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(nblocks), dim3(threads), args,
                                    static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  }
  if (e != cudaSuccess) cudaGetLastError();  // clear a non-sticky error
  return static_cast<int>(e);
}

// The device's cooperative-launch attribute and how many blocks of
// ``kernel`` fit on one SM with ``smem`` bytes of dynamic shared memory.
template <typename Kernel>
int launch_query(Kernel kernel, int threads, int device, int smem,
                 int* cooperative, int* blocks_per_sm) {
  *cooperative = 0;
  *blocks_per_sm = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      threads, smem);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace pe
