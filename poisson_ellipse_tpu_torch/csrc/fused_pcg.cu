// K-b and K-c: the fused PCG iteration as two kernels for Hopper (sm_90a).
//
// Replaces: poisson_ellipse_tpu/ops/fused_pcg.py:_k1_kernel (K-b) and
// :_k2_kernel (K-c), built by build_kernels there.
//
//   K1 (K-b)  pn = z + beta*p
//             ap = d*pn - (an*pn_up + as*pn_dn + bw*pn_lf + be*pn_rt)
//             denom = h1*h2 * sum(ap*pn); alpha = zr/denom, 0 on breakdown
//   K2 (K-c)  w += alpha*pn; r -= alpha*ap; z = r*dinv
//             zr' = h1*h2 * sum(z*r); diff = ||w_new - w||; beta = zr'/zr;
//             k += 1; converged / breakdown flags
//
// The loop's scalar carry (zr, beta, diff, denom, alpha; k and the flags)
// lives in device memory, never on the host. Each kernel first reads the
// loop's flags and returns without writing anything once the loop has
// exited (converged, broken down, or k at the cap), so the host can issue
// a chunk of iterations and read the flags once per chunk.
//
// What bounds them: bytes. At 2401x3201 f32 one array pass is 30.74 MB;
// K1 reads z, p and five coefficient arrays and writes pn and ap (9
// passes, 82.6 us at 3.35 TB/s); K2 reads w, r, pn, ap, dinv and writes
// w, r, z (8 passes, 73.4 us). The arithmetic is a few flops per byte.
//
// Design:
// - K1 works on 32x32 tiles (32x8 threads, 4 rows each). It builds pn over
//   the tile plus a one-node halo in shared memory, recomputing the halo's
//   pn from z and p at the neighbour instead of making a second pass over
//   an updated p. Nodes outside the grid read as 0 (never clamped values).
//   The TPU kernel's 8-row neighbour BlockSpecs and its (8,128) padding
//   have no counterpart: arrays are the unpadded (M+1, N+1) grid.
// - K2 is a grid-stride elementwise pass; w and r are updated in place.
// - Cross-block sums: the TPU kernels carry one sum across a sequential
//   grid. Here blocks run in parallel and in no fixed order, so each block
//   writes its partial to global scratch, and the block that arrives last
//   (atomic ticket after __threadfence) sums all partials in index order
//   and runs the scalar tail. No float atomics: the order of every sum is
//   fixed by the launch shape, so a rerun gives the same bits and the same
//   iteration count.
// - Compute type: the kernels are templates on T, float or __nv_bfloat16
//   (pe_fused_k1_f32 / _bf16, pe_fused_k2_f32 / _bf16; the JAX K1/K2 run
//   at the solve's dtype). Arrays and the scalar carry are T; each value
//   is computed in float and rounded to T (rn<T>, storage.cuh) where it is
//   stored, as the plain versions round it (ops/whole_solve.py:rounder).
//   The float form sums in float, as before; the bf16 form sums in double
//   and rounds through float to bf16, as its plain version does
//   (ops/fused_pcg.py:grid_sum), since a sum in a fixed float order would
//   round to its plain version's bf16 only by luck.
// - FP contraction: built with -fmad=false, so every product is rounded
//   before the sum that uses it, as in the plain PyTorch version; arrays
//   then agree bitwise, and only the sums' order differs.

#include <cuda_runtime.h>
#include <cstdint>

#include "storage.cuh"

namespace {

// The scalar carry layout; ops/fused_pcg.py holds the same indices.
enum Scal { kZr = 0, kBeta = 1, kDiff = 2, kDenom = 3, kAlpha = 4 };
enum Flag {
  kK = 0,
  kConverged = 1,
  kBreakdown = 2,
  kPendingBreakdown = 3,
  kTicketK1 = 4,
  kTicketK2 = 5
};

constexpr int kTileX = 32;
constexpr int kTileY = 32;
constexpr int kK1ThreadsY = 8;
constexpr int kK2Threads = 256;
constexpr int kK2MaxBlocks = 1024;

// The accumulator of a sum of T terms: float for float, double for bf16.
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = double;
};

__device__ __forceinline__ bool loop_active(const int* flags, int max_iter) {
  return flags[kConverged] == 0 && flags[kBreakdown] == 0 &&
         flags[kK] < max_iter;
}

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// Sum over the block in a fixed order (warp shuffles, then warp 0 over the
// warp sums). Every thread of the block calls it; thread 0 holds the sum.
template <typename A>
__device__ A block_sum(A v, A* s_warp) {
  const int tid = thread_rank();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y + 31) / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // s_warp may still be read by a previous call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  A s = A(0);
  if (warp == 0) {
    s = lane < nwarps ? s_warp[lane] : A(0);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

// Thread 0 has stored this block's partials; true in every thread of the
// block that arrives last.
__device__ bool arrive_last(int* ticket, int nblocks, int* s_last) {
  if (thread_rank() == 0) {
    __threadfence();
    *s_last = atomicAdd(ticket, 1) == nblocks - 1;
  }
  __syncthreads();
  return *s_last != 0;
}

// Sum of partials[q*stride + offset] for q < n, in a fixed order.
template <typename A>
__device__ A sum_partials(const A* partials, int n, int stride, int offset,
                          A* s_warp) {
  const volatile A* src = partials;
  const int nthreads = blockDim.x * blockDim.y;
  A s = A(0);
  for (int q = thread_rank(); q < n; q += nthreads) s += src[q * stride + offset];
  return block_sum(s, s_warp);
}

template <typename T>
__global__ void __launch_bounds__(kTileX * kK1ThreadsY)
k1_kernel(const T* __restrict__ z, const T* __restrict__ p,
          const T* __restrict__ an, const T* __restrict__ as_,
          const T* __restrict__ bw, const T* __restrict__ be,
          const T* __restrict__ d, T* __restrict__ pn, T* __restrict__ ap,
          typename Acc<T>::type* partials, T* scal, int* flags, int g1,
          int g2, int max_iter, float h1, float h2) {
  using A = typename Acc<T>::type;
  if (!loop_active(flags, max_iter)) return;
  __shared__ float s_pn[kTileY + 2][kTileX + 2];
  __shared__ A s_warp[32];
  __shared__ int s_last;
  const auto R = [](float x) { return rn<T>(x); };
  const int tid = thread_rank();
  const int nthreads = blockDim.x * blockDim.y;
  const int i0 = blockIdx.y * kTileY;
  const int j0 = blockIdx.x * kTileX;
  const float beta = up(scal[kBeta]);

  // pn over the tile and its halo; outside the grid pn is 0
  for (int q = tid; q < (kTileY + 2) * (kTileX + 2); q += nthreads) {
    const int li = q / (kTileX + 2);
    const int lj = q - li * (kTileX + 2);
    const int gi = i0 - 1 + li;
    const int gj = j0 - 1 + lj;
    float v = 0.f;
    if (gi >= 0 && gi < g1 && gj >= 0 && gj < g2) {
      const int64_t o = (int64_t)gi * g2 + gj;
      v = R(up(z[o]) + beta * up(p[o]));
    }
    s_pn[li][lj] = v;
  }
  __syncthreads();

  A acc = A(0);
  const int tx = threadIdx.x;
  const int gj = j0 + tx;
  for (int r = threadIdx.y; r < kTileY; r += blockDim.y) {
    const int gi = i0 + r;
    if (gi < g1 && gj < g2) {
      const int64_t o = (int64_t)gi * g2 + gj;
      const float c = s_pn[r + 1][tx + 1];
      const float v = R(up(d[o]) * c - (up(an[o]) * s_pn[r][tx + 1] +
                                        up(as_[o]) * s_pn[r + 2][tx + 1] +
                                        up(bw[o]) * s_pn[r + 1][tx] +
                                        up(be[o]) * s_pn[r + 1][tx + 2]));
      pn[o] = down<T>(c);
      ap[o] = down<T>(v);
      acc += v * c;
    }
  }

  const A bsum = block_sum(acc, s_warp);
  const int nblocks = gridDim.x * gridDim.y;
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = bsum;
  if (!arrive_last(&flags[kTicketK1], nblocks, &s_last)) return;
  __threadfence();
  const A total = sum_partials(partials, nblocks, 1, 0, s_warp);
  if (tid == 0) {
    const float denom = R(R(static_cast<float>(total)) * h1 * h2);
    // DENOM_GUARD, rounded to the run dtype
    const bool bd = denom < rn<T>(1e-15f);
    float alpha = R(up(scal[kZr]) / (bd ? 1.f : denom));
    alpha = bd ? 0.f : alpha;
    scal[kDenom] = down<T>(denom);
    scal[kAlpha] = down<T>(alpha);
    flags[kPendingBreakdown] = bd ? 1 : 0;
    flags[kTicketK1] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kK2Threads)
k2_kernel(T* __restrict__ w, T* __restrict__ r, const T* __restrict__ pn,
          const T* __restrict__ ap, const T* __restrict__ dinv,
          T* __restrict__ z, typename Acc<T>::type* partials, T* scal,
          int* flags, int64_t n, int max_iter, float h1, float h2,
          float delta, int weighted) {
  using A = typename Acc<T>::type;
  if (!loop_active(flags, max_iter)) return;
  __shared__ A s_warp[32];
  __shared__ int s_last;
  const auto R = [](float x) { return rn<T>(x); };
  const float alpha = up(scal[kAlpha]);
  A s_zr = A(0);
  A s_dw = A(0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += stride) {
    const float wo = up(w[o]);
    const float wn = R(wo + alpha * up(pn[o]));
    const float rn_ = R(up(r[o]) - alpha * up(ap[o]));
    const float zz = R(rn_ * up(dinv[o]));
    // the realised increment, not alpha*pn: the oracle counts depend on it
    const float dw = wn - wo;
    w[o] = down<T>(wn);
    r[o] = down<T>(rn_);
    z[o] = down<T>(zz);
    s_zr += zz * rn_;
    s_dw += dw * dw;
  }

  const A b_zr = block_sum(s_zr, s_warp);
  const A b_dw = block_sum(s_dw, s_warp);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = b_zr;
    partials[2 * blockIdx.x + 1] = b_dw;
  }
  if (!arrive_last(&flags[kTicketK2], gridDim.x, &s_last)) return;
  __threadfence();
  const A zr_sum = sum_partials(partials, gridDim.x, 2, 0, s_warp);
  const A dw_sum = sum_partials(partials, gridDim.x, 2, 1, s_warp);
  if (threadIdx.x == 0) {
    // rotated_next_state: breakdown holds zr/beta/diff, as the reference
    // exits before touching them
    const bool bd = flags[kPendingBreakdown] != 0;
    const float zr = up(scal[kZr]);
    const float zr_new = R(R(static_cast<float>(zr_sum)) * h1 * h2);
    const float dw2 = R(static_cast<float>(dw_sum));
    float nd = R(weighted ? sqrtf(dw2 * h1 * h2) : sqrtf(dw2));
    const bool conv = !bd && nd < delta;
    nd = bd ? up(scal[kDiff]) : nd;
    const float beta_new = R(zr_new / (bd ? 1.f : zr));
    scal[kZr] = down<T>(bd ? zr : zr_new);
    scal[kBeta] = bd ? scal[kBeta] : down<T>(beta_new);
    scal[kDiff] = down<T>(nd);
    flags[kK] += 1;
    flags[kConverged] = conv ? 1 : 0;
    flags[kBreakdown] = bd ? 1 : 0;
    flags[kTicketK2] = 0;
  }
}

dim3 k1_grid(int g1, int g2) {
  return dim3((g2 + kTileX - 1) / kTileX, (g1 + kTileY - 1) / kTileY);
}

int k2_blocks(int64_t n) {
  const int64_t want = (n + kK2Threads - 1) / kK2Threads;
  return static_cast<int>(want < kK2MaxBlocks ? want : kK2MaxBlocks);
}

// h1, h2 (and delta) are the values rounded to T.
template <typename T>
int launch_k1(const T* z, const T* p, const T* an, const T* as_, const T* bw,
              const T* be, const T* d, T* pn, T* ap,
              typename Acc<T>::type* partials, T* scal, int* flags, int g1,
              int g2, int max_iter, float h1, float h2, void* stream) {
  k1_kernel<T><<<k1_grid(g1, g2), dim3(kTileX, kK1ThreadsY), 0,
                 static_cast<cudaStream_t>(stream)>>>(
      z, p, an, as_, bw, be, d, pn, ap, partials, scal, flags, g1, g2,
      max_iter, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k2(T* w, T* r, const T* pn, const T* ap, const T* dinv, T* z,
              typename Acc<T>::type* partials, T* scal, int* flags, int g1,
              int g2, int max_iter, float h1, float h2, float delta,
              int weighted, void* stream) {
  const int64_t n = (int64_t)g1 * g2;
  k2_kernel<T><<<k2_blocks(n), kK2Threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      w, r, pn, ap, dinv, z, partials, scal, flags, n, max_iter, h1, h2,
      delta, weighted);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Length of the partials scratch one solve needs (shared by K1 and K2),
// in accumulators: float for the f32 form, double for the bf16 form.
int pe_fused_scratch_len(int g1, int g2) {
  const dim3 g = k1_grid(g1, g2);
  const int k1 = static_cast<int>(g.x * g.y);
  const int k2 = 2 * k2_blocks((int64_t)g1 * g2);
  return k1 > k2 ? k1 : k2;
}

int pe_fused_k1_f32(const float* z, const float* p, const float* an,
                    const float* as_, const float* bw, const float* be,
                    const float* d, float* pn, float* ap, float* partials,
                    float* scal, int* flags, int g1, int g2, int max_iter,
                    float h1, float h2, void* stream) {
  return launch_k1(z, p, an, as_, bw, be, d, pn, ap, partials, scal, flags,
                   g1, g2, max_iter, h1, h2, stream);
}

int pe_fused_k1_bf16(const __nv_bfloat16* z, const __nv_bfloat16* p,
                     const __nv_bfloat16* an, const __nv_bfloat16* as_,
                     const __nv_bfloat16* bw, const __nv_bfloat16* be,
                     const __nv_bfloat16* d, __nv_bfloat16* pn,
                     __nv_bfloat16* ap, double* partials, __nv_bfloat16* scal,
                     int* flags, int g1, int g2, int max_iter, float h1,
                     float h2, void* stream) {
  return launch_k1(z, p, an, as_, bw, be, d, pn, ap, partials, scal, flags,
                   g1, g2, max_iter, h1, h2, stream);
}

int pe_fused_k2_f32(float* w, float* r, const float* pn, const float* ap,
                    const float* dinv, float* z, float* partials, float* scal,
                    int* flags, int g1, int g2, int max_iter, float h1,
                    float h2, float delta, int weighted, void* stream) {
  return launch_k2(w, r, pn, ap, dinv, z, partials, scal, flags, g1, g2,
                   max_iter, h1, h2, delta, weighted, stream);
}

int pe_fused_k2_bf16(__nv_bfloat16* w, __nv_bfloat16* r,
                     const __nv_bfloat16* pn, const __nv_bfloat16* ap,
                     const __nv_bfloat16* dinv, __nv_bfloat16* z,
                     double* partials, __nv_bfloat16* scal, int* flags, int g1,
                     int g2, int max_iter, float h1, float h2, float delta,
                     int weighted, void* stream) {
  return launch_k2(w, r, pn, ap, dinv, z, partials, scal, flags, g1, g2,
                   max_iter, h1, h2, delta, weighted, stream);
}

const char* pe_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
