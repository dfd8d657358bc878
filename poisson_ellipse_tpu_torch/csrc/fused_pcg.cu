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
// - FP contraction: built with -fmad=false, so every product is rounded
//   before the sum that uses it, as in the plain PyTorch version; arrays
//   then agree bitwise, and only the sums' order differs.

#include <cuda_runtime.h>
#include <cstdint>

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

__device__ __forceinline__ bool loop_active(const int* flags, int max_iter) {
  return flags[kConverged] == 0 && flags[kBreakdown] == 0 &&
         flags[kK] < max_iter;
}

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// Sum over the block in a fixed order (warp shuffles, then warp 0 over the
// warp sums). Every thread of the block calls it; thread 0 holds the sum.
template <typename T>
__device__ T block_sum(T v, T* s_warp) {
  const int tid = thread_rank();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y + 31) / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // s_warp may still be read by a previous call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  T s = T(0);
  if (warp == 0) {
    s = lane < nwarps ? s_warp[lane] : T(0);
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
template <typename T>
__device__ T sum_partials(const T* partials, int n, int stride, int offset,
                          T* s_warp) {
  const volatile T* src = partials;
  const int nthreads = blockDim.x * blockDim.y;
  T s = T(0);
  for (int q = thread_rank(); q < n; q += nthreads) s += src[q * stride + offset];
  return block_sum(s, s_warp);
}

template <typename T>
__global__ void __launch_bounds__(kTileX * kK1ThreadsY)
k1_kernel(const T* __restrict__ z, const T* __restrict__ p,
          const T* __restrict__ an, const T* __restrict__ as_,
          const T* __restrict__ bw, const T* __restrict__ be,
          const T* __restrict__ d, T* __restrict__ pn, T* __restrict__ ap,
          T* partials, T* scal, int* flags, int g1, int g2, int max_iter,
          T h1, T h2) {
  if (!loop_active(flags, max_iter)) return;
  __shared__ T s_pn[kTileY + 2][kTileX + 2];
  __shared__ T s_warp[32];
  __shared__ int s_last;
  const int tid = thread_rank();
  const int nthreads = blockDim.x * blockDim.y;
  const int i0 = blockIdx.y * kTileY;
  const int j0 = blockIdx.x * kTileX;
  const T beta = scal[kBeta];

  // pn over the tile and its halo; outside the grid pn is 0
  for (int q = tid; q < (kTileY + 2) * (kTileX + 2); q += nthreads) {
    const int li = q / (kTileX + 2);
    const int lj = q - li * (kTileX + 2);
    const int gi = i0 - 1 + li;
    const int gj = j0 - 1 + lj;
    T v = T(0);
    if (gi >= 0 && gi < g1 && gj >= 0 && gj < g2) {
      const int64_t o = (int64_t)gi * g2 + gj;
      v = z[o] + beta * p[o];
    }
    s_pn[li][lj] = v;
  }
  __syncthreads();

  T acc = T(0);
  const int tx = threadIdx.x;
  const int gj = j0 + tx;
  for (int r = threadIdx.y; r < kTileY; r += blockDim.y) {
    const int gi = i0 + r;
    if (gi < g1 && gj < g2) {
      const int64_t o = (int64_t)gi * g2 + gj;
      const T c = s_pn[r + 1][tx + 1];
      const T v = d[o] * c - (an[o] * s_pn[r][tx + 1] + as_[o] * s_pn[r + 2][tx + 1] +
                              bw[o] * s_pn[r + 1][tx] + be[o] * s_pn[r + 1][tx + 2]);
      pn[o] = c;
      ap[o] = v;
      acc += v * c;
    }
  }

  const T bsum = block_sum(acc, s_warp);
  const int nblocks = gridDim.x * gridDim.y;
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = bsum;
  if (!arrive_last(&flags[kTicketK1], nblocks, &s_last)) return;
  __threadfence();
  const T total = sum_partials(partials, nblocks, 1, 0, s_warp);
  if (tid == 0) {
    const T denom = total * h1 * h2;
    const bool bd = denom < T(1e-15);  // DENOM_GUARD, in the run dtype
    T alpha = scal[kZr] / (bd ? T(1) : denom);
    alpha = bd ? T(0) : alpha;
    scal[kDenom] = denom;
    scal[kAlpha] = alpha;
    flags[kPendingBreakdown] = bd ? 1 : 0;
    flags[kTicketK1] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kK2Threads)
k2_kernel(T* __restrict__ w, T* __restrict__ r, const T* __restrict__ pn,
          const T* __restrict__ ap, const T* __restrict__ dinv,
          T* __restrict__ z, T* partials, T* scal, int* flags, int64_t n,
          int max_iter, T h1, T h2, T delta, int weighted) {
  if (!loop_active(flags, max_iter)) return;
  __shared__ T s_warp[32];
  __shared__ int s_last;
  const T alpha = scal[kAlpha];
  T s_zr = T(0);
  T s_dw = T(0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += stride) {
    const T wo = w[o];
    const T wn = wo + alpha * pn[o];
    const T rn = r[o] - alpha * ap[o];
    const T zz = rn * dinv[o];
    // the realised increment, not alpha*pn: the oracle counts depend on it
    const T dw = wn - wo;
    w[o] = wn;
    r[o] = rn;
    z[o] = zz;
    s_zr += zz * rn;
    s_dw += dw * dw;
  }

  const T b_zr = block_sum(s_zr, s_warp);
  const T b_dw = block_sum(s_dw, s_warp);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = b_zr;
    partials[2 * blockIdx.x + 1] = b_dw;
  }
  if (!arrive_last(&flags[kTicketK2], gridDim.x, &s_last)) return;
  __threadfence();
  const T zr_sum = sum_partials(partials, gridDim.x, 2, 0, s_warp);
  const T dw_sum = sum_partials(partials, gridDim.x, 2, 1, s_warp);
  if (threadIdx.x == 0) {
    // rotated_next_state: breakdown holds zr/beta/diff, as the reference
    // exits before touching them
    const bool bd = flags[kPendingBreakdown] != 0;
    const T zr = scal[kZr];
    const T zr_new = zr_sum * h1 * h2;
    T nd = weighted ? sqrt(dw_sum * h1 * h2) : sqrt(dw_sum);
    const bool conv = !bd && nd < delta;
    nd = bd ? scal[kDiff] : nd;
    const T beta_new = zr_new / (bd ? T(1) : zr);
    scal[kZr] = bd ? zr : zr_new;
    scal[kBeta] = bd ? scal[kBeta] : beta_new;
    scal[kDiff] = nd;
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

}  // namespace

extern "C" {

// Length of the partials scratch one solve needs (shared by K1 and K2).
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
  k1_kernel<float><<<k1_grid(g1, g2), dim3(kTileX, kK1ThreadsY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      z, p, an, as_, bw, be, d, pn, ap, partials, scal, flags, g1, g2,
      max_iter, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

int pe_fused_k2_f32(float* w, float* r, const float* pn, const float* ap,
                    const float* dinv, float* z, float* partials, float* scal,
                    int* flags, int g1, int g2, int max_iter, float h1,
                    float h2, float delta, int weighted, void* stream) {
  const int64_t n = (int64_t)g1 * g2;
  k2_kernel<float><<<k2_blocks(n), kK2Threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      w, r, pn, ap, dinv, z, partials, scal, flags, n, max_iter, h1, h2,
      delta, weighted);
  return static_cast<int>(cudaGetLastError());
}

const char* pe_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
