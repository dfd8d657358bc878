// K1-shard and K2-shard: the fused PCG iteration on one rank of the mesh,
// for Hopper (sm_90a).
//
// Replaces: poisson_ellipse_tpu/parallel/fused_sharded.py build_shard_kernels,
// K1 (the pallas_call at :179, body _k1_kernel :92-144) and K2 (the
// pallas_call at :207, body ops/fused_pcg.py:_k2_kernel :152-193).
//
//   K1-shard  pn = z + beta*p on the halo-extended (bm+2, bn+2) window;
//             ap = A(pn), the apply_a_block tree (stencil_tree.cuh, K-a's),
//             0 where d == 0; the rank's sum(ap*pn) as per-block partials
//   K2-shard  alpha = zr/denom, 0 when denom is under the 1e-15 guard;
//             w += alpha*pn; r -= alpha*ap; z = r*dinv; the rank's
//             sum(z*r) and sum(dw^2), dw = w_new - w, as per-block partials
//
// Around them, on every rank (parallel/fused_sharded.py): the stacked (z, p)
// halo exchange before K1, the reduction of the denominator between the two,
// and after K2 the reduction of the pair and the scalar tail
// (ops/fused_pcg.py rotated_next_state). Unlike K-b and K-c, neither kernel
// finishes a sum or runs the tail: on the mesh the denominator and the
// convergence test wait for the other ranks. So each block writes its part
// of each sum, in double, and the launcher's caller adds them.
//
// zr, beta and the reduced denominator come from the device carry `scal`
// (layout of ops/fused_pcg.py), the loop's state from `flags`. Once the
// flags say the loop has exited, both kernels return without writing, so
// the extra bodies of the last chunk change nothing.
//
// The ring and the padding: the halos of z, p, a, b are the neighbours'
// exchanged edges, zeros where there is no neighbour; d is zero outside the
// global interior (ops/fused_pcg.py interior_normalized), so ap is exactly 0
// there and so are z and p. The TPU's (8, 128) tile padding of the rank's
// block and its aligned DMA windows have no counterpart here.
//
// What bounds them: bytes. On a rank's 1201x1601 block (2401x3201 over 2x2)
// one f32 pass is 7.69 MB. K1 reads z, p, a, b on the (bm+2, bn+2) window
// and d, and writes pn and ap (7 passes, 16.1 us at 3.35 TB/s); K2 reads w,
// r, pn, ap, dinv and writes w, r, z (8 passes, 18.4 us). Each node takes a
// few tens of flops.
//
// Design: one node a thread, as K-a. K1 uses K-a's 32x8 blocks over the
// owned block and recomputes pn at each of a node's four neighbours from z
// and p (the same two operations, so the same bits); K2 is K-c's grid-stride
// pass. Each block adds its terms in double in a fixed order (warp
// shuffles, then warp 0 over the warp sums); no float atomics. Built with
// -fmad=false, so the arrays are bitwise the plain version's and the sums,
// added in another order, agree once rounded to f32.
//
// The bf16 forms (pe_fused_sharded_k1_bf16, pe_fused_sharded_k2_bf16)
// replace the same two pallas_calls at bf16 (:179 and :207 with bf16
// operands): each kernel templated on its run type, every array and the
// scalar carry bf16, each load widened exactly, every value computed in
// float and rounded once to bf16 where it is stored (rn/down, storage.cuh):
// pn = rn(z + beta*p), ap = rn(A(pn)) with the same tree on the
// bf16-rounded h1, h2, and w, r, z as K-c's bf16 form computes them. The
// sums add products of two bf16 values (exact in float) in double, per
// block, as the f32 forms do. A kernel of two columns a lane (one 4-byte
// word of pn, ap and d, pn_march.cuh's) was tried and was the slower on
// an H100, 34.6 us against 22.5 at 1201x1601: the windows' pairs start
// mid-word wherever the halo exchange's stack puts them, and it formed
// each pn at three rows. Bound: 7 passes at 2 B, 26.9 MB on a 1201x1601 block,
// 8.0 us; K2-shard bf16 8 passes, 30.8 MB, 9.2 us.

#include <cuda_runtime.h>
#include <cstdint>

#include "stencil_tree.cuh"
#include "storage.cuh"

namespace {

// ops/fused_pcg.py's carry layout
enum Scal { kZr = 0, kBeta = 1, kDiff = 2, kDenom = 3, kAlpha = 4 };
enum Flag { kK = 0, kConverged = 1, kBreakdown = 2 };

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kK2Threads = 256;
constexpr int kK2MaxBlocks = 1024;

__device__ __forceinline__ bool loop_active(const int* flags, int max_iter) {
  return flags[kConverged] == 0 && flags[kBreakdown] == 0 &&
         flags[kK] < max_iter;
}

// Sum over the block in a fixed order; thread 0 holds the result.
__device__ double block_sum(double v, double* s_warp) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y + 31) / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // s_warp may still be read by a previous call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = lane < nwarps ? s_warp[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

// K1-shard in the run type T: float, or bf16 (each load widened, pn and ap
// rounded once to T where they are stored).
template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
k1_shard_kernel(const T* __restrict__ z, const T* __restrict__ p,
                const T* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ d, T* __restrict__ pn,
                T* __restrict__ ap, double* __restrict__ partials,
                const T* __restrict__ scal, const int* __restrict__ flags,
                int bm, int bn, int max_iter, float h1, float h2) {
  if (!loop_active(flags, max_iter)) return;
  __shared__ double s_warp[32];
  const float beta = up(scal[kBeta]);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  double term = 0.0;
  if (i < bm && j < bn) {
    const int64_t ld = bn + 2;
    const int64_t c = (int64_t)(i + 1) * ld + (j + 1);
    const auto at = [&](int64_t o) {
      return rn<T>(up(z[o]) + beta * up(p[o]));
    };
    const float wc = at(c);
    float v = rn<T>(stencil_tree(wc, at(c - ld), at(c + ld), at(c - 1),
                                 at(c + 1), up(a[c]), up(a[c + ld]),
                                 up(b[c]), up(b[c + 1]), h1, h2));
    const int64_t o = (int64_t)i * bn + j;
    v = up(d[o]) != 0.f ? v : 0.f;
    pn[o] = down<T>(wc);
    ap[o] = down<T>(v);
    term = static_cast<double>(v * wc);
  }
  const double s = block_sum(term, s_warp);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// K2-shard in the run type T: float, or bf16 (K-c's bf16 form's body).
template <typename T>
__global__ void __launch_bounds__(kK2Threads)
k2_shard_kernel(T* __restrict__ w, T* __restrict__ r,
                const T* __restrict__ pn, const T* __restrict__ ap,
                const T* __restrict__ dinv, T* __restrict__ z,
                double* __restrict__ partials, const T* __restrict__ scal,
                const int* __restrict__ flags, int64_t n, int max_iter) {
  if (!loop_active(flags, max_iter)) return;
  __shared__ double s_warp[32];
  const auto R = [](float x) { return rn<T>(x); };
  const float denom = up(scal[kDenom]);
  // DENOM_GUARD rounded to T, as the comparison in T rounds it
  const bool bd = denom < rn<T>(1e-15f);
  float alpha = R(up(scal[kZr]) / (bd ? 1.f : denom));
  alpha = bd ? 0.f : alpha;
  double s_zr = 0.0;
  double s_dw = 0.0;
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
    s_zr += static_cast<double>(zz * rn_);
    s_dw += static_cast<double>(dw * dw);
  }
  const double b_zr = block_sum(s_zr, s_warp);
  const double b_dw = block_sum(s_dw, s_warp);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = b_zr;
    partials[2 * blockIdx.x + 1] = b_dw;
  }
}

dim3 k1_grid(int bm, int bn) {
  return dim3((bn + kBlockX - 1) / kBlockX, (bm + kBlockY - 1) / kBlockY);
}

int k2_blocks(int64_t n) {
  const int64_t want = (n + kK2Threads - 1) / kK2Threads;
  return static_cast<int>(want < kK2MaxBlocks ? want : kK2MaxBlocks);
}

template <typename T>
int launch_k1(const T* z, const T* p, const T* a, const T* b, const T* d,
              T* pn, T* ap, double* partials, const T* scal, const int* flags,
              int bm, int bn, int max_iter, float h1, float h2,
              void* stream) {
  if (bm < 1 || bn < 1) return static_cast<int>(cudaErrorInvalidValue);
  k1_shard_kernel<T><<<k1_grid(bm, bn), dim3(kBlockX, kBlockY), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      z, p, a, b, d, pn, ap, partials, scal, flags, bm, bn, max_iter, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k2(T* w, T* r, const T* pn, const T* ap, const T* dinv, T* z,
              double* partials, const T* scal, const int* flags, int bm,
              int bn, int max_iter, void* stream) {
  if (bm < 1 || bn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = (int64_t)bm * bn;
  k2_shard_kernel<T><<<k2_blocks(n), kK2Threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      w, r, pn, ap, dinv, z, partials, scal, flags, n, max_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks each kernel launches for one (bm, bn) block, in either form: K1
// writes one partial a block, K2 two.
int pe_fused_sharded_k1_blocks(int bm, int bn) {
  const dim3 g = k1_grid(bm, bn);
  return static_cast<int>(g.x * g.y);
}

int pe_fused_sharded_k2_blocks(int bm, int bn) {
  return k2_blocks((int64_t)bm * bn);
}

// z, p, a, b: (bm+2, bn+2); d, pn, ap: (bm, bn); partials: k1_blocks
// doubles; h1, h2 rounded to f32.
int pe_fused_sharded_k1_f32(const float* z, const float* p, const float* a,
                            const float* b, const float* d, float* pn,
                            float* ap, double* partials, const float* scal,
                            const int* flags, int bm, int bn, int max_iter,
                            float h1, float h2, void* stream) {
  return launch_k1(z, p, a, b, d, pn, ap, partials, scal, flags, bm, bn,
                   max_iter, h1, h2, stream);
}

// The bf16 form: every array and scal bf16; h1, h2 rounded to bf16.
int pe_fused_sharded_k1_bf16(const __nv_bfloat16* z, const __nv_bfloat16* p,
                             const __nv_bfloat16* a, const __nv_bfloat16* b,
                             const __nv_bfloat16* d, __nv_bfloat16* pn,
                             __nv_bfloat16* ap, double* partials,
                             const __nv_bfloat16* scal, const int* flags,
                             int bm, int bn, int max_iter, float h1, float h2,
                             void* stream) {
  return launch_k1(z, p, a, b, d, pn, ap, partials, scal, flags, bm, bn,
                   max_iter, h1, h2, stream);
}

// w, r, pn, ap, dinv, z: (bm, bn); w, r updated in place; partials:
// 2 * k2_blocks doubles.
int pe_fused_sharded_k2_f32(float* w, float* r, const float* pn,
                            const float* ap, const float* dinv, float* z,
                            double* partials, const float* scal,
                            const int* flags, int bm, int bn, int max_iter,
                            void* stream) {
  return launch_k2(w, r, pn, ap, dinv, z, partials, scal, flags, bm, bn,
                   max_iter, stream);
}

// The bf16 form: every array and scal bf16.
int pe_fused_sharded_k2_bf16(__nv_bfloat16* w, __nv_bfloat16* r,
                             const __nv_bfloat16* pn,
                             const __nv_bfloat16* ap,
                             const __nv_bfloat16* dinv, __nv_bfloat16* z,
                             double* partials, const __nv_bfloat16* scal,
                             const int* flags, int bm, int bn, int max_iter,
                             void* stream) {
  return launch_k2(w, r, pn, ap, dinv, z, partials, scal, flags, bm, bn,
                   max_iter, stream);
}

const char* pe_fused_sharded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
