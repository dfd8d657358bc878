// K-d: the 5-point stencil A·w fused with up to eight dot products, for
// Hopper (sm_90a).
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py:_stencil_dots_kernel
// (launched by apply_a_block_dots_pallas / apply_a_dots_pallas), the
// pipelined engine's one pass per iteration: n = A·m and the iteration's
// eight-pair dot bundle (poisson_ellipse_tpu/ops/pipelined_pcg.py:219-230).
//
// Computes, for every owned node of a halo-extended (bm+2, bn+2) block,
//   out = A·w, term for term as K-a (csrc/stencil.cu) computes it, and
//   sums[p] = sum over the owned nodes of x_p * y_p, p < n_pairs,
// where the pair operands are (bm, bn) blocks, or the full (bm+2, bn+2)
// grid read on its interior (x_ld, x_off below). Built with -fmad=false:
// out is bitwise K-a's and the plain PyTorch version's.
//
// What bounds it: bytes. It reads w, a, b and each distinct pair operand
// once and writes out; for the pipelined bundle's five distinct operands
// at 2401x3201 f32 that is 9 array passes, 276.7 MB, 82.6 us at 3.35 TB/s.
// The arithmetic (18 flops for the stencil, 2 a pair) is far below the
// card's rate.
//
// Design:
// - The TPU kernel streams each of the 2*n_pairs operands as its own
//   BlockSpec (16 arrays for a bundle of 5 distinct vectors). Here the
//   wrapper passes each distinct tensor once (at most 8) and an index
//   table pair -> (x, y); a thread loads each distinct operand once into a
//   register and forms the products from those registers.
// - One thread per output node, 32x8 threads a block with threadIdx.x
//   along the contiguous column axis, each thread walking kRowsPerThread
//   rows, so a block covers a 32 x 64 tile: fewer blocks, fewer partials
//   for the final sum.
// - Sums: the TPU kernel carries an f32 accumulator across its sequential
//   grid. Here each product is rounded to f32 and widened, and summed in
//   double: per thread, then per warp by shuffles, then per block in a
//   fixed order. Each block writes its partials to global scratch; the
//   block that arrives last (atomic ticket after __threadfence, as in
//   csrc/fused_pcg.cu) adds all partials in block-index order and rounds
//   each sum once to f32. No float atomics: the order of every sum is fixed
//   by the launch shape, which depends on the shape alone, so two launches
//   give the same bits. The plain version sums the f32 products in double
//   and rounds once, so the two agree to one f32 rounding whatever the
//   order.
//
// Layouts: with pad == 0 the output is the (bm, bn) block; with pad == 1
// it is the full (bm+2, bn+2) grid with a zero ring written by the kernel.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kBlockY * kRowsPerThread;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOperands = 8;
constexpr int kMaxPairs = 8;

// The pair operands, passed by value: each distinct tensor once, and for
// each pair the indices of its two operands in ``ptr``.
struct Pairs {
  const float* ptr[kMaxOperands];
  int x[kMaxPairs];
  int y[kMaxPairs];
  int n_operands;
  int n_pairs;
};

__device__ __forceinline__ float pick(const float (&v)[kMaxOperands], int i) {
  float r = v[0];
#pragma unroll
  for (int o = 1; o < kMaxOperands; ++o) r = (i == o) ? v[o] : r;
  return r;
}

// Every thread holds acc[0..n_pairs); thread p < n_pairs returns the
// block's sum of pair p, added in a fixed order (shuffles within each
// warp, then the warps in index order).
__device__ double block_sums(double (&acc)[kMaxPairs], int n_pairs,
                             double (*s_warp)[kWarps]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    double v = acc[p];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) s_warp[p][warp] = v;
  }
  __syncthreads();
  double s = 0.0;
  if (tid < n_pairs) {
    for (int q = 0; q < kWarps; ++q) s += s_warp[tid][q];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
stencil_dots_kernel(const float* __restrict__ w, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ out,
                    const Pairs pairs, int x_ld, int x_off,
                    double* partials, int* ticket, float* sums, int bm,
                    int bn, int pad, float h1, float h2) {
  __shared__ double s_warp[kMaxPairs][kWarps];
  __shared__ int s_last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  const int oj = blockIdx.x * kBlockX + threadIdx.x;
  const int64_t ld = bn + 2;

  double acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) acc[p] = 0.0;

  for (int t = 0; t < kRowsPerThread; ++t) {
    const int oi = blockIdx.y * kTileRows + threadIdx.y + t * kBlockY;
    if (oi >= om || oj >= on) continue;
    const int i = oi - pad;
    const int j = oj - pad;
    float val = 0.0f;
    if (i >= 0 && i < bm && j >= 0 && j < bn) {
      const int64_t c = (int64_t)(i + 1) * ld + (j + 1);
      const float wc = w[c];
      const float ax = -(a[c + ld] * (w[c + ld] - wc) / h1
                         - a[c] * (wc - w[c - ld]) / h1) / h1;
      const float ay = -(b[c + 1] * (w[c + 1] - wc) / h2
                         - b[c] * (wc - w[c - 1]) / h2) / h2;
      val = ax + ay;

      const int64_t xi = x_off + (int64_t)i * x_ld + j;
      float v[kMaxOperands];
#pragma unroll
      for (int o = 0; o < kMaxOperands; ++o) {
        v[o] = o < pairs.n_operands ? pairs.ptr[o][xi] : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        if (p < pairs.n_pairs) {
          const float prod = pick(v, pairs.x[p]) * pick(v, pairs.y[p]);
          acc[p] += (double)prod;
        }
      }
    }
    out[(int64_t)oi * on + oj] = val;
  }

  const double bsum = block_sums(acc, pairs.n_pairs, s_warp);
  if (tid < pairs.n_pairs) {
    partials[(int64_t)tid * nblocks + bid] = bsum;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1) == nblocks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: every pair's partials in block-index order
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    double s = 0.0;
    if (p < pairs.n_pairs) {
      for (int q = tid; q < nblocks; q += kThreads) {
        s += __ldcg(&partials[(int64_t)p * nblocks + q]);
      }
    }
    acc[p] = s;
  }
  __syncthreads();  // s_warp is read again below
  const double total = block_sums(acc, pairs.n_pairs, s_warp);
  if (tid < pairs.n_pairs) sums[tid] = (float)total;
}

dim3 grid_of(int bm, int bn, int pad) {
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  return dim3((on + kBlockX - 1) / kBlockX, (om + kTileRows - 1) / kTileRows);
}

}  // namespace

extern "C" {

// Blocks of one launch at (bm, bn, pad): the wrapper's partials scratch
// holds n_pairs doubles for each.
int pe_stencil_dots_blocks(int bm, int bn, int pad) {
  const dim3 g = grid_of(bm, bn, pad);
  return static_cast<int>(g.x * g.y);
}

// operands: n_operands device pointers (host array); pair_x, pair_y:
// n_pairs indices into it (host arrays). ticket: one int, 0 before the
// launch. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for counts out of range.
int pe_stencil_dots_f32(const float* w, const float* a, const float* b,
                        float* out, const void* const* operands,
                        int n_operands, const int* pair_x, const int* pair_y,
                        int n_pairs, int x_ld, int x_off, double* partials,
                        int* ticket, float* sums, int bm, int bn, int pad,
                        float h1, float h2, void* stream) {
  if (n_operands < 1 || n_operands > kMaxOperands || n_pairs < 1 ||
      n_pairs > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pairs pairs{};
  for (int o = 0; o < n_operands; ++o) {
    pairs.ptr[o] = static_cast<const float*>(operands[o]);
  }
  for (int p = 0; p < n_pairs; ++p) {
    if (pair_x[p] < 0 || pair_x[p] >= n_operands || pair_y[p] < 0 ||
        pair_y[p] >= n_operands) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pairs.x[p] = pair_x[p];
    pairs.y[p] = pair_y[p];
  }
  pairs.n_operands = n_operands;
  pairs.n_pairs = n_pairs;
  stencil_dots_kernel<<<grid_of(bm, bn, pad), dim3(kBlockX, kBlockY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      w, a, b, out, pairs, x_ld, x_off, partials, ticket, sums, bm, bn, pad,
      h1, h2);
  return static_cast<int>(cudaGetLastError());
}

const char* pe_stencil_dots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
