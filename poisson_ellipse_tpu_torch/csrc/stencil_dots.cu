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
//
// K-f, the lane-batched form, is this kernel with the lane on gridDim.z.
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py:
// _batched_stencil_dots_kernel (launched by apply_a_dots_batched_pallas),
// the batched pipelined engine's one pass per iteration
// (poisson_ellipse_tpu/batch/batched_pipelined.py:171-183): n = A·m for B
// lanes of m with lane-shared a and b, and sums of shape (n_pairs, B).
//
// What bounds it: bytes. a and b once, each lane's m, n and the bundle's 5
// distinct operands once: (2 + 7B) passes of one lane's grid; 65.0 us at
// 401x601 f32 with B = 32, 66.6 us at 801x1201 with B = 8.
//
// Design: lane l of w, out and every pair operand lies l lane sizes into
// its array; block (x, y, l) does for lane l exactly what block (x, y)
// does in a one-lane launch, with lane l's own partials, last-block ticket
// and sums column. So lane l's n and sums[:, l] are bitwise K-d's on that
// lane. The coefficients are re-read for every lane, from L2 after the
// first (1.9 MB at 401x601; 7.7 MB at 801x1201).
//
// K-h, the mixed-precision form, is this kernel with an f32 stencil input
// m, a and b in the storage type (bf16 or f16), and up to eight distinct
// pair operands all in the storage type. Every load is upcast exactly
// (csrc/storage.cuh); the stencil, the products and the double sums are
// K-d's, so n and the sums are bitwise K-d's on the upcast inputs.
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py:
// _stencil_dots_kernel_mixed (launched by apply_a_block_dots_mixed_pallas /
// apply_a_dots_mixed_pallas), the storage-axis pipelined-pallas engine's
// one pass per iteration (poisson_ellipse_tpu/ops/pipelined_pcg.py:
// 194-218). The TPU kernel carries an f32 accumulator; here, as in K-d,
// each product is rounded to f32 and summed in double, rounded once.
//
// What bounds it: bytes. m (4 B), a and b (2 x 2 B), out (4 B) and the
// bundle's 5 distinct operands (5 x 2 B): 22 B a node, 169 MB at 2401x3201,
// 50.5 us at 3.35 TB/s.
//
// The bf16 form of K-d is this kernel with m, a, b, out and every pair
// operand in bf16, and bf16 sums. Each load is widened exactly; the
// stencil is computed in float and rounded once to bf16 where out is
// stored (K-a's bf16 form); each product of two bf16 values is exact in
// float, is widened to double and summed in double as in K-d, and each
// sum is rounded once to bf16 where it is stored (through f32, as
// PyTorch's and the JAX package's conversions from double round).
//
// Replaces: _stencil_dots_kernel at bf16 (apply_a_block_dots_pallas's call
// at pallas_kernels.py:299 with bf16 operands, whose SMEM accumulator holds
// bf16): the bf16 pipelined-pallas engine's one pass per iteration.
//
// What bounds it: bytes. 9 passes at 2 B: 138.3 MB at 2401x3201, 41.3 us
// at 3.35 TB/s.

#include <cuda_runtime.h>
#include <cstdint>

#include "storage.cuh"

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
template <typename TX>
struct Pairs {
  const TX* ptr[kMaxOperands];
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

// TW: the type of w; TC: the type of a and b; TX: the type of the pair
// operands; TO: the type of out and sums (all float for K-d and K-f)
template <typename TW, typename TC, typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
stencil_dots_kernel(const TW* __restrict__ w, const TC* __restrict__ a,
                    const TC* __restrict__ b, TO* __restrict__ out,
                    const Pairs<TX> pairs, int x_ld, int x_off,
                    double* partials, int* ticket, TO* sums, int bm,
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
  // this block's lane (0 in a one-lane launch): its slice of every array
  const int lane = blockIdx.z;
  const int lanes = gridDim.z;
  w += lane * (int64_t)(bm + 2) * ld;
  out += lane * (int64_t)om * on;
  const int64_t x_lane = lane * (int64_t)(bm + 2 * pad) * x_ld;
  partials += (int64_t)lane * pairs.n_pairs * nblocks;

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
      const float wc = up(w[c]);
      const float ax = -(up(a[c + ld]) * (up(w[c + ld]) - wc) / h1
                         - up(a[c]) * (wc - up(w[c - ld])) / h1) / h1;
      const float ay = -(up(b[c + 1]) * (up(w[c + 1]) - wc) / h2
                         - up(b[c]) * (wc - up(w[c - 1])) / h2) / h2;
      val = ax + ay;

      const int64_t xi = x_off + (int64_t)i * x_ld + j;
      float v[kMaxOperands];
#pragma unroll
      for (int o = 0; o < kMaxOperands; ++o) {
        v[o] = o < pairs.n_operands ? up(pairs.ptr[o][x_lane + xi])
                                    : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        if (p < pairs.n_pairs) {
          const float prod = pick(v, pairs.x[p]) * pick(v, pairs.y[p]);
          acc[p] += (double)prod;
        }
      }
    }
    out[(int64_t)oi * on + oj] = down<TO>(val);
  }

  const double bsum = block_sums(acc, pairs.n_pairs, s_warp);
  if (tid < pairs.n_pairs) {
    partials[(int64_t)tid * nblocks + bid] = bsum;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + lane, 1) == nblocks - 1;
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
  if (tid < pairs.n_pairs) sums[tid * lanes + lane] = down<TO>((float)total);
}

dim3 grid_of(int bm, int bn, int pad, int lanes = 1) {
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  return dim3((on + kBlockX - 1) / kBlockX, (om + kTileRows - 1) / kTileRows,
              lanes);
}

// Checks the pair table and launches ``lanes`` lanes; see the entry points.
template <typename TW, typename TC, typename TX, typename TO>
int launch(const TW* w, const TC* a, const TC* b, TO* out,
           const void* const* operands, int n_operands, const int* pair_x,
           const int* pair_y, int n_pairs, int x_ld, int x_off,
           double* partials, int* ticket, TO* sums, int lanes, int bm,
           int bn, int pad, float h1, float h2, void* stream) {
  if (n_operands < 1 || n_operands > kMaxOperands || n_pairs < 1 ||
      n_pairs > kMaxPairs || lanes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pairs<TX> pairs{};
  for (int o = 0; o < n_operands; ++o) {
    pairs.ptr[o] = static_cast<const TX*>(operands[o]);
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
  stencil_dots_kernel<TW, TC, TX, TO><<<grid_of(bm, bn, pad, lanes),
                                        dim3(kBlockX, kBlockY), 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      w, a, b, out, pairs, x_ld, x_off, partials, ticket, sums, bm, bn, pad,
      h1, h2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of one lane of a launch at (bm, bn, pad): the wrapper's partials
// scratch holds n_pairs doubles for each, in each lane.
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
  return launch<float, float, float, float>(
      w, a, b, out, operands, n_operands, pair_x, pair_y, n_pairs, x_ld,
      x_off, partials, ticket, sums, 1, bm, bn, pad, h1, h2, stream);
}

// K-f: w, out and each operand hold ``lanes`` lanes back to back; partials
// holds n_pairs * blocks doubles a lane, ticket one int a lane (all 0
// before the launch), sums is (n_pairs, lanes). Otherwise as above.
int pe_batched_stencil_dots_f32(const float* w, const float* a,
                                const float* b, float* out,
                                const void* const* operands, int n_operands,
                                const int* pair_x, const int* pair_y,
                                int n_pairs, int x_ld, int x_off,
                                double* partials, int* ticket, float* sums,
                                int lanes, int bm, int bn, int pad, float h1,
                                float h2, void* stream) {
  return launch<float, float, float, float>(
      w, a, b, out, operands, n_operands, pair_x, pair_y, n_pairs, x_ld,
      x_off, partials, ticket, sums, lanes, bm, bn, pad, h1, h2, stream);
}

// K-h: w (the stencil input m) f32; a, b and every operand in the storage
// type (bf16 or f16). Otherwise as pe_stencil_dots_f32.
int pe_stencil_dots_mixed_bf16(const float* w, const __nv_bfloat16* a,
                               const __nv_bfloat16* b, float* out,
                               const void* const* operands, int n_operands,
                               const int* pair_x, const int* pair_y,
                               int n_pairs, int x_ld, int x_off,
                               double* partials, int* ticket, float* sums,
                               int bm, int bn, int pad, float h1, float h2,
                               void* stream) {
  return launch<float, __nv_bfloat16, __nv_bfloat16, float>(
      w, a, b, out, operands, n_operands, pair_x, pair_y, n_pairs, x_ld,
      x_off, partials, ticket, sums, 1, bm, bn, pad, h1, h2, stream);
}

int pe_stencil_dots_mixed_f16(const float* w, const __half* a,
                              const __half* b, float* out,
                              const void* const* operands, int n_operands,
                              const int* pair_x, const int* pair_y,
                              int n_pairs, int x_ld, int x_off,
                              double* partials, int* ticket, float* sums,
                              int bm, int bn, int pad, float h1, float h2,
                              void* stream) {
  return launch<float, __half, __half, float>(
      w, a, b, out, operands, n_operands, pair_x, pair_y, n_pairs, x_ld,
      x_off, partials, ticket, sums, 1, bm, bn, pad, h1, h2, stream);
}

// The bf16 form: w (the stencil input m), a, b, out, every operand and
// sums in bf16; h1, h2 the bf16-rounded spacings. Otherwise as
// pe_stencil_dots_f32.
int pe_stencil_dots_bf16(const __nv_bfloat16* w, const __nv_bfloat16* a,
                         const __nv_bfloat16* b, __nv_bfloat16* out,
                         const void* const* operands, int n_operands,
                         const int* pair_x, const int* pair_y, int n_pairs,
                         int x_ld, int x_off, double* partials, int* ticket,
                         __nv_bfloat16* sums, int bm, int bn, int pad,
                         float h1, float h2, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
      w, a, b, out, operands, n_operands, pair_x, pair_y, n_pairs, x_ld,
      x_off, partials, ticket, sums, 1, bm, bn, pad, h1, h2, stream);
}

const char* pe_stencil_dots_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
