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
// card's rate, but not its instruction cost: the first form of this kernel
// (one thread a node, each operand picked from eight registers by a
// runtime index, six divisions a node, every neighbour loaded again) ran
// at 37% of the bound, paced by its instructions and not by its bytes.
//
// Design:
// - A warp owns 32 columns (a lane a column, so each row of each array is
//   one coalesced 128-byte read) and marches down kRows rows; a block
//   stacks kWarps warps down the rows. kRows is 16, or 8 where tiles of
//   16 rows would give a lane fewer blocks than an H100 has SMs (rows_of:
//   at 401x601 on an H100, 76 blocks of 16-row tiles left 56 SMs idle,
//   and K-d took 20.8 us against 13.3 with 8 rows and 10.1 with 4; K-f,
//   B = 32, 127.4, 121.3 and 134.5: PERF.md, section 6). The grid, and
//   so the split of the nodes and the order of every sum, is a function
//   of the shape alone: not of the card, the dtype, the table, the lanes
//   or any pointer's alignment.
// - Face fluxes are computed once (stencil_tree.cuh: a face's flux is the
//   same expression from either node beside it). A lane keeps w's current
//   row and carries the north flux down from the row above, so it loads w
//   and a once a row (not 3 and 2 times) and divides 4 times a node (not
//   6). The west flux comes from w one lane to the west (a shuffle); the
//   east flux is the next lane's west flux (a shuffle). The two values a
//   warp's edge lanes lack (w one column west of lane 0; the flux one
//   column east of lane 31) are computed once a tile, lane k for row k,
//   and broadcast a row at a time.
// - Loads: scalar, through the read-only path; a ring of the next kAhead
//   rows is in flight while a row is computed; out is stored streaming
//   (st.global.cs). The published pitch (3201 floats, 12 804 B) is not
//   16-byte aligned, so every row starts in another vector alignment
//   class: scalar loads keep the node split independent of it. At 80
//   registers a thread (3 blocks of 256 an SM) more rows in flight, fewer
//   warps, 32-bit offsets from a shared base, a reciprocal of h hoisted
//   out of the division, and L2 prefetch or evict-first hints all ran
//   slower or no faster (PERF.md, section 6).
// - Warps whose tile is all nodes take a march with no masks where the
//   pair operands are narrow (kUnmaskedInterior): a row is about 150
//   instructions there against about 220 masked.
// - The pair table: the pipelined bundle's (8 pairs over 5 distinct
//   operands, ops/pipelined_pcg.py:_bundle, in the order
//   hopper_kernels.distinct_operands numbers them) is compiled in
//   (bundle_x/bundle_y), so each product reads its two registers directly;
//   the launcher runs it for a table that is this one index for index.
//   Any other table of at most 8 pairs over at most 8 operands takes the
//   generic instantiation, which picks operands by index at run time.
//   Both add every product in the same place in the same order, so the
//   bundle and the bundle with each pair's operands swapped (a generic
//   table: f32 products commute) give the same bits.
// - Sums: each product is rounded to the compute type and widened, and
//   summed in double: per lane down its rows, then per warp by shuffles,
//   then the block's warps in index order. Each block writes its partials
//   to global scratch; the block that arrives last (atomic ticket after
//   __threadfence) adds all partials in a fixed order, rounds each sum
//   once, and writes the ticket back to 0, so the scratch is zeroed once
//   and reused (ops/scratch.py): a call is one kernel. No float atomics:
//   two launches give the same bits. The plain version sums the rounded
//   products in double and rounds once, so the two agree to one rounding
//   whatever the order.
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
#include <type_traits>

#include "stencil_tree.cuh"
#include "storage.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block, stacked down the rows
constexpr int kMaxRows = 16;  // rows a warp marches (at most 32: one a lane)
constexpr int kFillBlocks = 132;  // a block for each of an H100's SMs
constexpr int kAhead = 2;  // rows whose loads are in flight behind a row
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;  // blocks an SM holds: at most 80 registers
constexpr int kMaxOperands = 8;
constexpr int kMaxPairs = 8;

static_assert(kMaxRows <= 32, "the edge values are held one row a lane");

// Whether a warp whose tile is all nodes takes a march with no masks: for
// narrow pair operands (K-h, K-d's bf16 form) it does. With f32 operands
// the same march spills at 80 registers and ran slower (PERF.md,
// section 6).
template <typename TX>
constexpr bool kUnmaskedInterior = sizeof(TX) < 4;

// The pipelined bundle's pair table, (r, u), (w, u), (w, p), (s, u),
// (s, p), (u, u), (u, p), (p, p) over the operands numbered by first use
// (r 0, u 1, w 2, p 3, s 4); poisson_ellipse_tpu_torch/ops/
// hopper_kernels.distinct_operands numbers ops/pipelined_pcg.py:_bundle so.
constexpr int kBundleOperands = 5;
constexpr int kBundlePairs = 8;
__host__ __device__ constexpr int bundle_x(int p) {
  constexpr int x[kBundlePairs] = {0, 2, 2, 4, 4, 1, 1, 3};
  return x[p];
}
__host__ __device__ constexpr int bundle_y(int p) {
  constexpr int y[kBundlePairs] = {1, 1, 3, 1, 3, 1, 3, 3};
  return y[p];
}

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

// out, written once: a streaming store.
__device__ __forceinline__ void st_once(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;" ::"l"(p), "f"(v));
}
__device__ __forceinline__ void st_once(__nv_bfloat16* p, __nv_bfloat16 v) {
  asm volatile("st.global.cs.b16 [%0], %1;" ::"l"(p),
               "h"(__bfloat16_as_ushort(v)));
}

// Every thread holds acc[0..n_pairs); thread p < n_pairs returns the
// block's sum of pair p, added in a fixed order (shuffles within each
// warp, then the warps in index order).
__device__ double block_sums(double (&acc)[kMaxPairs], int n_pairs,
                             double (*s_warp)[kWarps]) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    if (p < n_pairs) {
      double v = acc[p];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
      if (lane == 0) s_warp[p][warp] = v;
    }
  }
  __syncthreads();
  double s = 0.0;
  if (tid < n_pairs) {
    for (int q = 0; q < kWarps; ++q) s += s_warp[tid][q];
  }
  return s;
}

// TW: the type of w; TC: the type of a and b; TX: the type of the pair
// operands; TO: the type of out and sums (all float for K-d and K-f).
// kBundle: the pair table is the compiled bundle's; kRows: rows_of.
template <typename TW, typename TC, typename TX, typename TO, bool kBundle,
          int kRows>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stencil_dots_kernel(const TW* __restrict__ w, const TC* __restrict__ a,
                    const TC* __restrict__ b, TO* __restrict__ out,
                    const Pairs<TX> pairs, int x_ld, int x_off,
                    double* partials, int* ticket, TO* sums, int bm,
                    int bn, int pad, float h1, float h2) {
  constexpr int kTileRows = kWarps * kRows;
  __shared__ double s_warp[kMaxPairs][kWarps];
  __shared__ int s_last;
  const int n_ops = kBundle ? kBundleOperands : pairs.n_operands;
  const int n_pairs = kBundle ? kBundlePairs : pairs.n_pairs;
  const int lane_id = threadIdx.x;
  const int tid = threadIdx.y * 32 + lane_id;
  const int nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  const int64_t ld = bn + 2;
  // this block's lane (0 in a one-lane launch): its slice of every array
  const int lane = blockIdx.z;
  const int lanes = gridDim.z;
  w += lane * (int64_t)(bm + 2) * ld;
  out += lane * (int64_t)om * on;
  const int64_t x_lane = lane * (int64_t)(bm + 2 * pad) * x_ld;
  partials += (int64_t)lane * n_pairs * nblocks;

  // this lane's output column oj and extended column c; lane 0's column
  const int oj = blockIdx.x * 32 + lane_id;
  const int c = oj + 1 - pad;
  const int c0 = c - lane_id;
  // w, a and b exist at column c; c holds a node; out has column oj
  const bool col_in = c <= bn + 1;
  const bool col_node = c >= 1 && c <= bn;
  const bool col_out = oj < on;
  // the warp's first output row and its extended row
  const int oi0 = blockIdx.y * kTileRows + threadIdx.y * kRows;
  const int r0 = oi0 + 1 - pad;

  double acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) acc[p] = 0.0;

  if (oi0 < om) {
    // lane k holds row r0 + k's edge values: w one column west of lane 0
    // and the west flux one column east of lane 31 (the east flux of
    // lane 31's node)
    float edge_w = 0.0f;
    float edge_f = 0.0f;
    {
      const int r = r0 + lane_id;
      const int ce = c0 + 32;
      if (lane_id < kRows && r <= bm + 1) {
        const int64_t row = (int64_t)r * ld;
        if (c0 >= 1) edge_w = up(__ldg(w + row + c0 - 1));
        if (ce <= bn + 1) {
          edge_f = face_flux(up(__ldg(b + row + ce)), up(__ldg(w + row + ce)),
                             up(__ldg(w + row + ce - 1)), h2);
        }
      }
    }
    // row r0's w and its north flux (the south flux of row r0 - 1)
    int64_t rc = (int64_t)r0 * ld + c;
    float wc = 0.0f;
    float f_n = 0.0f;
    if (col_in) {
      wc = up(__ldg(w + rc));
      if (r0 >= 1) f_n = face_flux(up(__ldg(a + rc)), wc,
                                   up(__ldg(w + rc - ld)), h1);
    }
    // the row a step loads: w and a one row down, b and the pair
    // operands at the node
    struct Row {
      float w_s, a_s, b_c;
      float v[kMaxOperands];
    };
    // the march over the warp's rows; kIn: every lane a node column and
    // every row a node row, so no load or store is masked
    auto march = [&](auto interior) {
      constexpr bool kIn = decltype(interior)::value;
      auto load = [&](int r, int64_t at, Row& row) {
        const bool in = kIn || (col_in && r <= bm + 1);
        const bool down_in = kIn || (col_in && r + 1 <= bm + 1);
        row.w_s = down_in ? up(__ldg(w + at + ld)) : 0.0f;
        row.a_s = down_in ? up(__ldg(a + at + ld)) : 0.0f;
        row.b_c = in ? up(__ldg(b + at)) : 0.0f;
        const bool node = kIn || (col_node && r >= 1 && r <= bm);
        const int64_t xi = x_lane + x_off + (int64_t)(r - 1) * x_ld + (c - 1);
#pragma unroll
        for (int o = 0; o < kMaxOperands; ++o) {
          row.v[o] = (node && o < n_ops) ? up(__ldg(pairs.ptr[o] + xi))
                                         : 0.0f;
        }
      };
      // a ring of the next kAhead rows: a step loads the row kAhead down
      // into the slot it has just taken its own row from
      Row ring[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        ring[k] = Row{};
        if (k < kRows && (kIn || oi0 + k < om)) {
          load(r0 + k, rc + k * ld, ring[k]);
        }
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const int oi = oi0 + t;
        if (!kIn && oi >= om) break;
        const int r = r0 + t;
        const Row cur = ring[t % kAhead];
        if (t + kAhead < kRows && (kIn || oi + kAhead < om)) {
          load(r + kAhead, rc + kAhead * ld, ring[t % kAhead]);
        }
        // the four face fluxes of node (r, c)
        const float f_s = face_flux(cur.a_s, cur.w_s, wc, h1);
        float w_w = __shfl_up_sync(kFull, wc, 1);
        const float e_w = __shfl_sync(kFull, edge_w, t);
        if (lane_id == 0) w_w = e_w;
        const float f_w = face_flux(cur.b_c, wc, w_w, h2);
        float f_e = __shfl_down_sync(kFull, f_w, 1);
        const float e_f = __shfl_sync(kFull, edge_f, t);
        if (lane_id == 31) f_e = e_f;
        float val = 0.0f;
        if (kIn || (col_node && r >= 1 && r <= bm)) {
          val = stencil_of_fluxes(f_s, f_n, f_e, f_w, h1, h2);
#pragma unroll
          for (int p = 0; p < kMaxPairs; ++p) {
            if (kBundle) {
              acc[p] += (double)(cur.v[bundle_x(p)] * cur.v[bundle_y(p)]);
            } else if (p < n_pairs) {
              acc[p] += (double)(pick(cur.v, pairs.x[p]) *
                                 pick(cur.v, pairs.y[p]));
            }
          }
        }
        if (kIn || col_out) {
          st_once(out + (int64_t)oi * on + oj, down<TO>(val));
        }
        f_n = f_s;
        wc = cur.w_s;
        rc += ld;
      }
    };
    // warp-uniform: the tile's columns c0 .. c0+31 and rows r0 ..
    // r0+kRows-1 are all nodes
    if (kUnmaskedInterior<TX> && c0 >= 1 && c0 + 31 <= bn && r0 >= 1 &&
        r0 + kRows - 1 <= bm) {
      march(std::true_type{});
    } else {
      march(std::false_type{});
    }
  }

  const double bsum = block_sums(acc, n_pairs, s_warp);
  if (tid < n_pairs) {
    partials[(int64_t)tid * nblocks + bid] = bsum;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + lane, 1) == nblocks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every block has taken its ticket: leave it 0 for the next launch
  if (tid == 0) ticket[lane] = 0;

  // the last block: every pair's partials in a fixed order
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    double s = 0.0;
    if (p < n_pairs) {
      for (int q = tid; q < nblocks; q += kThreads) {
        s += __ldcg(&partials[(int64_t)p * nblocks + q]);
      }
    }
    acc[p] = s;
  }
  __syncthreads();  // s_warp is read again below
  const double total = block_sums(acc, n_pairs, s_warp);
  if (tid < n_pairs) sums[tid * lanes + lane] = down<TO>((float)total);
}

// Rows a warp marches at (bm, bn, pad): kMaxRows, or half as many where
// a lane's grid of kMaxRows-row tiles holds fewer than kFillBlocks blocks.
int rows_of(int bm, int bn, int pad) {
  const int cols = (bn + 2 * pad + 31) / 32;
  const int tile = kWarps * kMaxRows;
  const int tiles = (bm + 2 * pad + tile - 1) / tile;
  return cols * tiles < kFillBlocks ? kMaxRows / 2 : kMaxRows;
}

dim3 grid_of(int bm, int bn, int pad, int lanes = 1) {
  const int tile = kWarps * rows_of(bm, bn, pad);
  return dim3((bn + 2 * pad + 31) / 32, (bm + 2 * pad + tile - 1) / tile,
              lanes);
}

// Checks the pair table, picks the instantiation (the compiled bundle's
// for its table, else the generic one; rows_of's rows) and launches
// ``lanes`` lanes; see the entry points.
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
  bool is_bundle = n_operands == kBundleOperands && n_pairs == kBundlePairs;
  for (int p = 0; p < n_pairs; ++p) {
    if (pair_x[p] < 0 || pair_x[p] >= n_operands || pair_y[p] < 0 ||
        pair_y[p] >= n_operands) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pairs.x[p] = pair_x[p];
    pairs.y[p] = pair_y[p];
    is_bundle = is_bundle && pair_x[p] == bundle_x(p) &&
                pair_y[p] == bundle_y(p);
  }
  pairs.n_operands = n_operands;
  pairs.n_pairs = n_pairs;
  const dim3 grid = grid_of(bm, bn, pad, lanes);
  const dim3 block(32, kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto bundle, auto rows) {
    stencil_dots_kernel<TW, TC, TX, TO, decltype(bundle)::value,
                        decltype(rows)::value><<<grid, block, 0, s>>>(
        w, a, b, out, pairs, x_ld, x_off, partials, ticket, sums, bm, bn,
        pad, h1, h2);
  };
  auto rows_for = [&](auto bundle) {
    if (rows_of(bm, bn, pad) == kMaxRows) {
      run(bundle, std::integral_constant<int, kMaxRows>{});
    } else {
      run(bundle, std::integral_constant<int, kMaxRows / 2>{});
    }
  };
  if (is_bundle) {
    rows_for(std::true_type{});
  } else {
    rows_for(std::false_type{});
  }
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
// n_pairs indices into it (host arrays); the pipelined bundle's table runs
// compiled in, any other the generic instantiation.
// partials: n_pairs * blocks doubles; ticket: one int, 0 before the first
// launch, left 0 by each launch. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for counts or a table out of range.
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
// before the first launch, left 0), sums is (n_pairs, lanes). Otherwise as
// above.
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
