// What the three whole-solve kernels (resident_pcg.cu, streamed_pcg.cu,
// xl_pcg.cu) share: the grid barrier, the deterministic cross-block sum,
// the scalar tail of one PCG iteration, the span halo and the march of the
// resident and streamed kernels, the timing instantiation's stamps, and
// the cooperative launch.
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
//   partials in one fixed order (grid_reduce_*). Every block runs the same
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

// doubles of shared memory each block keeps for its sums (block_sums of two
// sums: a slot a warp of a 1024-thread block and the broadcast slot, each);
// at the start of the dynamic shared memory of the resident and streamed
// kernels
constexpr int kWideDoubles = 2 * 33;
constexpr int kReduceBytes = kWideDoubles * static_cast<int>(sizeof(double));

// Status word the kernels leave for the host: iterations, converged,
// breakdown, and 1 once the kernel ran to its end (ops/whole_solve.py).
enum Status { kIters = 0, kConverged = 1, kBreakdown = 2, kDone = 3 };

__device__ __forceinline__ void grid_barrier() {
  cooperative_groups::this_grid().sync();
}

// kSums sums at once, for the xl kernel: the block's sums of v[k] in a
// fixed order (a shuffle tree in each warp, then warp 0 over the warp
// sums: block_sums), each stored as this block's partials[k], one barrier,
// and then the grid's sums of all partials, added by every thread of every
// block (thread t adds partials t, t + blockDim.x, ... in order, then the
// same block tree), each rounded once to float, in every block. One warp
// would add the partials of a 528-block grid in 17 dependent loads a lane;
// here each thread has at most a few. ``scratch`` holds kWideDoubles
// doubles of shared memory.

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
  // no __syncthreads first: every call ends in one after warp 0's last
  // read of the warp slots, and the slots the others read last (33k + 32)
  // are written only after the next call's barrier below
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

// kSums sums at once for the resident and streamed kernels, whose grid is
// one block an SM: block_sums as in grid_reduce_wide, the barrier, and
// then warp 0 alone adds the partials (lane l adds partials l, l + 32, ...
// in turn, kMaxPartials / 32 independent loads in flight, then the fixed
// shuffle tree) and broadcasts the sums with one __syncthreads, where
// grid_reduce_wide's second block_sums takes two and a tree across the
// warps. The same order in every block. ``nb`` at most kMaxPartials.
// ``after_barrier()`` runs in every thread right after the barrier: loads
// it issues of what other blocks wrote before it are in flight while warp
// 0 waits for the partials (the closing __syncthreads waits for both).
constexpr int kMaxPartials = 256;

template <int kSums, typename AfterBarrier>
__device__ __forceinline__ void grid_reduce_warp(
    double (&v)[kSums], double* const (&partials)[kSums], double* scratch,
    float (&out)[kSums], AfterBarrier&& after_barrier) {
  block_sums<kSums>(v, scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) partials[k][blockIdx.x] = v[k];
  }
  grid_barrier();
  after_barrier();
  const int nb = gridDim.x;
  if (threadIdx.x < 32) {
    double got[kSums][kMaxPartials / 32];
#pragma unroll
    for (int j = 0; j < kMaxPartials / 32; ++j) {
      const int q = threadIdx.x + 32 * j;
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        got[k][j] = q < nb ? __ldcg(partials[k] + q) : 0.0;
      }
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      double s = 0.0;
#pragma unroll
      for (int j = 0; j < kMaxPartials / 32; ++j) s += got[k][j];
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, o);
      }
      if (threadIdx.x == 0) scratch[33 * k + 32] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    out[k] = static_cast<float>(scratch[33 * k + 32]);
  }
}

template <int kSums>
__device__ __forceinline__ void grid_reduce_warp(
    double (&v)[kSums], double* const (&partials)[kSums], double* scratch,
    float (&out)[kSums]) {
  grid_reduce_warp<kSums>(v, partials, scratch, out, [] {});
}

// The span halo of the resident and streamed kernels. A block owns the
// nodes [s, s + len) of the row-major grid; its stencil needs pn one row
// (g2 nodes) beyond either end, owned by blocks whose pn is computed in
// the same phase. So each block publishes z and p for its nodes within one
// row of its span's ends (at_span_edge) in the update phase, and a
// neighbour forms pn = z + beta*p from them after the barrier
// (load_halo), with the owner's roundings in the owner's order: the same
// bits. The barrier that closes the update phase separates those writes
// from the reads, and the one that closes the stencil phase separates the
// reads from the next writes, so one buffer suffices.
__device__ __forceinline__ bool at_span_edge(int l, int len, int g2) {
  return l < g2 || l >= len - g2;
}

// The march of the resident and streamed kernels. A block reads its span
// as span-local rows of g2 nodes: node l is step t = l / g2 of the lane
// whose column is m = l % g2, and the node g2 on is the same grid column
// one grid row down (a span starts anywhere in a row, so a lane's grid
// column is its own, formed once a unit). A warp marches a strip of 32
// such columns, all its lanes on the same step, over a segment of the
// steps; a unit is a strip and a segment. The segments cut the span's
// ``rows`` steps into ``segs`` pieces of at most ``steps`` steps (a
// kernel's unrolled loop), whose sizes differ by at most one; unit u is
// strip u % strips of segment u / strips; warp w marches units w, w +
// warps, ..., at most ``per_warp`` of them, and ``warps`` is the fewest
// warps (at most ``max_warps``) that take every unit so. A lane's steps
// stop at its last node in the span (t_last), so each node of the span is
// one step of one lane of one unit (tests/test_torch_megakernels.py holds
// ops/whole_solve.py:march_nodes, this split's mirror, to it). No
// division a node, nor a unit where the strips are not cut (segs = 1).
struct MarchSplit {
  int strips;    // 32-column strips over the first min(span, g2) columns
  int segs;      // segments each strip's steps are cut into
  int rows;      // steps of the span's longest lane: ceil(span / g2)
  int warps;     // warps a block
  int per_warp;  // units a warp marches, at most
};

inline MarchSplit march_split(int span, int g2, int steps, int max_warps) {
  MarchSplit sp;
  const int width = span < g2 ? span : g2;
  sp.strips = (width + 31) / 32;
  sp.rows = (span + g2 - 1) / g2;
  sp.segs = (sp.rows + steps - 1) / steps;
  const int units = sp.strips * sp.segs;
  sp.warps = units < max_warps ? units : max_warps;
  sp.per_warp = (units + sp.warps - 1) / sp.warps;
  sp.warps = (units + sp.per_warp - 1) / sp.per_warp;
  return sp;
}

// A block's span of ``len`` nodes from node s: whole span-local rows and
// the rest (lanes m < lr have lq + 1 steps, the others lq), and the grid
// row and column of its first node.
struct SpanGeom {
  int lq, lr, srow, scol;
};

__device__ __forceinline__ SpanGeom span_geom(int s, int len, int g2) {
  SpanGeom g;
  g.lq = len / g2;
  g.lr = len - g.lq * g2;
  g.srow = s / g2;
  g.scol = s - g.srow * g2;
  return g;
}

// A warp's units in turn: (strip, seg) of its first, then ``warps`` on;
// a unit exists while seg < segs.
struct UnitIter {
  int strip, seg;
};

__device__ __forceinline__ UnitIter first_unit(const MarchSplit& sp,
                                               int warp) {
  UnitIter it;
  it.seg = warp / sp.strips;
  it.strip = warp - it.seg * sp.strips;
  return it;
}

__device__ __forceinline__ void next_unit(const MarchSplit& sp,
                                          UnitIter& it) {
  it.strip += sp.warps;
  while (it.strip >= sp.strips) {
    it.strip -= sp.strips;
    ++it.seg;
  }
}

// One lane's part of a unit: its column m, the unit's steps [t0, t1)
// clipped to its own last step t_last, whether it has any, and the grid
// row and column of its node at t0.
struct MarchUnit {
  int m, t0, t1, t_last, row, col;
  bool active;
};

__device__ __forceinline__ MarchUnit march_unit(const MarchSplit& sp,
                                                UnitIter it, int lane, int g2,
                                                const SpanGeom& g) {
  MarchUnit mu;
  mu.m = 32 * it.strip + lane;
  int t1 = sp.rows;
  mu.t0 = 0;
  if (sp.segs > 1) {
    mu.t0 = it.seg * sp.rows / sp.segs;
    t1 = (it.seg + 1) * sp.rows / sp.segs;
  }
  mu.t_last = g.lq - (mu.m >= g.lr ? 1 : 0);
  mu.t1 = min(t1, mu.t_last + 1);
  mu.active = it.seg < sp.segs && mu.m < g2 && mu.t0 < mu.t1;
  const int c = g.scol + mu.m;  // below 2 * g2
  const bool wrap = c >= g2;
  mu.col = wrap ? c - g2 : c;
  mu.row = g.srow + mu.t0 + (wrap ? 1 : 0);
  return mu;
}

// The published z (and p, where ``ppub`` is given) of a unit's halo nodes:
// one row above the lane's first node where the unit starts the lane's
// column, and one row below its last node where the unit ends it (0 where
// there is none). Without ``ppub`` the caller holds p there itself: the pn
// it formed at the same node the iteration before, which is the owner's p
// bit for bit (the same expression on the same values), so only z moves.
struct UnitHalo {
  float zn, pn, zs, ps;
};

__device__ __forceinline__ UnitHalo load_halo(const MarchUnit& mu,
                                              const float* zpub,
                                              const float* ppub, int s,
                                              int g2, int n) {
  UnitHalo h{0.f, 0.f, 0.f, 0.f};
  if (!mu.active) return h;
  const int first = s + mu.m + mu.t0 * g2;
  if (mu.t0 == 0 && first >= g2) {
    h.zn = __ldcg(zpub + first - g2);
    if (ppub != nullptr) h.pn = __ldcg(ppub + first - g2);
  }
  const int below = s + mu.m + (mu.t_last + 1) * g2;
  if (mu.t1 > mu.t_last && below < n) {
    h.zs = __ldcg(zpub + below);
    if (ppub != nullptr) h.ps = __ldcg(ppub + below);
  }
  return h;
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

// The device clock in ns (%globaltimer), the same on every SM.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The timing instantiation of the resident and streamed kernels
// (kStamps; chip_smoke.py --only whole-timing, no engine runs it). Body i
// writes row i of ``stamps``, kWholeStamps + 2 * gridDim.x u64: block 0
// the start of the body (k = 0), the end of its pn pass (1), of its
// stencil phase (2), the return of the first grid sum (3), the end of its
// update phase (4) and the return of the second sums (5); every block b
// the end of its own stencil phase (kWholeStamps + b) and update phase
// (kWholeStamps + gridDim.x + b), except that body 0's stencil slots hold
// each block's SM plus one. A phase's end is taken after a
// __syncthreads, so it is the block's.
constexpr int kWholeStamps = 6;
enum WholeStamp {
  kBodyStart = 0,
  kPnEnd = 1,
  kStencilEnd = 2,
  kSum1 = 3,
  kUpdateEnd = 4,
  kSum2 = 5,
};

template <bool kStamps>
__device__ __forceinline__ void whole_stamp(unsigned long long* stamps,
                                            int i, int k, bool sync) {
  if (kStamps) {
    if (sync) __syncthreads();
    if (threadIdx.x != 0) return;
    unsigned long long* row =
        stamps + (long long)i * (kWholeStamps + 2 * gridDim.x);
    const unsigned long long t = global_ns();
    if (blockIdx.x == 0) row[k] = t;
    if (k == kStencilEnd) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      row[kWholeStamps + blockIdx.x] = i == 0 ? sm + 1 : t;
    } else if (k == kUpdateEnd) {
      row[kWholeStamps + gridDim.x + blockIdx.x] = t;
    }
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
