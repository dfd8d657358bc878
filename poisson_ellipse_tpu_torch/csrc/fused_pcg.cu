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
// passes, 82.6 us at 3.35 TB/s; 41.3 us in bf16); K2 reads w, r, pn, ap,
// dinv and writes w, r, z (8 passes, 73.4 us). The arithmetic is a few
// flops per byte.
//
// Design:
// - K1 f32 works on 32x32 tiles (32x8 threads, 4 rows each). It builds pn
//   over the tile plus a one-node halo in shared memory, recomputing the
//   halo's pn from z and p at the neighbour instead of making a second
//   pass over an updated p. Nodes outside the grid read as 0 (never
//   clamped values). The TPU kernel's 8-row neighbour BlockSpecs and its
//   (8,128) padding have no counterpart: arrays are the unpadded (M+1,
//   N+1) grid.
// - K1 bf16 marches (k1_march_kernel, the pieces in pn_march.cuh): a lane
//   owns two columns, one 4-byte word of each array, so a warp's load of
//   a row moves 128 B where the tile kernel's 2-byte loads moved 64; a
//   warp marches a 64-column strip down march_rows rows, forming pn once a
//   node from z and p as it goes (north and south from its registers, west
//   and east by shuffles, the strip's two edge columns recomputed by the
//   edge lanes, the row above the unit once), with no shared memory, no
//   barrier and no integer division a node. At an odd width the rows
//   alternate between two word frames; a row moves into the other frame
//   through the same shuffles as its west or east neighbours. A row's
//   seven loads are issued a trip (kMarchAhead rows) ahead, and a unit's
//   first loads and its edges together. The grid is a warp a unit, 8 units
//   a block (963 blocks at 2401x3201, where the tile kernel took 7676; 4
//   rows a unit at 401x601, 127 blocks, where 16 would leave 99 SMs idle),
//   so the last block adds hundreds of partials and an early return costs
//   less. Every unit takes one masked path. Measured on the H100 (PERF.md,
//   section 6): the tile kernel's tail (the ticket and the last block
//   adding 7676 partials) was 21-23 us of its 90; a fully unrolled march
//   ran 126 us (8000 instructions, bound by instruction fetch); a masked
//   word built from two loads where they were issued, or two predicated
//   loads into one register, made every masked unit wait out its loads
//   (67.5 against 60.2 us); an acq_rel ticket in place of the fences, 2 or
//   4 rows ahead, 2 to 4 blocks an SM and a separate unmasked path for
//   interior units all landed within 59.8-62.7 us.
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
#include <type_traits>

#include "pn_march.cuh"
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

// What a K1 launch runs: the kernel (kWhole), or, in the timing
// instantiation that no engine launches, its tile pass with each block's
// own sum and partial but no ticket and no last block (kTile), or the
// ticket, the last block's sum of the partials and the scalar tail alone,
// each block contributing a zero partial (kTail).
enum Part { kWhole = 0, kTile = 1, kTail = 2 };

constexpr int kTileX = 32;
constexpr int kTileY = 32;
constexpr int kK1ThreadsY = 8;
// K1 bf16's march: warps a block, rows a trip (their loads issued a trip
// ahead), blocks an SM; the rows a warp marches (march_rows, even, so every
// unit starts in frame 0; at most 30, lane k holding row r0 - 1 + k's
// edges) are kMaxMarchRows, or half or a quarter as many where the grid
// of those units would give fewer than kFillBlocks blocks.
constexpr int kMarchWarps = 8;
constexpr int kMarchAhead = 4;
constexpr int kMarchMinBlocks = 2;
constexpr int kMaxMarchRows = 16;
constexpr int kFillBlocks = 132;  // a block for each of an H100's SMs
static_assert(kMaxMarchRows % kMarchAhead == 0 && kMaxMarchRows + 2 <= 32,
              "the march's rows");

// units (strips x row tiles of ``rows``) and blocks of the march
int64_t march_units(int g1, int g2, int rows) {
  return (int64_t)pn_march::strips(g2) * ((g1 + rows - 1) / rows);
}
int march_rows(int g1, int g2) {
  int rows = kMaxMarchRows;
  while (rows > kMarchAhead &&
         march_units(g1, g2, rows) < (int64_t)kFillBlocks * kMarchWarps) {
    rows /= 2;
  }
  return rows;
}
int march_blocks(int g1, int g2) {
  const int64_t units = march_units(g1, g2, march_rows(g1, g2));
  return static_cast<int>((units + kMarchWarps - 1) / kMarchWarps);
}
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

// K1's sums after its pass: the block's sum of acc to its partial, and in
// the block that arrives last, the sum of every block's partial in block
// order and the scalar tail (denominator, alpha, the pending breakdown).
// kTile stops after the partial.
template <typename T, int P>
__device__ __forceinline__ void k1_sums(typename Acc<T>::type acc,
                                        typename Acc<T>::type* partials,
                                        T* scal, int* flags, float h1,
                                        float h2,
                                        typename Acc<T>::type* s_warp,
                                        int* s_last) {
  using A = typename Acc<T>::type;
  const auto R = [](float x) { return rn<T>(x); };
  const int tid = thread_rank();
  const A bsum = block_sum(acc, s_warp);
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const int nblocks = gridDim.x * gridDim.y;
  if (tid == 0) partials[block] = bsum;
  if (P == kTile) return;
  if (!arrive_last(&flags[kTicketK1], nblocks, s_last)) return;
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

template <typename T, int P>
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
  for (int q = tid; P != kTail && q < (kTileY + 2) * (kTileX + 2);
       q += nthreads) {
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
  for (int r = threadIdx.y; P != kTail && r < kTileY; r += blockDim.y) {
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

  k1_sums<T, P>(acc, partials, scal, flags, h1, h2, s_warp, &s_last);
}

// One warp's unit of K1 bf16's march: strip s (pn_march.cuh) down rows
// r0 .. r0 + rows - 1, r0 even, kMarchAhead rows a trip so that each row's
// frame is known where it is compiled: at an odd g2 (kOdd) row r0 + t is
// in frame t & 1, else every row in frame 0. A row's loads are issued a
// trip ahead. A lane's masks are fixed by the frame; a row outside the
// grid is skipped by the whole warp.
template <bool kOdd>
__device__ __forceinline__ void march_unit(
    const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ p,
    const __nv_bfloat16* __restrict__ an,
    const __nv_bfloat16* __restrict__ as_,
    const __nv_bfloat16* __restrict__ bw,
    const __nv_bfloat16* __restrict__ be,
    const __nv_bfloat16* __restrict__ d, __nv_bfloat16* __restrict__ pn,
    __nv_bfloat16* __restrict__ ap, int g1, int g2, int r0, int rows, int s,
    float beta, double& acc) {
  namespace pm = pn_march;
  using X = pm::Two;
  using W = X::W;
  constexpr int kA = kMarchAhead;
  // the frame of the other parity's rows
  constexpr int kOther = kOdd ? 1 : 0;
  const int lane = threadIdx.x & 31;
  // lane's first column in frame 0; its word in row r0 + t in frame f
  // starts at element base + t*g2 - f
  const int c0 = pm::kStrip * s + 2 * lane;
  const int base = r0 * g2 + c0;
  const int64_t n = (int64_t)g1 * g2;
  // which halves of the lane's word are columns of the grid, by frame
  const bool vx0 = c0 < g2, vy0 = c0 + 1 < g2;
  const bool vx1 = c0 >= 1 && c0 - 1 < g2, vy1 = c0 < g2;
  const auto row_in = [&](int t) { return r0 + t >= 0 && r0 + t < g1; };
  // the word of ``a`` in row r0 + t (frame f), 0 where neither half is in
  // the grid; ``last``: the grid's last row of an odd-length array, whose
  // last word holds one element
  const auto word = [&](const __nv_bfloat16* a, int t, int f,
                        bool last) -> W {
    const int o = base + t * g2 - f;
    const bool x = row_in(t) && (f ? vx1 : vx0);
    const bool y = row_in(t) && (f ? vy1 : vy0);
    return last ? X::load_end(a, o, n, x, y) : X::load(a + o, x || y);
  };
  const auto last_row = [&](int t) { return (n & 1) && r0 + t == g1 - 1; };
  // pn of row r0 + t in frame f, +0 outside the grid
  const auto pn_row = [&](W zw, W pw, int t, int f) -> W {
    return row_in(t) ? X::keep(pm::pn_of(zw, pw, beta), f ? vx1 : vx0,
                               f ? vy1 : vy0)
                     : 0u;
  };

  // step t: z and p of row t + 1, the coefficients of row t (frame f); a
  // step that reaches the last row of an odd-length array reads that row's
  // last word element by element (warp-uniform)
  struct Step {
    W z, p, an, as, bw, be, d;
  };
  const auto load = [&](int t, int f, Step& st) {
    const int fn = kOdd ? 1 - f : 0;
    const auto fill = [&](bool end_z, bool end_c) {
      st.z = word(z, t + 1, fn, end_z);
      st.p = word(p, t + 1, fn, end_z);
      st.an = word(an, t, f, end_c);
      st.as = word(as_, t, f, end_c);
      st.bw = word(bw, t, f, end_c);
      st.be = word(be, t, f, end_c);
      st.d = word(d, t, f, end_c);
    };
    if (last_row(t) || last_row(t + 1)) {
      fill(last_row(t + 1), last_row(t));
    } else {
      fill(false, false);
    }
  };
  // every load of the first trip, rows r0 - 1 and r0, and the edges
  // issued before any is used
  Step ring[kA];
#pragma unroll
  for (int k = 0; k < kA; ++k) load(k, k & kOther, ring[k]);
  const W z_m1 = word(z, -1, kOther, false);
  const W p_m1 = word(p, -1, kOther, false);
  const W z_0 = word(z, 0, 0, last_row(0)), p_0 = word(p, 0, 0, last_row(0));
  // lane k: the edges of row r0 - 1 + k, pn one column west of the
  // strip's first column and one east of its last, in the row's frame
  __nv_bfloat16 ez_w, ep_w, ez_e, ep_e;
  bool in_w, in_e;
  {
    const int i = r0 - 1 + lane;
    const bool row = lane < rows + 2 && i >= 0 && i < g1;
    const int o = kOdd ? (i & 1) : 0;
    const int cw = pm::kStrip * s - o - 1;
    const int ce = pm::kStrip * (s + 1) - o;
    const int64_t at = (int64_t)i * g2;
    in_w = row && cw >= 0;
    in_e = row && ce < g2;
    const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
    ez_w = in_w ? __ldg(z + at + cw) : zero;
    ep_w = in_w ? __ldg(p + at + cw) : zero;
    ez_e = in_e ? __ldg(z + at + ce) : zero;
    ep_e = in_e ? __ldg(p + at + ce) : zero;
  }
  const float e_w =
      in_w ? rn<__nv_bfloat16>(up(ez_w) + beta * up(ep_w)) : 0.f;
  const float e_e =
      in_e ? rn<__nv_bfloat16>(up(ez_e) + beta * up(ep_e)) : 0.f;
  // the edges of row r0 + t, held by lane t + 1
  const auto edges = [&](int t, float& ew, float& ee) {
    ew = __shfl_sync(pm::kFull, e_w, t + 1);
    ee = __shfl_sync(pm::kFull, e_e, t + 1);
  };

  // row r0 - 1 (frame kOther), moved into frame 0 as row r0's north
  // neighbours
  float2 n_c;
  {
    const float2 r = X::unpack(pn_row(z_m1, p_m1, -1, kOther));
    float ew, ee;
    edges(-1, ew, ee);
    n_c = kOdd ? pm::east(r, ee, lane) : r;
  }
  // row r0: pn, its west and east neighbours
  W pw_c = pn_row(z_0, p_0, 0, 0);
  float2 r_c = X::unpack(pw_c), w_c, e_c;
  {
    float ew, ee;
    edges(0, ew, ee);
    w_c = pm::west(r_c, ew, lane);
    e_c = pm::east(r_c, ee, lane);
  }

  // row t (frame F) on the loads of its step; the step a trip later is
  // loaded into its slot
  const auto step = [&](int t, Step& slot, auto frame) {
    constexpr int F = decltype(frame)::value;
    constexpr int Fn = kOdd ? 1 - F : 0;
    const Step cur = slot;
    if (t + kA < rows) load(t + kA, F, slot);
    // row t + 1: pn and its neighbours, and moved into row t's frame
    const W pw_n = pn_row(cur.z, cur.p, t + 1, Fn);
    const float2 r_n = X::unpack(pw_n);
    float ew, ee;
    edges(t + 1, ew, ee);
    const float2 w_n = pm::west(r_n, ew, lane);
    const float2 e_n = pm::east(r_n, ee, lane);
    const float2 s_c = !kOdd ? r_n : Fn ? e_n : w_n;
    // row t: ap = d*pn - (an*pn_n + as*pn_s + bw*pn_w + be*pn_e)
    const float2 cd = X::unpack(cur.d), can = X::unpack(cur.an);
    const float2 cas = X::unpack(cur.as), cbw = X::unpack(cur.bw);
    const float2 cbe = X::unpack(cur.be);
    const W aw = X::pack(
        cd.x * r_c.x - (can.x * n_c.x + cas.x * s_c.x + cbw.x * w_c.x +
                        cbe.x * e_c.x),
        cd.y * r_c.y - (can.y * n_c.y + cas.y * s_c.y + cbw.y * w_c.y +
                        cbe.y * e_c.y));
    const float2 av = X::unpack(aw);
    const int o = base + t * g2 - F;
    const bool x = F ? vx1 : vx0, y = F ? vy1 : vy0;
    X::store(pn + o, pw_c, x, y);
    X::store(ap + o, aw, x, y);
    // each product in float, added in double
    if (x) acc += av.x * r_c.x;
    if (y) acc += av.y * r_c.y;
    // row t moved into row t + 1's frame: its north neighbours
    n_c = !kOdd ? r_c : F ? e_c : w_c;
    pw_c = pw_n;
    r_c = r_n;
    w_c = w_n;
    e_c = e_n;
  };
  static_assert(kA % 2 == 0, "a trip of whole row pairs");
#pragma unroll 1
  for (int t = 0; t < rows; t += kA) {
#pragma unroll
    for (int k = 0; k < kA; k += 2) {
      if (r0 + t + k >= g1) return;  // warp-uniform
      step(t + k, ring[k], std::integral_constant<int, 0>{});
      if (r0 + t + k + 1 >= g1) return;
      step(t + k + 1, ring[k + 1], std::integral_constant<int, kOther>{});
    }
  }
}

// K1 bf16: the march. A warp owns a unit, a strip of kStrip columns over
// ``rows`` rows (pn_march.cuh, march_rows); units are numbered row tile by
// row tile, a block takes kMarchWarps of them in a row, so the grid, the
// order of every sum and the partials count follow the grid's shape alone.
template <bool kOdd, int P>
__global__ void __launch_bounds__(32 * kMarchWarps, kMarchMinBlocks)
k1_march_kernel(const __nv_bfloat16* __restrict__ z,
                const __nv_bfloat16* __restrict__ p,
                const __nv_bfloat16* __restrict__ an,
                const __nv_bfloat16* __restrict__ as_,
                const __nv_bfloat16* __restrict__ bw,
                const __nv_bfloat16* __restrict__ be,
                const __nv_bfloat16* __restrict__ d,
                __nv_bfloat16* __restrict__ pn, __nv_bfloat16* __restrict__ ap,
                double* partials, __nv_bfloat16* scal, int* flags, int g1,
                int g2, int rows, int max_iter, float h1, float h2) {
  // beta read with the flags, in one round trip
  const float beta = up(scal[kBeta]);
  if (!loop_active(flags, max_iter)) return;
  __shared__ double s_warp[32];
  __shared__ int s_last;
  const int nstrips = pn_march::strips(g2);
  const int unit = blockIdx.x * kMarchWarps + (threadIdx.x >> 5);
  double acc = 0.0;
  if (P != kTail && unit < nstrips * ((g1 + rows - 1) / rows)) {
    const int tile = unit / nstrips;  // warp-uniform
    const int s = unit - tile * nstrips;
    march_unit<kOdd>(z, p, an, as_, bw, be, d, pn, ap, g1, g2, tile * rows,
                     rows, s, beta, acc);
  }
  k1_sums<__nv_bfloat16, P>(acc, partials, scal, flags, h1, h2, s_warp,
                            &s_last);
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

// K1 f32: the tile kernel. h1, h2 (and delta) are the values rounded to
// T.
template <int P = kWhole>
int launch_k1(const float* z, const float* p, const float* an,
              const float* as_, const float* bw, const float* be,
              const float* d, float* pn, float* ap, float* partials,
              float* scal, int* flags, int g1, int g2, int max_iter, float h1,
              float h2, void* stream) {
  k1_kernel<float, P><<<k1_grid(g1, g2), dim3(kTileX, kK1ThreadsY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      z, p, an, as_, bw, be, d, pn, ap, partials, scal, flags, g1, g2,
      max_iter, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

// K1 bf16: the march, its words aligned to 4 bytes (the wrapper checks
// every array's address). It indexes in 32 bits, with room for the rows a
// unit reads past the grid's last: a larger grid is refused with
// cudaErrorInvalidValue.
template <int P = kWhole>
int launch_k1(const __nv_bfloat16* z, const __nv_bfloat16* p,
              const __nv_bfloat16* an, const __nv_bfloat16* as_,
              const __nv_bfloat16* bw, const __nv_bfloat16* be,
              const __nv_bfloat16* d, __nv_bfloat16* pn, __nv_bfloat16* ap,
              double* partials, __nv_bfloat16* scal, int* flags, int g1,
              int g2, int max_iter, float h1, float h2, void* stream) {
  if ((int64_t)(g1 + kMaxMarchRows + 1) * g2 >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = march_rows(g1, g2);
  const dim3 grid(march_blocks(g1, g2));
  const dim3 block(32 * kMarchWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  if (g2 & 1) {
    k1_march_kernel<true, P><<<grid, block, 0, st>>>(
        z, p, an, as_, bw, be, d, pn, ap, partials, scal, flags, g1, g2,
        rows, max_iter, h1, h2);
  } else {
    k1_march_kernel<false, P><<<grid, block, 0, st>>>(
        z, p, an, as_, bw, be, d, pn, ap, partials, scal, flags, g1, g2,
        rows, max_iter, h1, h2);
  }
  return static_cast<int>(cudaGetLastError());
}

// The timing instantiation's launch: ``part`` a Part.
template <typename T, typename A>
int launch_k1_part(int part, const T* z, const T* p, const T* an,
                   const T* as_, const T* bw, const T* be, const T* d, T* pn,
                   T* ap, A* partials, T* scal, int* flags, int g1, int g2,
                   int max_iter, float h1, float h2, void* stream) {
  switch (part) {
    case kWhole:
      return launch_k1<kWhole>(z, p, an, as_, bw, be, d, pn, ap, partials,
                               scal, flags, g1, g2, max_iter, h1, h2, stream);
    case kTile:
      return launch_k1<kTile>(z, p, an, as_, bw, be, d, pn, ap, partials,
                              scal, flags, g1, g2, max_iter, h1, h2, stream);
    case kTail:
      return launch_k1<kTail>(z, p, an, as_, bw, be, d, pn, ap, partials,
                              scal, flags, g1, g2, max_iter, h1, h2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
// in accumulators: float for the f32 form (K1's tiles), double for the
// bf16 form (K1's march blocks); K2 keeps two a block.
int pe_fused_scratch_len_f32(int g1, int g2) {
  const dim3 g = k1_grid(g1, g2);
  const int k1 = static_cast<int>(g.x * g.y);
  const int k2 = 2 * k2_blocks((int64_t)g1 * g2);
  return k1 > k2 ? k1 : k2;
}

int pe_fused_scratch_len_bf16(int g1, int g2) {
  const int k1 = march_blocks(g1, g2);
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

// K1's timing instantiation (Part), launched by no engine: part 0 is the
// kernel, 1 its tile pass without the cross-block sum, 2 that sum alone.
int pe_fused_k1_part_f32(int part, const float* z, const float* p,
                         const float* an, const float* as_, const float* bw,
                         const float* be, const float* d, float* pn,
                         float* ap, float* partials, float* scal, int* flags,
                         int g1, int g2, int max_iter, float h1, float h2,
                         void* stream) {
  return launch_k1_part(part, z, p, an, as_, bw, be, d, pn, ap, partials,
                        scal, flags, g1, g2, max_iter, h1, h2, stream);
}

int pe_fused_k1_part_bf16(int part, const __nv_bfloat16* z,
                          const __nv_bfloat16* p, const __nv_bfloat16* an,
                          const __nv_bfloat16* as_, const __nv_bfloat16* bw,
                          const __nv_bfloat16* be, const __nv_bfloat16* d,
                          __nv_bfloat16* pn, __nv_bfloat16* ap,
                          double* partials, __nv_bfloat16* scal, int* flags,
                          int g1, int g2, int max_iter, float h1, float h2,
                          void* stream) {
  return launch_k1_part(part, z, p, an, as_, bw, be, d, pn, ap, partials,
                        scal, flags, g1, g2, max_iter, h1, h2, stream);
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
