// The xl whole-solve kernel: every PCG iteration in one persistent
// cooperative launch, state and operands in device memory.
//
// Replaces: poisson_ellipse_tpu/ops/xl_pcg.py:_mega_kernel (built by
// build_xl_solver, pl.pallas_call at :451), the engine for grids whose
// state does not fit on chip.
//
// The iteration is the TPU kernel's, not its tiling (xl_pcg.py:237-400):
// - z-state: the state is (w, z, p) with z = dinv*r, so the stencil phase
//   reads no preconditioner and the update phase reads dinv once;
// - the w-update is deferred one body and rides the next stencil phase,
//   where p is read anyway: body i applies w += alpha*p with the previous
//   body's alpha, and measures the realised ||dw||^2 of that update;
// - convergence is therefore seen one body late: the loop runs while
//   i < max_iter + 1, a guard trip counts as breakdown only while
//   i < max_iter, and the count reported is bodies - 1 when converged,
//   else the body count capped at max_iter (:237-240, :338, :398-400).
//
// Per body:
//   stencil phase: w += alpha*p_old (dw2 partial); pn = z + beta*p_old;
//     ap = interior ? an*(pc-pu) + an_s*(pc-pd) + bw*(pc-pl) + bw_e*(pc-pr)
//                   : 0
//     (the unmasked form, :197-225); store ap and pn; (ap, pn) partial
//   update phase: z -= alpha*(dinv*ap); (z*z)*(1/dinv) partial with the
//     guarded reciprocal (:364-380)
//
// The trap: the TPU kernel stores pn into p in place (:291-292). That is
// safe there only because its tiles run in order, each reading its own old
// p before writing pn, with the stencil's halo taken from a ring of pn
// tiles in VMEM. Here blocks run in no order, and a warp forming its halo
// pn = z + beta*p from a neighbour's p could read the new p as the old
// one. So p is ping-ponged: body i reads p[i % 2] and writes
// p[(i + 1) % 2], and every warp forms its halo from z and the old p, as
// K1 does. z, p, w and ap are written during the launch by other SMs, so
// they are read through L2 (__ldcg), never the non-coherent path; only
// dinv, an and bw are.
//
// Scalars: three grid sums per body (dw2 and (ap, pn) with one barrier,
// (z, r) with a second; grid_sync.cuh grid_reduce_wide, accumulated in
// double), the same bits in every block. Built with -fmad=false: arrays
// match ops/xl_pcg.py:xl_plain bitwise, and with the sums in double the
// whole solve does too, in practice.
//
// The dtype axes, as in streamed_pcg.cu: a template on the compute type TC
// (the state w, z, p, ap, r0 and diff) and the load type TS of the
// operands dinv, an, bw (ops/xl_pcg.py:FORMS): f32; bf16 compute, every
// value computed in float and rounded to bf16 where it is stored
// (grid_sync.cuh), as xl_plain rounds it, so the scalars that cross the
// barriers (alpha, beta, zr, diff) are the same bf16 values in every
// block; and f32 compute with the narrow operand streams of
// build_xl_solver(storage_dtype=) (xl_pcg.py:406-460, the upcast in
// tile_of, :162-169), the operands upcast exactly after each load. The
// grid is each form's own occupancy (pe_xl_pcg_<form>_launch_query).
//
// What bounds it: bytes. Per body the stencil phase reads z, p_old, w, an,
// bw and writes w, pn, ap (8 passes), the update phase reads z, dinv, ap and
// writes z (4): 12 array passes, plus the march's halo (below). At
// 2401x3201 f32 one pass is 30.74 MB, so 12 passes are 369 MB: 110 us at
// 3.35 TB/s; bf16 compute halves every pass, bf16 operand streams only the
// ~3 operand passes. Each body also holds two grid barriers with their
// sums (2.1 and 2.7 us alone at 253 blocks on the H100; PERF.md, section
// 6): 115 us a body in all.
//
// Design (the parent, 32x32 tiles a thread a node with a shared-memory pn
// halo, spent 174 of its 239 us a body in the stencil phase on the H100,
// its blocks ending that phase 18 us apart; PERF.md, section 6):
// - The stencil phase is K-d's march (stencil_dots.cu): a lane owns a
//   column, a warp a strip of 32 columns, and it marches down the rows of
//   its work unit. pn = z + beta*p_old is formed once a node, in
//   registers; the north pn and an's row are carried down from the row
//   above, so a step loads the row below's z, p_old and an and its own
//   row's w and bw, once each; the west and east pn and the east bw come by
//   shuffles, and the values a warp's edge lanes lack (pn one column west
//   of lane 0, pn and bw one column east of lane 31) are formed once for
//   every kChunk rows, lane k for row k. A ring of kAhead rows is in flight
//   behind the row computed. The deferred w-update uses the p_old loaded
//   for pn. No shared memory, no __syncthreads and no integer division in
//   the march; the expression tree is xl_plain's, term for term.
// - Balance and locality: a unit is a strip and a segment of rows; the g1
//   rows are cut into ``segs`` segments whose sizes differ by at most
//   one, numbered segment-major, so the warps of a segment march every
//   strip of the same rows side by side: at any moment the card reads a
//   few dozen whole rows of each array, long runs of DRAM. (Runs of rows
//   down one strip, or down a band of 8 strips a block, balanced the
//   blocks' rows exactly but scattered the reads, and ran 5-14% slower
//   on the H100; PERF.md, section 6.) The host sizes segs from the shape
//   and the grid the card holds (ops/xl_pcg.py:XLPlan) so that every warp
//   has one unit: every block ends the stencil phase after the same
//   number of rows, plus or minus one.
// - The update phase streams z, dinv and ap in groups of 16 bytes of the
//   compute type (4 f32 or 8 bf16 nodes), a group a thread in turn over
//   the grid, kUnroll groups' loads in flight, with vector loads where the
//   three arrays are aligned to them (scalar loads of the same groups
//   otherwise, so the order of the sum does not depend on alignment).
// - The three sums take grid_reduce_wide: every thread of every block adds
//   a few of the partials after the barrier, where one warp adding them in
//   17 dependent loads a lane at 528 blocks took longer (2 sums: 2.7
//   against 4.8 us at 253 blocks on the H100; PERF.md).
// - Registers against warps (Tune): the march holds kAhead rows of five
//   arrays in registers. f32 ran best at 6 rows ahead and 2 blocks an SM,
//   no spill: 253 blocks, so fewer partials and a narrower spread of the
//   blocks' ends (7 us against 15-27 at 392-528 blocks).
//
// kStamps: the timing instantiation, which stamps the phases of every body
// on the device clock (chip_smoke.py --only xl-timing). No engine runs it.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "grid_sync.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 24;  // rows whose edge values a warp forms at once

// Each form's march: rows of loads in flight behind a row, blocks an SM
// the registers are sized for, update-phase groups whose loads a thread
// has in flight. Chosen on the H100 from a sweep (PERF.md, section 6):
// the f32 form 174.3 us a body at 6 rows ahead and 2 blocks an SM (126
// registers, no spill) against 180-186 at 3-4 rows and 3 blocks (80
// registers, spilling); bf16 compute, whose loads move half the bytes,
// wants more warps (4 blocks an SM).
template <typename TC, typename TS>
struct Tune {
  static constexpr int kAhead = 4, kMinBlocks = 3, kUnroll = 2;
};
template <>
struct Tune<float, float> {
  static constexpr int kAhead = 6, kMinBlocks = 2, kUnroll = 2;
};
template <>
struct Tune<__nv_bfloat16, __nv_bfloat16> {
  static constexpr int kAhead = 2, kMinBlocks = 4, kUnroll = 1;
};

// Body i of the timing instantiation writes stamps[i * (kStampsPerBody +
// gridDim.x) + k]: block 0 the start of its stencil phase (k = 0), its end
// (1), the return of the first grid sums (2), the end of the update phase
// (3) and the return of the second (4); every block b the end of its own
// stencil phase (kStampsPerBody + b), and in body 0 its SM plus one. A
// phase's end is taken after a __syncthreads, so it is the block's.
constexpr int kStampsPerBody = 5;

template <bool kStamps>
__device__ __forceinline__ void stamp(unsigned long long* stamps, int i,
                                      int k, bool sync = true) {
  if (kStamps) {
    if (sync) __syncthreads();
    if (threadIdx.x == 0 && (blockIdx.x == 0 || k >= kStampsPerBody)) {
      unsigned long long t = pe::global_ns();
      if (i == 0 && k >= kStampsPerBody) {
        // body 0's block slots: the block's SM, plus one
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        t = sm + 1;
      }
      stamps[(long long)i * (kStampsPerBody + gridDim.x) + k] = t;
    }
  }
}

// A group of the update phase: 16 bytes of the compute type.
template <typename TC>
constexpr int kGroup = 16 / static_cast<int>(sizeof(TC));

template <int kBytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};

// The kV values of type T at p, widened: one vector load (p aligned to it),
// through L2 (kL2) or the read-only path.
template <int kV, bool kL2, typename T>
__device__ __forceinline__ void load_group(const T* p, float (&out)[kV]) {
  using R = typename Raw<kV * static_cast<int>(sizeof(T))>::type;
  const R raw = kL2 ? __ldcg(reinterpret_cast<const R*>(p))
                    : __ldg(reinterpret_cast<const R*>(p));
  T v[kV];
  memcpy(v, &raw, sizeof(raw));
#pragma unroll
  for (int k = 0; k < kV; ++k) out[k] = up(v[k]);
}

template <typename TC, typename TS, bool kStamps = false>
__global__ void __launch_bounds__(kThreads, Tune<TC, TS>::kMinBlocks)
xl_kernel(const TS* __restrict__ dinv_g, const TS* __restrict__ an_g,
          const TS* __restrict__ bw_g, const TC* __restrict__ r0_g, TC* w,
          TC* z, TC* p0, TC* p1, TC* ap, double* partials, int* status,
          TC* diff_out, int g1, int g2, int segs, int aligned, int max_iter,
          float h1h2, float delta, int weighted,
          unsigned long long* stamps) {
  constexpr int kV = kGroup<TC>;
  constexpr int kAhead = Tune<TC, TS>::kAhead;
  constexpr int kUnroll = Tune<TC, TS>::kUnroll;
  static_assert(kChunk % kAhead == 0, "the ring carries over chunks");
  __shared__ double scratch[pe::kWideDoubles];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n = g1 * g2;
  const int M = g1 - 1, N = g2 - 1;
  const int nb = gridDim.x;
  const int stride = nb * kThreads;
  const int strips = (g2 + 31) / 32;
  const int units = strips * segs;
  const int groups = (n + kV - 1) / kV;
  double* const part_step[2] = {partials, partials + nb};
  double* const part_zr[1] = {partials + 2 * nb};
  const auto R = [](float x) { return rn<TC>(x); };

  // -- init: w = 0, p = 0, z = r0*dinv, zr0 = h1h2 * sum(z*r0)
  double acc[1] = {0.0};
  for (int o = blockIdx.x * kThreads + tid; o < n; o += stride) {
    const float r = up(r0_g[o]);
    const float zz = R(r * up(dinv_g[o]));
    z[o] = down<TC>(zz);
    w[o] = down<TC>(0.f);
    p0[o] = down<TC>(0.f);
    acc[0] += zz * r;
  }
  float sums[2], zr_sum[1];
  pe::grid_reduce_wide<1>(acc, part_zr, scratch, zr_sum);
  float zr = R(R(zr_sum[0]) * h1h2);
  float alpha = 0.f, beta = 0.f;
  float diff = __int_as_float(0x7f800000);  // +inf
  bool conv = false, bd = false;

  int i = 0;  // bodies run
  while (i < max_iter + 1 && !conv && !bd) {
    const TC* p_old = (i & 1) ? p1 : p0;
    TC* p_new = (i & 1) ? p0 : p1;

    // -- stencil phase: each warp marches its unit (a strip and a segment
    // of rows), the segments cut from the rows in equal shares
    stamp<kStamps>(stamps, i, 0, false);
    double step[2] = {0.0, 0.0};  // dw2, (ap, pn)
    for (int u = blockIdx.x * kWarps + (tid >> 5); u < units;
         u += nb * kWarps) {
      const int seg = u / strips;
      const int c0 = (u - seg * strips) * 32;
      const int c = c0 + lane;
      const int rb = static_cast<int>((long long)seg * g1 / segs);
      const int re = static_cast<int>((long long)(seg + 1) * g1 / segs);
      const bool col_in = c < g2;
      const bool col_int = c >= 1 && c <= N - 1;
      // pn one row above the unit (0 off the grid), and the first row's
      // pn, p_old and an
      float pu = 0.f, pc = 0.f, pold_c = 0.f, an_c = 0.f;
      if (col_in) {
        int o = rb * g2 + c;
        if (rb >= 1) {
          pu = R(up(__ldcg(z + o - g2)) + beta * up(__ldcg(p_old + o - g2)));
        }
        pold_c = up(__ldcg(p_old + o));
        pc = R(up(__ldcg(z + o)) + beta * pold_c);
        an_c = up(__ldg(an_g + o));
      }
      // what the step at row r loads: its own w and bw, and z, p_old and
      // an one row down (0 off the grid)
      struct Row {
        float w, bw, z, p, an;
      };
      auto load = [&](int r, Row& row) {
        const int o = r * g2 + c;
        const bool down_in = col_in && r + 1 < g1;
        row.w = col_in ? up(__ldcg(w + o)) : 0.f;
        row.bw = col_in ? up(__ldg(bw_g + o)) : 0.f;
        row.z = down_in ? up(__ldcg(z + o + g2)) : 0.f;
        row.p = down_in ? up(__ldcg(p_old + o + g2)) : 0.f;
        row.an = down_in ? up(__ldg(an_g + o + g2)) : 0.f;
      };
      Row ring[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        ring[k] = Row{};
        if (rb + k < re) load(rb + k, ring[k]);
      }
      for (int r0 = rb; r0 < re; r0 += kChunk) {
        const int rows = min(kChunk, re - r0);
        // lane k: row r0 + k's pn one column west of lane 0, and pn and
        // bw one column east of lane 31
        float e_pw = 0.f, e_pe = 0.f, e_bw = 0.f;
        if (lane < rows) {
          const int o = (r0 + lane) * g2;
          if (c0 >= 1) {
            e_pw = R(up(__ldcg(z + o + c0 - 1)) +
                     beta * up(__ldcg(p_old + o + c0 - 1)));
          }
          if (c0 + 32 < g2) {
            e_pe = R(up(__ldcg(z + o + c0 + 32)) +
                     beta * up(__ldcg(p_old + o + c0 + 32)));
            e_bw = up(__ldg(bw_g + o + c0 + 32));
          }
        }
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          if (t >= rows) break;
          const int r = r0 + t;
          const Row cur = ring[t % kAhead];
          if (r + kAhead < re) load(r + kAhead, ring[t % kAhead]);
          const float pd = (col_in && r + 1 < g1) ? R(cur.z + beta * cur.p)
                                                  : 0.f;
          float pl = __shfl_up_sync(kFull, pc, 1);
          const float w_edge = __shfl_sync(kFull, e_pw, t);
          if (lane == 0) pl = w_edge;
          float pr = __shfl_down_sync(kFull, pc, 1);
          const float e_edge = __shfl_sync(kFull, e_pe, t);
          if (lane == 31) pr = e_edge;
          float bw_e = __shfl_down_sync(kFull, cur.bw, 1);
          const float b_edge = __shfl_sync(kFull, e_bw, t);
          if (lane == 31) bw_e = b_edge;
          if (col_in) {
            const int o = r * g2 + c;
            // the deferred update of the previous body
            const float wn = R(cur.w + alpha * pold_c);
            w[o] = down<TC>(wn);
            const float dw = wn - cur.w;
            step[0] += dw * dw;
            float v = 0.f;
            if (col_int && r >= 1 && r <= M - 1) {
              const float ax = an_c * (pc - pu) + cur.an * (pc - pd);
              const float ay = cur.bw * (pc - pl) + bw_e * (pc - pr);
              v = R(ax + ay);
              step[1] += v * pc;
            }
            ap[o] = down<TC>(v);
            p_new[o] = down<TC>(pc);
          }
          pu = pc;
          pc = pd;
          pold_c = cur.p;
          an_c = cur.an;
        }
      }
    }
    stamp<kStamps>(stamps, i, 1);
    stamp<kStamps>(stamps, i, kStampsPerBody + blockIdx.x, false);
    pe::grid_reduce_wide<2>(step, part_step, scratch, sums);
    stamp<kStamps>(stamps, i, 2, false);
    const float dw2_sum = R(sums[0]);
    const float denom = R(R(sums[1]) * h1h2);
    float nd = R(weighted ? sqrtf(dw2_sum * h1h2) : sqrtf(dw2_sum));
    // convergence of the previous reference iteration (body 0 has none)
    const bool cv = i >= 1 && nd < delta;
    nd = i >= 1 ? nd : diff;
    // this body's denominator belongs to reference iteration i+1: a guard
    // trip is a breakdown only while that iteration is within the cap
    const bool guard = pe::below_guard<TC>(denom);
    const bool bdn = !cv && guard && i < max_iter;
    const float alpha_new = pe::guarded_alpha<TC>(zr, denom);

    // -- update phase: z and the (z, r) partial off one dinv read, a
    // group of kV nodes at a time, kUnroll groups' loads in flight
    acc[0] = 0.0;
    for (int g0 = blockIdx.x * kThreads + tid; g0 < groups;
         g0 += kUnroll * stride) {
      float zv[kUnroll][kV], dv[kUnroll][kV], av[kUnroll][kV];
      bool whole[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int o = (g0 + u * stride) * kV;
        whole[u] = aligned && o + kV <= n;
        if (whole[u]) {
          load_group<kV, true>(z + o, zv[u]);
          load_group<kV, false>(dinv_g + o, dv[u]);
          load_group<kV, true>(ap + o, av[u]);
        } else {
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            const bool in = o + k < n;
            zv[u][k] = in ? up(__ldcg(z + o + k)) : 0.f;
            dv[u][k] = in ? up(dinv_g[o + k]) : 0.f;
            av[u][k] = in ? up(__ldcg(ap + o + k)) : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int o = (g0 + u * stride) * kV;
        alignas(16) TC zs[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          const float zn = R(zv[u][k] - alpha_new * (dv[u][k] * av[u][k]));
          zs[k] = down<TC>(zn);
          // the guarded reciprocal: d = 1/dinv on the interior, 0 off it
          const float d = dv[u][k] != 0.f ? 1.f / dv[u][k] : 0.f;
          if (whole[u] || o + k < n) acc[0] += (zn * zn) * d;
        }
        if (whole[u]) {
          uint4 raw;
          memcpy(&raw, zs, sizeof(raw));
          *reinterpret_cast<uint4*>(z + o) = raw;
        } else {
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            if (o + k < n) z[o + k] = zs[k];
          }
        }
      }
    }
    stamp<kStamps>(stamps, i, 3);
    pe::grid_reduce_wide<1>(acc, part_zr, scratch, zr_sum);
    stamp<kStamps>(stamps, i, 4, false);
    const float zr_new = R(R(zr_sum[0]) * h1h2);

    beta = bdn ? beta : R(zr_new / zr);
    zr = bdn ? zr : zr_new;
    alpha = alpha_new;
    diff = nd;
    conv = cv;
    bd = bdn;
    ++i;
  }

  pe::Carry c{zr, beta, diff, conv, bd};
  pe::write_status<TC>(status, diff_out, conv ? i - 1 : min(i, max_iter), c);
}

// Whether z, ap and dinv are aligned to the update phase's vectors: node 0
// of each on a group boundary.
template <typename TC, typename TS>
int aligned_groups(const TC* z, const TC* ap, const TS* dinv) {
  const uintptr_t v = 16;
  const uintptr_t vs = kGroup<TC> * sizeof(TS);
  return reinterpret_cast<uintptr_t>(z) % v == 0 &&
         reinterpret_cast<uintptr_t>(ap) % v == 0 &&
         reinterpret_cast<uintptr_t>(dinv) % vs == 0;
}

// h1h2 and delta are the TC-rounded values; nblocks and segs are
// ops/xl_pcg.py:XLPlan's. With ``stamps`` the timing instantiation runs.
template <typename TC, typename TS>
int launch(const TS* dinv, const TS* an, const TS* bw, const TC* r0, TC* w,
           TC* z, TC* p0, TC* p1, TC* ap, double* partials, int* status,
           TC* diff, int g1, int g2, int nblocks, int segs, int max_iter,
           float h1h2, float delta, int weighted, void* stream,
           unsigned long long* stamps = nullptr) {
  if (segs < 1 || segs > g1 || nblocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int aligned = aligned_groups(z, ap, dinv);
  void* args[] = {&dinv, &an, &bw, &r0, &w, &z, &p0, &p1, &ap, &partials,
                  &status, &diff, &g1, &g2, &segs, &aligned, &max_iter,
                  &h1h2, &delta, &weighted, &stamps};
  if (stamps != nullptr) {
    return pe::cooperative_launch(xl_kernel<TC, TS, true>, nblocks, kThreads,
                                  0, args, stream);
  }
  return pe::cooperative_launch(xl_kernel<TC, TS>, nblocks, kThreads, 0, args,
                                stream);
}

// A cooperative kernel of ``bodies`` bodies, each one grid barrier (kMode
// 0), or one pe::grid_reduce_warp with one sum (1) or two (2: the sums of
// the resident and streamed kernels), or grid_reduce_wide with one sum (3)
// or two (4): the synchronisation cost of a whole-solve body alone.
// Consecutive bodies use alternate partials, as the solve's sums do, so no
// block overwrites a partial another still reads.
template <int kMode>
__global__ void barrier_bench_kernel(double* partials, float* out,
                                     int bodies) {
  __shared__ double scratch[pe::kWideDoubles];
  const int nb = gridDim.x;
  float acc = 0.f;
  for (int i = 0; i < bodies; ++i) {
    double* part = partials + (i & 1) * 2 * nb;
    const double v = threadIdx.x + i;
    if (kMode == 0) {
      pe::grid_barrier();
    } else if (kMode == 1) {
      double vs[1] = {v};
      double* const parts[1] = {part};
      float s[1];
      pe::grid_reduce_warp<1>(vs, parts, scratch, s);
      acc += s[0];
    } else if (kMode == 2) {
      double vs[2] = {v, -v};
      double* const parts[2] = {part, part + nb};
      float s[2];
      pe::grid_reduce_warp<2>(vs, parts, scratch, s);
      acc += s[0] + s[1];
    } else if (kMode == 3) {
      double vs[1] = {v};
      double* const parts[1] = {part};
      float s[1];
      pe::grid_reduce_wide<1>(vs, parts, scratch, s);
      acc += s[0];
    } else {
      double vs[2] = {v, -v};
      double* const parts[2] = {part, part + nb};
      float s[2];
      pe::grid_reduce_wide<2>(vs, parts, scratch, s);
      acc += s[0] + s[1];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = acc;
}

}  // namespace

extern "C" {

// One launcher and one launch query a form (ops/xl_pcg.py:FORMS), all
// launchers with one argument list: the operands dinv, an, bw at the load
// type, the rest at the compute type; segs: the row segments of the
// march's split (XLPlan). Returns cudaErrorInvalidValue for a split out of
// range.
int pe_xl_pcg_f32(const float* dinv, const float* an, const float* bw,
                  const float* r0, float* w, float* z, float* p0, float* p1,
                  float* ap, double* partials, int* status, float* diff, int g1,
                  int g2, int nblocks, int segs, int max_iter, float h1h2,
                  float delta, int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, z, p0, p1, ap, partials, status, diff,
                g1, g2, nblocks, segs, max_iter, h1h2, delta, weighted,
                stream);
}

int pe_xl_pcg_bf16(const __nv_bfloat16* dinv, const __nv_bfloat16* an,
                   const __nv_bfloat16* bw, const __nv_bfloat16* r0,
                   __nv_bfloat16* w, __nv_bfloat16* z, __nv_bfloat16* p0,
                   __nv_bfloat16* p1, __nv_bfloat16* ap, double* partials,
                   int* status, __nv_bfloat16* diff, int g1, int g2,
                   int nblocks, int segs, int max_iter, float h1h2,
                   float delta, int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, z, p0, p1, ap, partials, status, diff,
                g1, g2, nblocks, segs, max_iter, h1h2, delta, weighted,
                stream);
}

int pe_xl_pcg_f32_bf16(const __nv_bfloat16* dinv, const __nv_bfloat16* an,
                       const __nv_bfloat16* bw, const float* r0, float* w,
                       float* z, float* p0, float* p1, float* ap,
                       double* partials, int* status, float* diff, int g1,
                       int g2, int nblocks, int segs, int max_iter,
                       float h1h2, float delta, int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, z, p0, p1, ap, partials, status, diff,
                g1, g2, nblocks, segs, max_iter, h1h2, delta, weighted,
                stream);
}

int pe_xl_pcg_f32_f16(const __half* dinv, const __half* an, const __half* bw,
                      const float* r0, float* w, float* z, float* p0,
                      float* p1, float* ap, double* partials, int* status,
                      float* diff, int g1, int g2, int nblocks, int segs,
                      int max_iter, float h1h2, float delta, int weighted,
                      void* stream) {
  return launch(dinv, an, bw, r0, w, z, p0, p1, ap, partials, status, diff,
                g1, g2, nblocks, segs, max_iter, h1h2, delta, weighted,
                stream);
}

// The timing instantiation of the f32 form: pe_xl_pcg_f32's arguments and
// ``stamps``, (max_iter + 1) * (5 + nblocks) zeroed u64 (xl_kernel).
int pe_xl_pcg_stamps_f32(const float* dinv, const float* an, const float* bw,
                         const float* r0, float* w, float* z, float* p0,
                         float* p1, float* ap, double* partials, int* status,
                         float* diff, int g1, int g2, int nblocks, int segs,
                         int max_iter, float h1h2, float delta, int weighted,
                         void* stream, unsigned long long* stamps) {
  return launch(dinv, an, bw, r0, w, z, p0, p1, ap, partials, status, diff,
                g1, g2, nblocks, segs, max_iter, h1h2, delta, weighted,
                stream, stamps);
}

int pe_xl_pcg_launch_query(int device, int smem, int* cooperative,
                           int* blocks_per_sm) {
  return pe::launch_query(xl_kernel<float, float>, kThreads, device, smem,
                          cooperative, blocks_per_sm);
}

int pe_xl_pcg_bf16_launch_query(int device, int smem, int* cooperative,
                                int* blocks_per_sm) {
  return pe::launch_query(xl_kernel<__nv_bfloat16, __nv_bfloat16>, kThreads,
                          device, smem, cooperative, blocks_per_sm);
}

int pe_xl_pcg_f32_bf16_launch_query(int device, int smem, int* cooperative,
                                    int* blocks_per_sm) {
  return pe::launch_query(xl_kernel<float, __nv_bfloat16>, kThreads, device,
                          smem, cooperative, blocks_per_sm);
}

int pe_xl_pcg_f32_f16_launch_query(int device, int smem, int* cooperative,
                                   int* blocks_per_sm) {
  return pe::launch_query(xl_kernel<float, __half>, kThreads, device, smem,
                          cooperative, blocks_per_sm);
}

// barrier_bench_kernel<mode> (modes 0-4) on ``nblocks`` blocks of
// ``threads``; partials: 4 * nblocks doubles; out: one float. Modes 1-2
// take at most pe::kMaxPartials blocks.
int pe_xl_pcg_barrier_bench(int mode, int nblocks, int threads, int bodies,
                            double* partials, float* out, void* stream) {
  if ((mode == 1 || mode == 2) && nblocks > pe::kMaxPartials) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&partials, &out, &bodies};
  switch (mode) {
    case 0:
      return pe::cooperative_launch(barrier_bench_kernel<0>, nblocks,
                                    threads, 0, args, stream);
    case 1:
      return pe::cooperative_launch(barrier_bench_kernel<1>, nblocks,
                                    threads, 0, args, stream);
    case 2:
      return pe::cooperative_launch(barrier_bench_kernel<2>, nblocks,
                                    threads, 0, args, stream);
    case 3:
      return pe::cooperative_launch(barrier_bench_kernel<3>, nblocks,
                                    threads, 0, args, stream);
    default:
      return pe::cooperative_launch(barrier_bench_kernel<4>, nblocks,
                                    threads, 0, args, stream);
  }
}

const char* pe_xl_pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
