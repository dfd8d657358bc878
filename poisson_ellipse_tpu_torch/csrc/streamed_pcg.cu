// The streamed whole-solve kernel: every PCG iteration in one persistent
// cooperative launch, the state in shared memory, each operand either in
// shared memory or read from device memory as the plan says.
//
// Replaces: poisson_ellipse_tpu/ops/streamed_pcg.py:_mega_kernel (built by
// build_streamed_solver, pl.pallas_call at :632), which keeps the state
// (w, r, p) in VMEM and streams each operand that StreamPlan cannot hold.
//
// Layout: one block per SM, each owning a contiguous row-major span of
// nodes (as resident_pcg.cu). The state w, r (z in the z-state regime) and
// p always live in the block's shared memory. Each operand of
// {ap, dinv, an, bw} is resident (in shared memory, loaded once) or
// streamed (read from device memory each iteration; ap written there by
// the stencil phase and read back by the update phase), as
// ops/streamed_pcg.py:StreamPlan decides from the card's shared memory.
// There is no double-buffered tile: the block's threads read a streamed
// operand directly, and the L2 holds what the march reads twice.
//
// The regime follows the plan (streamed_pcg.py:453-510):
// - dinv resident: r-state. pn = r*dinv + beta*p; the update phase
//   r -= alpha*ap; zr' = sum((r*dinv)*r).
// - dinv streamed: z-state. The state holds z = dinv*r (set at init,
//   :316-323), so the stencil phase reads no operand for pn = z + beta*p,
//   and the update phase z -= alpha*(dinv*ap); zr' = sum(z*z*(1/dinv)),
//   the guarded reciprocal, both off the one dinv read.
// The stencil is the unmasked, output-masked form (:330-369):
//   ap = interior ? an*(pc-pu) + an_s*(pc-pd) + bw*(pc-pl) + bw_e*(pc-pr) : 0
// with an_s / bw_e the unmasked coefficients one row / one column on.
//
// Halo, scalars and determinism: as resident_pcg.cu. Each block publishes
// z and pn for the nodes within one row of its span's ends (zpub, ppub);
// the neighbour forms pn = z + beta*p from them. Three grid sums per
// iteration (grid_sync.cuh grid_reduce_warp, accumulated in double; dw2
// and zr' through one pass) give every block the same carry. Built with
// -fmad=false: arrays match ops/streamed_pcg.py:streamed_plain bitwise,
// and with the sums in double the whole solve does too, in practice.
//
// The dtype axes: the kernel is a template on its compute type TC (the
// state, r0, ap, w_out and diff) and on the load type TS of the operands
// dinv, an and bw (ops/streamed_pcg.py:FORMS):
// - f32: TC = TS = float;
// - bf16: TC = TS = __nv_bfloat16, bf16 compute; each value is computed
//   in float and rounded to bf16 where it is stored (grid_sync.cuh), as
//   streamed_plain rounds it;
// - f32_bf16, f32_f16: TC = float, TS narrow, the narrow operand streams
//   of build_streamed_solver(storage_dtype=) (streamed_pcg.py:575-625,
//   the upcast in _read, :258): each operand is loaded at TS and upcast
//   exactly (up, storage.cuh), so the form is the f32 kernel on the upcast
//   operands bit for bit.
// A resident operand is held in shared memory at TC, upcast once at load,
// so the plan's byte counts (at the compute width, as the JAX plan
// budgets them) are the kernel's offsets for every form. The span halo
// buffers are float in every form.
//
// What bounds it: the arithmetic and the two grid barriers where every
// operand fits on chip, else the streamed operands' reads. Each streamed
// operand is one array pass an iteration (ap two: written, then read);
// at 1101x1651 f32 the plan streams dinv, an and bw, 21.8 MB an iteration,
// which the 50 MB L2 holds. The kernel before the march (a thread a node
// in strided 1-D loops) took 28.2 us a body there (chip_smoke.py --only
// whole-timing on the H100; PERF.md, section 6): the stencil phase 12.8
// (four operand loads, an integer division and four branchy pn reads a
// node), the update phase 6.4, the sums 4.3 and 3.6 (2.3 of the first the
// blocks' stencil-phase ends spreading). This one takes 17.9 us a body
// there: stencil phase 5.6, update phase 5.2, sums 2.6 and 3.4 (the same
// run, PERF.md).
//
// Design: resident_pcg.cu's march (grid_sync.cuh), a lane a column of the
// span marching down its steps, pn one row up and an's row carried from
// the step before: a step loads pn one row down and one column either
// side (shared memory), an one row down, bw and bw one column east (each
// operand through one pointer chosen once, to shared or device memory as
// the plan says: no branch a read), no integer division; the narrow and
// bf16 forms issue a step's operand loads two steps ahead (Lead). ap goes
// to its array (shared or device memory), so any number of units a warp
// fits; the update phase walks the same units in the same order, so each
// thread reads back the ap it wrote, and loads a unit's ap and dinv all
// at once before its updates. The halo and the sums are
// resident_pcg.cu's: the first kAhead units' halo (z only) rides the
// barrier that publishes it, later units load z and p as each starts.
// (The z-state's 1/dinv as __frcp_rn, the same correctly rounded value:
// bitwise, and no faster on the H100, PERF.md; not kept.)
//
// kStamps: the timing instantiation (grid_sync.cuh whole_stamp), which
// stamps the phases of every body on the device clock (chip_smoke.py
// --only whole-timing). No engine runs it.

#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

// warps a block, at most (ops/streamed_pcg.py:MAX_WARPS)
constexpr int kMaxWarps = 26;
constexpr int kMaxThreads = 32 * kMaxWarps;
// a unit's steps, at most (march_split), and the units of a warp whose
// halo loads ride the barrier before their stencil phase
constexpr int kSteps = 10;
constexpr int kAhead = 2;

// Steps ahead a march issues its operand loads: two for the narrow loads
// and bf16 (on the H100 bf16 at 1601x2401 59.6 -> 47.6 us a body, the
// narrow streams at 1101x1651 19.8-20.2 -> 18.3-18.6), none at f32, whose
// stencil phase ran slower so (5.5 -> 6.2 us; PERF.md).
template <typename TC, typename TS>
struct Lead {
  static constexpr int value = 2;
};
template <>
struct Lead<float, float> {
  static constexpr int value = 0;
};

// resident-operand bits (ops/streamed_pcg.py:RESIDENT_BITS holds the same)
constexpr int kResAp = 1;
constexpr int kResDinv = 2;
constexpr int kResAn = 4;
constexpr int kResBw = 8;

template <typename TC, typename TS, bool kStamps>
__global__ void __launch_bounds__(kMaxThreads, 1)
streamed_kernel(const TS* __restrict__ dinv_g, const TS* __restrict__ an_g,
                const TS* __restrict__ bw_g, const TC* __restrict__ r0_g,
                TC* __restrict__ w_out, TC* __restrict__ ap_g, float* zpub,
                float* ppub, double* partials, int* status, TC* diff_out,
                int g1, int g2, int span, int resident, pe::MarchSplit split,
                int max_iter, float h1h2, float delta, int weighted,
                unsigned long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* scratch = reinterpret_cast<double*>(smem_raw);
  TC* s_w = reinterpret_cast<TC*>(smem_raw + pe::kReduceBytes);
  TC* s_r = s_w + span;  // r, or z in the z-state regime
  TC* s_p = s_r + span;
  TC* next = s_p + span;
  // the resident operands' slots, span elements of TC each (the plan's
  // offsets); ap is held at TC, dinv, an and bw at their load type TS
  TC* s_ap = nullptr;
  TS* s_dinv = nullptr;
  TS* s_an = nullptr;
  TS* s_bw = nullptr;
  if (resident & kResAp) {
    s_ap = next;
    next += span;
  }
  if (resident & kResDinv) {
    s_dinv = reinterpret_cast<TS*>(next);
    next += span;
  }
  if (resident & kResAn) {
    s_an = reinterpret_cast<TS*>(next);
    next += span;
  }
  if (resident & kResBw) s_bw = reinterpret_cast<TS*>(next);
  const bool zstate = (resident & kResDinv) == 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int n = g1 * g2;
  const int s = blockIdx.x * span;
  const int len = max(0, min(n, s + span) - s);
  const int M = g1 - 1, N = g2 - 1;
  const int nb = gridDim.x;
  double* const part_denom[1] = {partials};
  double* const part_step[2] = {partials + nb, partials + 2 * nb};
  double* const part_zr[1] = {partials + 2 * nb};
  const auto R = [](float x) { return rn<TC>(x); };

  // Each operand and ap at span-local node l as one array, shared or
  // device memory as the plan says (a generic pointer, chosen once: no
  // branch a read). An operand one row or one column past the span comes
  // from device memory.
  const TS* const an_l = s_an ? s_an : an_g + s;
  const TS* const bw_l = s_bw ? s_bw : bw_g + s;
  const TS* const dinv_l = s_dinv ? s_dinv : dinv_g + s;
  TC* const ap_l = s_ap ? s_ap : ap_g + s;

  // -- load the resident operands once; w = 0, p = 0, the state from r0
  double acc[1] = {0.0};
  for (int l = tid; l < len; l += nthreads) {
    const int q = s + l;
    const TS dv_s = dinv_g[q];
    const float dv = up(dv_s);
    if (s_dinv) s_dinv[l] = dv_s;
    if (s_an) s_an[l] = an_g[q];
    if (s_bw) s_bw[l] = bw_g[q];
    const float r = up(r0_g[q]);
    // z0 is stored (the state) in the z-state regime only
    const float z = zstate ? R(r * dv) : r * dv;
    s_r[l] = down<TC>(zstate ? z : r);
    s_w[l] = down<TC>(0.f);
    s_p[l] = down<TC>(0.f);
    acc[0] += z * r;
    if (pe::at_span_edge(l, len, g2)) {
      zpub[q] = z;
      ppub[q] = 0.f;
    }
  }
  const pe::SpanGeom geom = pe::span_geom(s, len, g2);
  const pe::UnitIter first = pe::first_unit(split, warp);

  // The halo an iteration's stencil phase reads, loaded right after the
  // barrier that publishes it (the one that closes the update phase before
  // it: fetch_halo), while warp 0 adds the partials: z one node before and
  // one after the span, and at each of the first kAhead units' halo nodes
  // (z and p at the others' as each starts).
  float hwz = 0.f, hez = 0.f;
  pe::UnitHalo halo[kAhead];
  const auto fetch_halo = [&] {
    if (len > 0 && s >= 1) hwz = __ldcg(zpub + s - 1);
    if (len > 0 && s + len < n) hez = __ldcg(zpub + s + len);
    pe::UnitIter it = first;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      halo[j] = pe::load_halo(pe::march_unit(split, it, lane, g2, geom),
                              zpub, nullptr, s, g2, n);
      pe::next_unit(split, it);
    }
  };
  // p at those halo nodes: the pn this thread formed there the iteration
  // before (0 before the first, as p0)
  float hw = 0.f, he = 0.f;
  float carry[kAhead][2] = {};

  float zr_sum[1];
  pe::grid_reduce_warp<1>(acc, part_zr, scratch, zr_sum, fetch_halo);
  pe::Carry c;
  c.zr = R(R(zr_sum[0]) * h1h2);
  c.beta = 0.f;
  c.diff = __int_as_float(0x7f800000);  // +inf
  c.converged = false;
  c.breakdown = false;

  // The stencil phase's march over one unit: ap at each node, into its
  // array, and the (ap, pn) partial. pn one row up and an are carried from
  // the step before; where the unit starts the lane's column pn one row up
  // is the halo ``h``, as is pn one row below the lane's last node.
  const auto stencil_unit = [&](const pe::MarchUnit& mu,
                                const pe::UnitHalo& h, float(&hp)[2]) {
    if (!mu.active) return;
    int l = mu.m + mu.t0 * g2;
    int q = s + l;
    int i = mu.row;
    const bool col_in = mu.col >= 1 && mu.col <= N - 1;
    // ``hp`` holds p at the unit's halo nodes, and takes their pn
    float pu;
    if (mu.t0 > 0) {
      pu = up(s_p[l - g2]);
    } else {
      pu = R(h.zn + c.beta * hp[0]);
      hp[0] = pu;
    }
    const float hs = R(h.zs + c.beta * hp[1]);
    if (mu.t1 > mu.t_last) hp[1] = hs;
    float pc = up(s_p[l]);
    float an_c = up(an_l[l]);
    // an one row down (carried to the next step; 0 past the grid), bw and
    // bw one column east on the interior, past the span from device memory
    float an_s, bw_c, bw_e;
    // With a lead, a step's operand loads are issued Lead steps ahead: a
    // step past the unit, or past the span, reads an in-bounds node
    // instead, so none waits on a branch.
    constexpr int kLead = Lead<TC, TS>::value;
    const int l0 = l;
    const int steps = mu.t1 - mu.t0;
    struct Ops {
      float an_s, bw, bw_e;
    };
    const auto ops_at = [&](int k) {
      const int lk = k < steps ? l0 + k * g2 : l0;
      const bool below = k < steps && mu.t0 + k < mu.t_last;
      Ops o;
      o.an_s = up(an_l[below ? lk + g2 : lk]);
      o.bw = up(bw_l[lk]);
      o.bw_e = up(bw_l[lk + 1 < len ? lk + 1 : lk]);
      return o;
    };
    Ops ring[kLead > 0 ? kLead : 1];
#pragma unroll
    for (int j = 0; j < kLead; ++j) ring[j] = ops_at(j);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (mu.t0 + k >= mu.t1) break;
      const bool below = mu.t0 + k < mu.t_last;  // the row below: in the span
      const bool inner = col_in && i >= 1 && i <= M - 1;
      const float pd = below ? up(s_p[l + g2]) : hs;
      float v = 0.f;
      if constexpr (kLead > 0) {
        const Ops o = ring[k % kLead];
        ring[k % kLead] = ops_at(k + kLead);
        an_s = below ? o.an_s : (inner ? up(__ldg(an_g + q + g2)) : 0.f);
        if (inner) {
          const bool east = l + 1 < len;
          const float pl = l >= 1 ? up(s_p[l - 1]) : hw;
          const float pr = east ? up(s_p[l + 1]) : he;
          bw_c = o.bw;
          bw_e = east ? o.bw_e : up(__ldg(bw_g + q + 1));
          const float ax = an_c * (pc - pu) + an_s * (pc - pd);
          const float ay = bw_c * (pc - pl) + bw_e * (pc - pr);
          v = R(ax + ay);
          acc[0] += v * pc;
        }
      } else {
        an_s = 0.f;
        if (below) {
          an_s = up(an_l[l + g2]);
        } else if (inner) {
          an_s = up(__ldg(an_g + q + g2));
        }
        if (inner) {
          const bool east = l + 1 < len;
          const float pl = l >= 1 ? up(s_p[l - 1]) : hw;
          const float pr = east ? up(s_p[l + 1]) : he;
          bw_e = east ? up(bw_l[l + 1]) : up(__ldg(bw_g + q + 1));
          const float ax = an_c * (pc - pu) + an_s * (pc - pd);
          bw_c = up(bw_l[l]);
          const float ay = bw_c * (pc - pl) + bw_e * (pc - pr);
          v = R(ax + ay);
          acc[0] += v * pc;
        }
      }
      ap_l[l] = down<TC>(v);
      pu = pc;
      pc = pd;
      an_c = an_s;
      l += g2;
      q += g2;
      ++i;
    }
  };

  // The update phase over one unit: w, the state, the two partials, and
  // the halo publish where the unit starts and ends the lane's column.
  double step[2];  // dw2, zr'
  float alpha = 0.f;
  const auto update_unit = [&](const pe::MarchUnit& mu) {
    if (!mu.active) return;
    const int l0 = mu.m + mu.t0 * g2;
    const int steps = mu.t1 - mu.t0;
    // the unit's ap and dinv, all loads in flight at once (a step past the
    // unit reads its first node again, so every load is in bounds)
    float ap_k[kSteps], dv_k[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int lk = k < steps ? l0 + k * g2 : l0;
      ap_k[k] = up(ap_l[lk]);
      dv_k[k] = up(dinv_l[lk]);
    }
    int l = l0;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int t = mu.t0 + k;
      if (t >= mu.t1) break;
      const float pn = up(s_p[l]);
      const float wo = up(s_w[l]);
      const float wn = R(wo + alpha * pn);
      s_w[l] = down<TC>(wn);
      const float dw = wn - wo;  // the realised step, not alpha*pn
      step[0] += dw * dw;
      const float apv = ap_k[k];
      const float dv = dv_k[k];
      float z;
      if (zstate) {
        z = R(up(s_r[l]) - alpha * (dv * apv));
        s_r[l] = down<TC>(z);
        // the guarded reciprocal: d = 1/dinv on the interior, 0 off it
        const float d = dv != 0.f ? 1.f / dv : 0.f;
        step[1] += (z * z) * d;
      } else {
        const float rn_ = R(up(s_r[l]) - alpha * apv);
        s_r[l] = down<TC>(rn_);
        z = rn_ * dv;
        step[1] += z * rn_;
      }
      if (t == 0 || t == mu.t_last) {  // pe::at_span_edge
        zpub[s + l] = z;
        ppub[s + l] = pn;
      }
      l += g2;
    }
  };

  int k = 0;
  while (k < max_iter && !c.converged && !c.breakdown) {
    // -- the pn pass
    pe::whole_stamp<kStamps>(stamps, k, pe::kBodyStart, false);
    if (zstate) {
      for (int l = tid; l < len; l += nthreads) {
        s_p[l] = down<TC>(up(s_r[l]) + c.beta * up(s_p[l]));
      }
    } else {
      for (int l = tid; l < len; l += nthreads) {
        s_p[l] =
            down<TC>(up(s_r[l]) * up(s_dinv[l]) + c.beta * up(s_p[l]));
      }
    }
    __syncthreads();
    pe::whole_stamp<kStamps>(stamps, k, pe::kPnEnd, false);
    hw = R(hwz + c.beta * hw);
    he = R(hez + c.beta * he);

    // -- stencil phase: each warp marches its units, the ones past the
    // first kAhead with their halo loaded as each starts
    acc[0] = 0.0;
    pe::UnitIter it = first;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      stencil_unit(pe::march_unit(split, it, lane, g2, geom), halo[j],
                   carry[j]);
      pe::next_unit(split, it);
    }
    for (; it.seg < split.segs; pe::next_unit(split, it)) {
      const pe::MarchUnit more = pe::march_unit(split, it, lane, g2, geom);
      const pe::UnitHalo h = pe::load_halo(more, zpub, ppub, s, g2, n);
      float hp[2] = {h.pn, h.ps};
      stencil_unit(more, h, hp);
    }
    pe::whole_stamp<kStamps>(stamps, k, pe::kStencilEnd, true);
    float denom_sum[1], sums[2];
    pe::grid_reduce_warp<1>(acc, part_denom, scratch, denom_sum);
    pe::whole_stamp<kStamps>(stamps, k, pe::kSum1, false);
    const float denom = R(R(denom_sum[0]) * h1h2);
    const bool breakdown = pe::below_guard<TC>(denom);
    alpha = pe::guarded_alpha<TC>(c.zr, denom);

    // -- update phase: the same units in the same order; the next
    // iteration's halo loads ride the second sums
    step[0] = 0.0;
    step[1] = 0.0;
    for (it = first; it.seg < split.segs; pe::next_unit(split, it)) {
      update_unit(pe::march_unit(split, it, lane, g2, geom));
    }
    pe::whole_stamp<kStamps>(stamps, k, pe::kUpdateEnd, true);
    pe::grid_reduce_warp<2>(step, part_step, scratch, sums, fetch_halo);
    pe::whole_stamp<kStamps>(stamps, k, pe::kSum2, false);
    pe::next_carry<TC>(c, breakdown, R(sums[0]), R(sums[1]), h1h2, delta,
                       weighted);
    ++k;
  }

  for (int l = tid; l < len; l += nthreads) w_out[s + l] = s_w[l];
  pe::write_status<TC>(status, diff_out, k, c);
}

// ``smem`` is the dynamic shared memory ops/streamed_pcg.py:StreamPlan
// sized, the number its gate reads; a size below what ``span`` nodes of
// the state and of each resident operand need at TC is refused rather
// than overrun. h1h2 and delta are the TC-rounded values. With ``stamps``
// the timing instantiation runs.
template <typename TC, typename TS>
int launch(const TS* dinv, const TS* an, const TS* bw, const TC* r0, TC* w,
           TC* ap, float* zpub, float* ppub, double* partials, int* status,
           TC* diff, int g1, int g2, int span, int resident, int nblocks,
           int smem, int max_iter, float h1h2, float delta, int weighted,
           void* stream, unsigned long long* stamps = nullptr) {
  const int arrays = 3 + __builtin_popcount(static_cast<unsigned>(resident & 15));
  const long need =
      static_cast<long>(sizeof(TC)) * arrays * span + pe::kReduceBytes;
  if (span < 1 || smem < need || nblocks > pe::kMaxPartials) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pe::MarchSplit split = pe::march_split(span, g2, kSteps, kMaxWarps);
  void* args[] = {&dinv,     &an,       &bw,    &r0,     &w,    &ap,
                  &zpub,     &ppub,     &partials, &status, &diff, &g1,
                  &g2,       &span,     &resident, &split, &max_iter,
                  &h1h2,     &delta,    &weighted, &stamps};
  const auto kernel = stamps != nullptr ? streamed_kernel<TC, TS, true>
                                        : streamed_kernel<TC, TS, false>;
  return pe::cooperative_launch(kernel, nblocks, 32 * split.warps, smem, args,
                                stream);
}

}  // namespace

extern "C" {

// One launcher a form (ops/streamed_pcg.py:FORMS), all with one argument
// list: the operands dinv, an, bw at the load type, the rest at the
// compute type; and each form's timing instantiation, with ``stamps``,
// max_iter * (kWholeStamps + 2 * nblocks) zeroed u64 (grid_sync.cuh:
// whole_stamp).
int pe_streamed_pcg_f32(
    const float* dinv, const float* an, const float* bw, const float* r0,
    float* w, float* ap, float* zpub, float* ppub, double* partials,
    int* status, float* diff, int g1, int g2, int span, int resident,
    int nblocks, int smem, int max_iter, float h1h2, float delta,
    int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_stamps_f32(
    const float* dinv, const float* an, const float* bw, const float* r0,
    float* w, float* ap, float* zpub, float* ppub, double* partials,
    int* status, float* diff, int g1, int g2, int span, int resident,
    int nblocks, int smem, int max_iter, float h1h2, float delta,
    int weighted, void* stream, unsigned long long* stamps) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream, stamps);
}

int pe_streamed_pcg_bf16(
    const __nv_bfloat16* dinv, const __nv_bfloat16* an,
    const __nv_bfloat16* bw, const __nv_bfloat16* r0, __nv_bfloat16* w,
    __nv_bfloat16* ap, float* zpub, float* ppub, double* partials,
    int* status, __nv_bfloat16* diff, int g1, int g2, int span, int resident,
    int nblocks, int smem, int max_iter, float h1h2, float delta,
    int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_stamps_bf16(
    const __nv_bfloat16* dinv, const __nv_bfloat16* an,
    const __nv_bfloat16* bw, const __nv_bfloat16* r0, __nv_bfloat16* w,
    __nv_bfloat16* ap, float* zpub, float* ppub, double* partials,
    int* status, __nv_bfloat16* diff, int g1, int g2, int span, int resident,
    int nblocks, int smem, int max_iter, float h1h2, float delta,
    int weighted, void* stream, unsigned long long* stamps) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream, stamps);
}

int pe_streamed_pcg_f32_bf16(
    const __nv_bfloat16* dinv, const __nv_bfloat16* an,
    const __nv_bfloat16* bw, const float* r0, float* w, float* ap,
    float* zpub, float* ppub, double* partials, int* status, float* diff,
    int g1, int g2, int span, int resident, int nblocks, int smem,
    int max_iter, float h1h2, float delta, int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_stamps_f32_bf16(
    const __nv_bfloat16* dinv, const __nv_bfloat16* an,
    const __nv_bfloat16* bw, const float* r0, float* w, float* ap,
    float* zpub, float* ppub, double* partials, int* status, float* diff,
    int g1, int g2, int span, int resident, int nblocks, int smem,
    int max_iter, float h1h2, float delta, int weighted, void* stream,
    unsigned long long* stamps) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream, stamps);
}

int pe_streamed_pcg_f32_f16(
    const __half* dinv, const __half* an, const __half* bw, const float* r0,
    float* w, float* ap, float* zpub, float* ppub, double* partials,
    int* status, float* diff, int g1, int g2, int span, int resident,
    int nblocks, int smem, int max_iter, float h1h2, float delta,
    int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_stamps_f32_f16(
    const __half* dinv, const __half* an, const __half* bw, const float* r0,
    float* w, float* ap, float* zpub, float* ppub, double* partials,
    int* status, float* diff, int g1, int g2, int span, int resident,
    int nblocks, int smem, int max_iter, float h1h2, float delta,
    int weighted, void* stream, unsigned long long* stamps) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream, stamps);
}

int pe_streamed_pcg_launch_query(int device, int smem, int* cooperative,
                                 int* blocks_per_sm) {
  return pe::launch_query(streamed_kernel<float, float, false>, kMaxThreads,
                          device, smem, cooperative, blocks_per_sm);
}

const char* pe_streamed_pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
