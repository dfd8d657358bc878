// The resident whole-solve kernel: every PCG iteration in one persistent
// cooperative launch, operands and state in shared memory across all SMs.
//
// Replaces: poisson_ellipse_tpu/ops/resident_pcg.py:_mega_kernel (built by
// build_resident_solver, pl.pallas_call at :234), which keeps every array
// in the TPU's VMEM for the whole solve.
//
// Per iteration (resident_pcg.py:150-184, z eliminated):
//   pn  = r*dinv + beta*p
//   ap  = d*pn - (an*pn_up + as*pn_dn + bw*pn_lf + be*pn_rt)   (masked)
//   denom = h1h2 * sum(ap*pn); alpha = zr/denom, 0 on breakdown
//   w += alpha*pn; r -= alpha*ap; dw2 = sum((w_new - w)^2), the realised
//   step; zr' = h1h2 * sum((r*dinv)*r); diff, beta, k and the exit flags.
//
// Layout: one block per SM. Block b owns the contiguous row-major span
// [b*span, b*span + span) of the n node grid (not whole rows: at 801x1201
// a whole-row split gives 7-row blocks whose arrays overflow 227 KB).
// Seven arrays live in its shared memory for the whole solve: the unmasked
// an = a/h1^2 and bw = b/h2^2, d and dinv (the operands), and w, r, p (the
// state). as_/be are an/bw one row / one column on, and the interior mask
// is formed from the node index: the same element values as the masked set
// of ops/fused_pcg.py, in 7 arrays instead of 10.
//
// Halo: the stencil needs pn one row beyond the span's ends, owned by
// other blocks; each block publishes z = r*dinv and p at its span's edges
// and rebuilds a neighbour's pn from them (grid_sync.cuh), as K1 rebuilds
// its halo.
//
// Scalars: the three grid sums per iteration (grid_sync.cuh
// grid_reduce_warp, accumulated in double; dw2 and zr' through one pass)
// give every block the same carry, so every block takes the same exit;
// block 0 writes the status word. Built with -fmad=false, so every array
// value is the plain PyTorch version's (ops/resident_pcg.py:resident_plain)
// bitwise, and with the sums in double the whole solve is too, in
// practice.
//
// Compute type: the kernel is a template on TC, float or __nv_bfloat16
// (pe_resident_pcg_f32 / _bf16). The seven arrays, w_out and diff are TC
// (the halo buffers float); each value is computed in float and rounded to
// TC where it is stored (grid_sync.cuh), as resident_plain rounds it, so
// the bf16 form is its plain version bitwise. At 2 bytes a node a block
// holds twice the span: the gate (ops/resident_pcg.py:layout) admits spans
// of up to 8192 nodes at f32 and 16384 at bf16.
//
// What bounds it: the two grid barriers with their sums, then the
// arithmetic and the shared-memory traffic; not bytes. Device memory is
// touched once to load the operands and once to store w; per iteration
// only the halo (z one row beyond each end of the span, from L2) and the
// partials move. The floor per iteration is about 24 flops a node plus two
// grid barriers with their sums (1.95-2.35 us each alone on the H100).
// The kernel before the march (a thread a node in strided 1-D loops) took
// 14.6 us a body at 801x1201 (chip_smoke.py --only whole-timing on the
// H100; PERF.md, section 6): its stencil phase 6.1 us, with an integer
// division, four branchy pn reads and two branchy coefficient reads a
// node, then 3.5 us in the first sum (1.8 of it the blocks' stencil-phase
// ends spreading) and 2.8 in the second's two sequential sums. This one
// takes 9.3 us a body there: pn pass 0.6, stencil phase 2.4, first sum
// 2.0, update phase 1.6, second sums 2.6 (the same run, PERF.md).
//
// Design (grid_sync.cuh, the march):
// - The stencil phase is a march: a lane owns a column of the span (its
//   span-local offset m < g2), a warp a strip of 32 such columns, and it
//   marches down the span-local rows of its unit (a strip and a segment of
//   its rows). The lane's grid row and column are formed once a unit,
//   without a division; the node a step later is g2 on. pn one row up and
//   an's row are carried down from the step before, so a step reads pn and
//   an one row down, pn one column either side and d, bw and bw one column
//   east, from shared memory. The expression tree is resident_plain's,
//   term for term.
// - The trap: p is overwritten in place with pn, and there is no room for
//   an eighth array at f32 (7288 nodes more would need 233,536 B of
//   232,448 at 801x1201). So a pn pass forms pn over the span before the
//   march and ends in one __syncthreads; the march then reads every
//   neighbour's pn from shared memory with no race.
// - ap across the first barrier: in registers, kSteps values a unit and
//   kUnits units a lane, where the split fits them (march_split: every
//   published grid), else in a device-memory scratch array (ap_g), read
//   back by the thread that wrote it. (Recomputing ap in the update phase
//   would need the halo twice, from buffers the neighbours rewrite in that
//   phase; an eighth shared array fits only the bf16 form.)
// - The update phase walks the same units in the same order: each lane
//   updates the nodes whose ap it holds, and publishes the halo where its
//   column starts and ends.
// - The halo: a __syncthreads waits for every load its threads have in
//   flight, so the halo loads ride the barrier that publishes the halo
//   (grid_reduce_warp's hook: issued right after it, while warp 0 adds
//   the partials), not the pn pass's barrier (0.6 us more there) nor the
//   march (an L2 round trip a unit). Only z moves: p at a halo node is the
//   pn this thread formed there the iteration before, the owner's p bit
//   for bit.
// - The sums take grid_reduce_warp: one pass for the (ap, pn) sum and one
//   for dw2 and zr' together, the partials added by warp 0 alone after the
//   barrier (grid_reduce_wide's second block sum took 0.5-1.0 us more).
// - Threads: a warp a unit, the units of a strip's rows cut so a warp has
//   at most kUnits of them (19 warps of 2 strips at 801x1201, 19 of 1 at
//   401x601, 26 of 2 at 1101x1651 bf16).
//
// kStamps: the timing instantiation (grid_sync.cuh whole_stamp), which
// stamps the phases of every body on the device clock (chip_smoke.py
// --only whole-timing). No engine runs it.

#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int kArrays = 7;  // an, bw, d, dinv, w, r, p

// Each form's span limit (the gate of ops/resident_pcg.py:SPAN_LIMIT, 8192
// nodes at f32: 512 threads of 16 nodes in the kernel before the march),
// the march's register budget (a unit's steps, at most, and the units a
// lane keeps ap for in registers) and the warps a block, at most
// (ops/resident_pcg.py:MAX_WARPS): 19 warps leave 104 registers a thread,
// 26 (a bf16 span's 52 strips, two a warp) 72.
template <typename TC>
struct Form;
template <>
struct Form<float> {
  static constexpr int kMaxSpan = 8192, kSteps = 8, kUnits = 2,
                       kMaxWarps = 19;
};
template <>
struct Form<__nv_bfloat16> {
  static constexpr int kMaxSpan = 16384, kSteps = 10, kUnits = 2,
                       kMaxWarps = 26;
};

template <typename TC, bool kApRegs, bool kStamps>
__global__ void __launch_bounds__(32 * Form<TC>::kMaxWarps, 1)
resident_kernel(const TC* __restrict__ an_g, const TC* __restrict__ bw_g,
                const TC* __restrict__ d_g, const TC* __restrict__ dinv_g,
                const TC* __restrict__ r0_g, TC* __restrict__ w_out,
                TC* __restrict__ ap_g, float* zpub, float* ppub,
                double* partials, int* status, TC* diff_out, int g1, int g2,
                int span, pe::MarchSplit split, int max_iter, float h1h2,
                float delta, int weighted, unsigned long long* stamps) {
  constexpr int kSteps = Form<TC>::kSteps;
  constexpr int kUnits = kApRegs ? Form<TC>::kUnits : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* scratch = reinterpret_cast<double*>(smem_raw);
  TC* s_an = reinterpret_cast<TC*>(smem_raw + pe::kReduceBytes);
  TC* s_bw = s_an + span;
  TC* s_d = s_bw + span;
  TC* s_dinv = s_d + span;
  TC* s_w = s_dinv + span;
  TC* s_r = s_w + span;
  TC* s_p = s_r + span;

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

  // -- load the operands once; w = 0, r = r0, p = 0 (beta0 = 0: p1 = z0);
  // zr0 = h1h2 * sum(z0*r0), and the first publish of the halo (p = 0)
  double acc[1] = {0.0};
  for (int l = tid; l < len; l += nthreads) {
    const int q = s + l;
    const TC r = r0_g[q];
    const TC dv = dinv_g[q];
    s_an[l] = an_g[q];
    s_bw[l] = bw_g[q];
    s_d[l] = d_g[q];
    s_dinv[l] = dv;
    s_r[l] = r;
    s_w[l] = down<TC>(0.f);
    s_p[l] = down<TC>(0.f);
    const float z = up(r) * up(dv);
    acc[0] += z * up(r);
    if (pe::at_span_edge(l, len, g2)) {
      zpub[q] = z;
      ppub[q] = 0.f;
    }
  }
  // bw one node past the span: be of the span's last node
  const float be_last =
      len > 0 && s + len < n ? up(__ldg(bw_g + s + len)) : 0.f;
  float ap[kUnits][kSteps];
  const pe::SpanGeom geom = pe::span_geom(s, len, g2);
  const pe::UnitIter first = pe::first_unit(split, warp);

  // The halo an iteration's stencil phase reads, loaded right after the
  // barrier that publishes it (the one that closes the update phase before
  // it: fetch_halo), while warp 0 adds the partials: z one node before and
  // one after the span, and at each of the first kUnits units' halo nodes
  // (in the global-ap form, z and p at the others' as each starts).
  float hwz = 0.f, hez = 0.f;
  pe::UnitHalo halo[kUnits];
  const auto fetch_halo = [&] {
    if (len > 0 && s >= 1) hwz = __ldcg(zpub + s - 1);
    if (len > 0 && s + len < n) hez = __ldcg(zpub + s + len);
    pe::UnitIter it = first;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      halo[j] = pe::load_halo(pe::march_unit(split, it, lane, g2, geom),
                              zpub, nullptr, s, g2, n);
      pe::next_unit(split, it);
    }
  };
  // p at those halo nodes: the pn this thread formed there the iteration
  // before (0 before the first, as p0)
  float hw = 0.f, he = 0.f;
  float carry[kUnits][2] = {};

  float zr_sum[1];
  pe::grid_reduce_warp<1>(acc, part_zr, scratch, zr_sum, fetch_halo);
  pe::Carry c;
  c.zr = R(R(zr_sum[0]) * h1h2);
  c.beta = 0.f;
  c.diff = __int_as_float(0x7f800000);  // +inf
  c.converged = false;
  c.breakdown = false;

  // The stencil phase's march over one unit: ap at each node (into
  // ``apu`` or ap_g) and the (ap, pn) partial. pn one row up is carried
  // from the step before; where the unit starts the lane's column it is
  // the halo ``h``, as is pn one row below the lane's last node.
  const auto stencil_unit = [&](const pe::MarchUnit& mu,
                                const pe::UnitHalo& h, float(&hp)[2],
                                float(&apu)[kSteps]) {
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
    float an_c = up(s_an[l]);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      if (mu.t0 + k >= mu.t1) break;
      const bool below = mu.t0 + k < mu.t_last;  // the row below: in the span
      const bool inner = col_in && i >= 1 && i <= M - 1;
      const float pd = below ? up(s_p[l + g2]) : hs;
      float as_ = 0.f;
      if (below) {
        as_ = up(s_an[l + g2]);
      } else if (inner) {
        as_ = up(__ldg(an_g + q + g2));
      }
      float v = 0.f;
      if (inner) {
        const bool east = l + 1 < len;
        const float pl = l >= 1 ? up(s_p[l - 1]) : hw;
        const float pr = east ? up(s_p[l + 1]) : he;
        const float be = east ? up(s_bw[l + 1]) : be_last;
        v = R(up(s_d[l]) * pc -
              (an_c * pu + as_ * pd + up(s_bw[l]) * pl + be * pr));
        acc[0] += v * pc;
      }
      if constexpr (kApRegs) {
        apu[k] = v;
      } else {
        ap_g[q] = down<TC>(v);
      }
      pu = pc;
      pc = pd;
      an_c = as_;
      l += g2;
      q += g2;
      ++i;
    }
  };

  // The update phase over one unit: w, r, the two partials, and the halo
  // publish where the unit starts and ends the lane's column.
  double step[2];  // dw2, zr'
  float alpha = 0.f;
  const auto update_unit = [&](const pe::MarchUnit& mu,
                               const float(&apu)[kSteps]) {
    if (!mu.active) return;
    int l = mu.m + mu.t0 * g2;
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int t = mu.t0 + k;
      if (t >= mu.t1) break;
      const float pn = up(s_p[l]);
      const float wo = up(s_w[l]);
      const float wn = R(wo + alpha * pn);
      float apv;
      if constexpr (kApRegs) {
        apv = apu[k];
      } else {
        apv = up(ap_g[s + l]);
      }
      const float rn_ = R(up(s_r[l]) - alpha * apv);
      s_w[l] = down<TC>(wn);
      s_r[l] = down<TC>(rn_);
      const float dw = wn - wo;  // the realised step, not alpha*pn
      step[0] += dw * dw;
      const float z = rn_ * up(s_dinv[l]);
      step[1] += z * rn_;
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
    for (int l = tid; l < len; l += nthreads) {
      s_p[l] = down<TC>(up(s_r[l]) * up(s_dinv[l]) + c.beta * up(s_p[l]));
    }
    __syncthreads();
    pe::whole_stamp<kStamps>(stamps, k, pe::kPnEnd, false);
    hw = R(hwz + c.beta * hw);
    he = R(hez + c.beta * he);

    // -- stencil phase: each warp marches its units
    acc[0] = 0.0;
    pe::UnitIter it = first;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      stencil_unit(pe::march_unit(split, it, lane, g2, geom), halo[j],
                   carry[j], ap[j]);
      pe::next_unit(split, it);
    }
    if constexpr (!kApRegs) {
      for (; it.seg < split.segs; pe::next_unit(split, it)) {
        const pe::MarchUnit more = pe::march_unit(split, it, lane, g2, geom);
        const pe::UnitHalo h = pe::load_halo(more, zpub, ppub, s, g2, n);
        float hp[2] = {h.pn, h.ps};
        stencil_unit(more, h, hp, ap[0]);
      }
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
    it = first;
    if constexpr (kApRegs) {
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        update_unit(pe::march_unit(split, it, lane, g2, geom), ap[j]);
        pe::next_unit(split, it);
      }
    } else {
      for (; it.seg < split.segs; pe::next_unit(split, it)) {
        update_unit(pe::march_unit(split, it, lane, g2, geom), ap[0]);
      }
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

// ``smem`` is the dynamic shared memory ops/resident_pcg.py:layout sized,
// the number its gate reads; a span past the form's limit or a size below
// what ``span`` nodes of the seven arrays need is refused rather than
// overrun. ``ap`` is a scratch of n TC, read only where the march's split
// does not fit the registers (ops/resident_pcg.py:layout says where).
// h1h2 and delta are the TC-rounded values. With ``stamps`` the timing
// instantiation runs.
template <typename TC>
int launch(const TC* an, const TC* bw, const TC* d, const TC* dinv,
           const TC* r0, TC* w, TC* ap, float* zpub, float* ppub,
           double* partials, int* status, TC* diff, int g1, int g2, int span,
           int nblocks, int smem, int max_iter, float h1h2, float delta,
           int weighted, void* stream, unsigned long long* stamps = nullptr) {
  const long need =
      static_cast<long>(sizeof(TC)) * kArrays * span + pe::kReduceBytes;
  if (span < 1 || span > Form<TC>::kMaxSpan || smem < need ||
      nblocks > pe::kMaxPartials) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pe::MarchSplit split =
      pe::march_split(span, g2, Form<TC>::kSteps, Form<TC>::kMaxWarps);
  const bool regs = split.per_warp <= Form<TC>::kUnits;
  if (!regs && ap == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&an,       &bw,   &d,     &dinv,     &r0,   &w,
                  &ap,       &zpub, &ppub,  &partials, &status, &diff,
                  &g1,       &g2,   &span,  &split,    &max_iter, &h1h2,
                  &delta,    &weighted, &stamps};
  auto kernel = regs ? resident_kernel<TC, true, false>
                     : resident_kernel<TC, false, false>;
  if (stamps != nullptr) {
    kernel = regs ? resident_kernel<TC, true, true>
                  : resident_kernel<TC, false, true>;
  }
  return pe::cooperative_launch(kernel, nblocks, 32 * split.warps, smem, args,
                                stream);
}

}  // namespace

extern "C" {

int pe_resident_pcg_f32(const float* an, const float* bw, const float* d,
                        const float* dinv, const float* r0, float* w,
                        float* ap, float* zpub, float* ppub, double* partials,
                        int* status, float* diff, int g1, int g2, int span,
                        int nblocks, int smem, int max_iter, float h1h2,
                        float delta, int weighted, void* stream) {
  return launch(an, bw, d, dinv, r0, w, ap, zpub, ppub, partials, status,
                diff, g1, g2, span, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_resident_pcg_bf16(const __nv_bfloat16* an, const __nv_bfloat16* bw,
                         const __nv_bfloat16* d, const __nv_bfloat16* dinv,
                         const __nv_bfloat16* r0, __nv_bfloat16* w,
                         __nv_bfloat16* ap, float* zpub, float* ppub,
                         double* partials, int* status, __nv_bfloat16* diff,
                         int g1, int g2, int span, int nblocks, int smem,
                         int max_iter, float h1h2, float delta, int weighted,
                         void* stream) {
  return launch(an, bw, d, dinv, r0, w, ap, zpub, ppub, partials, status,
                diff, g1, g2, span, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

// The timing instantiations: each form's arguments and ``stamps``,
// max_iter * (kWholeStamps + 2 * nblocks) zeroed u64 (grid_sync.cuh:
// whole_stamp).
int pe_resident_pcg_stamps_f32(const float* an, const float* bw,
                               const float* d, const float* dinv,
                               const float* r0, float* w, float* ap,
                               float* zpub, float* ppub, double* partials,
                               int* status, float* diff, int g1, int g2,
                               int span, int nblocks, int smem, int max_iter,
                               float h1h2, float delta, int weighted,
                               void* stream, unsigned long long* stamps) {
  return launch(an, bw, d, dinv, r0, w, ap, zpub, ppub, partials, status,
                diff, g1, g2, span, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream, stamps);
}

int pe_resident_pcg_stamps_bf16(
    const __nv_bfloat16* an, const __nv_bfloat16* bw, const __nv_bfloat16* d,
    const __nv_bfloat16* dinv, const __nv_bfloat16* r0, __nv_bfloat16* w,
    __nv_bfloat16* ap, float* zpub, float* ppub, double* partials,
    int* status, __nv_bfloat16* diff, int g1, int g2, int span, int nblocks,
    int smem, int max_iter, float h1h2, float delta, int weighted,
    void* stream, unsigned long long* stamps) {
  return launch(an, bw, d, dinv, r0, w, ap, zpub, ppub, partials, status,
                diff, g1, g2, span, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream, stamps);
}

int pe_resident_pcg_launch_query(int device, int smem, int* cooperative,
                                 int* blocks_per_sm) {
  return pe::launch_query(resident_kernel<float, true, false>,
                          32 * Form<float>::kMaxWarps, device, smem,
                          cooperative, blocks_per_sm);
}

const char* pe_resident_pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
