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
//   stencil phase, per 32x32 tile: w += alpha*p_old (dw2 partial);
//     pn = z + beta*p_old over the tile and a one-node halo, in shared
//     memory; ap = interior ? an*(pc-pu) + an_s*(pc-pd)
//                             + bw*(pc-pl) + bw_e*(pc-pr) : 0
//     (the unmasked form, :197-225); store ap and pn; (ap, pn) partial
//   update phase, grid-stride: z -= alpha*(dinv*ap); (z*z)*(1/dinv)
//     partial with the guarded reciprocal (:364-380)
//
// The trap: the TPU kernel stores pn into p in place (:291-292). That is
// safe there only because its tiles run in order, each reading its own old
// p before writing pn, with the stencil's halo taken from a ring of pn
// tiles in VMEM. Here blocks run in no order, and a block building its
// halo pn = z + beta*p from a neighbour's p could read the new p as the
// old one. So p is ping-ponged: body i reads p[i % 2] and writes
// p[(i + 1) % 2], and every block rebuilds its halo from z and the old p,
// as K1 does.
//
// Scalars: three grid sums per body (dw2 and (ap, pn) with one barrier,
// (z, r) with a second; grid_sync.cuh, accumulated in double), the same
// bits in every block. Built with -fmad=false: arrays match
// ops/xl_pcg.py:xl_plain bitwise, and with the sums in double the whole
// solve does too, in practice.
//
// What bounds it: bytes. Per body the stencil phase reads z, p_old, w, an,
// bw and writes w, pn, ap (8 passes), the update phase reads z, dinv, ap and
// writes z (4): 12 array passes, plus the tile halo rereads of z, p_old
// (132/1024 each), an (1/32) and bw (1/32) (ops/xl_pcg.py:XLPlan). At
// 2401x3201 f32 one pass is 30.74 MB, so a body moves ~379 MB: 113 us at
// 3.35 TB/s.

#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int kTile = 32;       // a 32x32 tile of nodes per step
constexpr int kThreads = 256;   // 32 columns x 8 rows of threads
constexpr int kHalo = kTile + 2;

__global__ void __launch_bounds__(kThreads)
xl_kernel(const float* __restrict__ dinv_g, const float* __restrict__ an_g,
          const float* __restrict__ bw_g, const float* __restrict__ r0_g,
          float* w, float* z, float* p0, float* p1, float* ap,
          double* partials, int* status, float* diff_out, int g1, int g2,
          int max_iter, float h1h2, float delta, int weighted) {
  __shared__ float s_pn[kHalo][kHalo + 1];
  __shared__ double scratch[pe::kReduceDoubles];
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int n = g1 * g2;
  const int M = g1 - 1, N = g2 - 1;
  const int nb = gridDim.x;
  const int tiles_x = (g2 + kTile - 1) / kTile;
  const int ntiles = tiles_x * ((g1 + kTile - 1) / kTile);
  const int stride = nb * kThreads;
  double* part_dw2 = partials;
  double* part_denom = partials + nb;
  double* part_zr = partials + 2 * nb;

  // -- init: w = 0, p = 0, z = r0*dinv, zr0 = h1h2 * sum(z*r0)
  double acc = 0.0;
  for (int o = blockIdx.x * kThreads + tid; o < n; o += stride) {
    const float r = r0_g[o];
    const float zz = r * dinv_g[o];
    z[o] = zz;
    w[o] = 0.f;
    p0[o] = 0.f;
    acc += zz * r;
  }
  float zr = pe::grid_reduce(acc, part_zr, scratch) * h1h2;
  float alpha = 0.f, beta = 0.f;
  float diff = __int_as_float(0x7f800000);  // +inf
  bool conv = false, bd = false;

  int i = 0;  // bodies run
  while (i < max_iter + 1 && !conv && !bd) {
    const float* p_old = (i & 1) ? p1 : p0;
    float* p_new = (i & 1) ? p0 : p1;

    // -- stencil phase, tile by tile
    double dw2 = 0.0, den = 0.0;
    for (int t = blockIdx.x; t < ntiles; t += nb) {
      const int i0 = (t / tiles_x) * kTile;
      const int j0 = (t % tiles_x) * kTile;
      __syncthreads();  // the previous tile's reads of s_pn are done
      for (int e = tid; e < kHalo * kHalo; e += kThreads) {
        const int li = e / kHalo;
        const int lj = e - li * kHalo;
        const int gi = i0 - 1 + li;
        const int gj = j0 - 1 + lj;
        float v = 0.f;  // outside the grid pn is 0
        if (gi >= 0 && gi < g1 && gj >= 0 && gj < g2) {
          const int o = gi * g2 + gj;
          v = __ldcg(z + o) + beta * __ldcg(p_old + o);
        }
        s_pn[li][lj] = v;
      }
      __syncthreads();
      const int gj = j0 + tx;
      for (int rr = ty; rr < kTile; rr += kThreads / kTile) {
        const int gi = i0 + rr;
        if (gi < g1 && gj < g2) {
          const int o = gi * g2 + gj;
          // the deferred update of the previous body
          const float wo = __ldcg(w + o);
          const float wn = wo + alpha * __ldcg(p_old + o);
          w[o] = wn;
          const float dw = wn - wo;
          dw2 += dw * dw;
          const float pc = s_pn[rr + 1][tx + 1];
          float v = 0.f;
          if (gi >= 1 && gi <= M - 1 && gj >= 1 && gj <= N - 1) {
            const float ax = an_g[o] * (pc - s_pn[rr][tx + 1]) +
                             an_g[o + g2] * (pc - s_pn[rr + 2][tx + 1]);
            const float ay = bw_g[o] * (pc - s_pn[rr + 1][tx]) +
                             bw_g[o + 1] * (pc - s_pn[rr + 1][tx + 2]);
            v = ax + ay;
            den += v * pc;
          }
          ap[o] = v;
          p_new[o] = pc;
        }
      }
    }
    float dw2_sum, den_sum;
    pe::grid_reduce2(dw2, den, part_dw2, part_denom, scratch, &dw2_sum,
                     &den_sum);
    const float denom = den_sum * h1h2;
    float nd = weighted ? sqrtf(dw2_sum * h1h2) : sqrtf(dw2_sum);
    // convergence of the previous reference iteration (body 0 has none)
    const bool cv = i >= 1 && nd < delta;
    nd = i >= 1 ? nd : diff;
    // this body's denominator belongs to reference iteration i+1: a guard
    // trip is a breakdown only while that iteration is within the cap
    const bool guard = denom < pe::kDenomGuard;
    const bool bdn = !cv && guard && i < max_iter;
    const float alpha_new = pe::guarded_alpha(zr, denom);

    // -- update phase: z and the (z, r) partial off one dinv read
    acc = 0.0;
    for (int o = blockIdx.x * kThreads + tid; o < n; o += stride) {
      const float dv = dinv_g[o];
      const float zn = __ldcg(z + o) - alpha_new * (dv * __ldcg(ap + o));
      z[o] = zn;
      // the guarded reciprocal: d = 1/dinv on the interior, 0 off it
      const float d = dv != 0.f ? 1.f / dv : 0.f;
      acc += (zn * zn) * d;
    }
    const float zr_new = pe::grid_reduce(acc, part_zr, scratch) * h1h2;

    beta = bdn ? beta : zr_new / zr;
    zr = bdn ? zr : zr_new;
    alpha = alpha_new;
    diff = nd;
    conv = cv;
    bd = bdn;
    ++i;
  }

  pe::Carry c{zr, beta, diff, conv, bd};
  pe::write_status(status, diff_out, conv ? i - 1 : min(i, max_iter), c);
}

}  // namespace

extern "C" {

int pe_xl_pcg_f32(const float* dinv, const float* an, const float* bw,
                  const float* r0, float* w, float* z, float* p0, float* p1,
                  float* ap, double* partials, int* status, float* diff, int g1,
                  int g2, int nblocks, int max_iter, float h1h2, float delta,
                  int weighted, void* stream) {
  void* args[] = {&dinv, &an, &bw, &r0, &w, &z, &p0, &p1, &ap, &partials,
                  &status, &diff, &g1, &g2, &max_iter, &h1h2, &delta,
                  &weighted};
  return pe::cooperative_launch(xl_kernel, nblocks, kThreads, 0, args, stream);
}

int pe_xl_pcg_launch_query(int device, int smem, int* cooperative,
                           int* blocks_per_sm) {
  return pe::launch_query(xl_kernel, kThreads, device, smem, cooperative,
                          blocks_per_sm);
}

const char* pe_xl_pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
