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
// operand directly, coalesced, and the L2 absorbs the row-below reread.
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
// the neighbour forms pn = z + beta*p from them. Two grid sums per
// iteration (grid_sync.cuh, accumulated in double) give every block the
// same carry. Built with -fmad=false: arrays match
// ops/streamed_pcg.py:streamed_plain bitwise, and with the sums in double
// the whole solve does too, in practice.
//
// The dtype axes: the kernel is a template on its compute type TC (the
// state, r0, ap, the halo buffers, w_out and diff) and on the load type TS
// of the operands dinv, an and bw (ops/streamed_pcg.py:FORMS):
// - f32: TC = TS = float, the kernel as before;
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
// budgets them) are the kernel's offsets for every form.
//
// What bounds it: bytes of the streamed operands. Each streamed operand is
// one array pass a iteration (ap two: written, then read); with every
// operand resident nothing but the halo and the partials moves, and the
// bound is the arithmetic and the two grid barriers.

#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int kThreads = 1024;

// resident-operand bits (ops/streamed_pcg.py:RESIDENT_BITS holds the same)
constexpr int kResAp = 1;
constexpr int kResDinv = 2;
constexpr int kResAn = 4;
constexpr int kResBw = 8;

// An operand at global node x: from shared memory inside the span when it
// is resident, else from device memory at its load type, upcast.
template <typename TC, typename TS>
__device__ __forceinline__ float operand_at(int x, int s, int len,
                                            const TC* s_op,
                                            const TS* __restrict__ g_op) {
  const int l = x - s;
  if (s_op != nullptr && l >= 0 && l < len) return up(s_op[l]);
  return up(__ldg(g_op + x));
}

template <typename TC, typename TS>
__global__ void __launch_bounds__(kThreads, 1)
streamed_kernel(const TS* __restrict__ dinv_g, const TS* __restrict__ an_g,
                const TS* __restrict__ bw_g, const TC* __restrict__ r0_g,
                TC* __restrict__ w_out, TC* __restrict__ ap_g, float* zpub,
                float* ppub, double* partials, int* status, TC* diff_out,
                int g1, int g2, int span, int resident, int max_iter,
                float h1h2, float delta, int weighted) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* scratch = reinterpret_cast<double*>(smem_raw);
  TC* s_w = reinterpret_cast<TC*>(smem_raw + pe::kReduceBytes);
  TC* s_r = s_w + span;  // r, or z in the z-state regime
  TC* s_p = s_r + span;
  TC* next = s_p + span;
  TC* s_ap = nullptr;
  TC* s_dinv = nullptr;
  TC* s_an = nullptr;
  TC* s_bw = nullptr;
  if (resident & kResAp) { s_ap = next; next += span; }
  if (resident & kResDinv) { s_dinv = next; next += span; }
  if (resident & kResAn) { s_an = next; next += span; }
  if (resident & kResBw) { s_bw = next; }
  const bool zstate = (resident & kResDinv) == 0;

  const int tid = threadIdx.x;
  const int n = g1 * g2;
  const int s = blockIdx.x * span;
  const int len = max(0, min(n, s + span) - s);
  const int M = g1 - 1, N = g2 - 1;
  const int nb = gridDim.x;
  double* part_denom = partials;
  double* part_dw2 = partials + nb;
  double* part_zr = partials + 2 * nb;
  const auto R = [](float x) { return rn<TC>(x); };

  // -- load the resident operands once; w = 0, p = 0, the state from r0
  double acc = 0.0;
  for (int l = tid; l < len; l += kThreads) {
    const int q = s + l;
    const float dv = up(dinv_g[q]);
    if (s_dinv) s_dinv[l] = down<TC>(dv);
    if (s_an) s_an[l] = down<TC>(up(an_g[q]));
    if (s_bw) s_bw[l] = down<TC>(up(bw_g[q]));
    const float r = up(r0_g[q]);
    // z0 is stored (the state) in the z-state regime only
    const float z = zstate ? R(r * dv) : r * dv;
    s_r[l] = down<TC>(zstate ? z : r);
    s_w[l] = down<TC>(0.f);
    s_p[l] = down<TC>(0.f);
    acc += z * r;
    if (pe::at_span_edge(l, len, g2)) {
      zpub[q] = z;
      ppub[q] = 0.f;
    }
  }
  pe::Carry c;
  c.zr = R(R(pe::grid_reduce(acc, part_zr, scratch)) * h1h2);
  c.beta = 0.f;
  c.diff = __int_as_float(0x7f800000);  // +inf
  c.converged = false;
  c.breakdown = false;

  int k = 0;
  // pn at any node the stencil reads (grid_sync.cuh: span_pn)
  const auto pn_at = [&](int x) {
    return pe::span_pn<TC>(x, s, len, s_p, zpub, ppub, c.beta);
  };
  const auto op = [&](int x, const TC* s_op, const TS* g_op) {
    return operand_at<TC, TS>(x, s, len, s_op, g_op);
  };
  while (k < max_iter && !c.converged && !c.breakdown) {
    // -- stencil phase: pn over the span, then ap and the (ap, pn) partial
    for (int l = tid; l < len; l += kThreads) {
      const float z =
          zstate ? up(s_r[l]) : up(s_r[l]) * op(s + l, s_dinv, dinv_g);
      s_p[l] = down<TC>(z + c.beta * up(s_p[l]));
    }
    __syncthreads();
    acc = 0.0;
    for (int l = tid; l < len; l += kThreads) {
      const int q = s + l;
      const int i = q / g2;
      const int jj = q - i * g2;
      float v = 0.f;
      if (i >= 1 && i <= M - 1 && jj >= 1 && jj <= N - 1) {
        const float pc = up(s_p[l]);
        const float pu = pn_at(q - g2);
        const float pd = pn_at(q + g2);
        const float pl = pn_at(q - 1);
        const float pr = pn_at(q + 1);
        const float ax = op(q, s_an, an_g) * (pc - pu) +
                         op(q + g2, s_an, an_g) * (pc - pd);
        const float ay = op(q, s_bw, bw_g) * (pc - pl) +
                         op(q + 1, s_bw, bw_g) * (pc - pr);
        v = R(ax + ay);
        acc += v * pc;
      }
      if (s_ap) {
        s_ap[l] = down<TC>(v);
      } else {
        ap_g[q] = down<TC>(v);
      }
    }
    const float denom =
        R(R(pe::grid_reduce(acc, part_denom, scratch)) * h1h2);
    const bool breakdown = pe::below_guard<TC>(denom);
    const float alpha = pe::guarded_alpha<TC>(c.zr, denom);

    // -- update phase: w, the state, the two partials, the halo publish
    double dw2 = 0.0, zrs = 0.0;
    for (int l = tid; l < len; l += kThreads) {
      const int q = s + l;
      const float pn = up(s_p[l]);
      const float wo = up(s_w[l]);
      const float wn = R(wo + alpha * pn);
      s_w[l] = down<TC>(wn);
      const float dw = wn - wo;  // the realised step, not alpha*pn
      dw2 += dw * dw;
      const float apv = up(s_ap ? s_ap[l] : ap_g[q]);
      const float dv = op(q, s_dinv, dinv_g);
      float z;
      if (zstate) {
        z = R(up(s_r[l]) - alpha * (dv * apv));
        s_r[l] = down<TC>(z);
        // the guarded reciprocal: d = 1/dinv on the interior, 0 off it
        const float d = dv != 0.f ? 1.f / dv : 0.f;
        zrs += (z * z) * d;
      } else {
        const float rn_ = R(up(s_r[l]) - alpha * apv);
        s_r[l] = down<TC>(rn_);
        z = rn_ * dv;
        zrs += z * rn_;
      }
      if (pe::at_span_edge(l, len, g2)) {
        zpub[q] = z;
        ppub[q] = pn;
      }
    }
    float dw2_sum, zr_sum;
    pe::grid_reduce2(dw2, zrs, part_dw2, part_zr, scratch, &dw2_sum, &zr_sum);
    pe::next_carry<TC>(c, breakdown, R(dw2_sum), R(zr_sum), h1h2, delta,
                       weighted);
    ++k;
  }

  for (int l = tid; l < len; l += kThreads) w_out[s + l] = s_w[l];
  pe::write_status<TC>(status, diff_out, k, c);
}

// ``smem`` is the dynamic shared memory ops/streamed_pcg.py:StreamPlan
// sized, the number its gate reads; a size below what ``span`` nodes of
// the state and of each resident operand need at TC is refused rather
// than overrun. h1h2 and delta are the TC-rounded values.
template <typename TC, typename TS>
int launch(const TS* dinv, const TS* an, const TS* bw, const TC* r0, TC* w,
           TC* ap, float* zpub, float* ppub, double* partials, int* status,
           TC* diff, int g1, int g2, int span, int resident, int nblocks,
           int smem, int max_iter, float h1h2, float delta, int weighted,
           void* stream) {
  const int arrays = 3 + __builtin_popcount(static_cast<unsigned>(resident & 15));
  const long need =
      static_cast<long>(sizeof(TC)) * arrays * span + pe::kReduceBytes;
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&dinv,    &an,   &bw,     &r0,   &w,   &ap,   &zpub,
                  &ppub,    &partials, &status, &diff, &g1, &g2, &span,
                  &resident, &max_iter, &h1h2, &delta, &weighted};
  return pe::cooperative_launch(streamed_kernel<TC, TS>, nblocks, kThreads,
                                smem, args, stream);
}

}  // namespace

extern "C" {

// One launcher a form (ops/streamed_pcg.py:FORMS), all with one argument
// list: the operands dinv, an, bw at the load type, the rest at the
// compute type.
int pe_streamed_pcg_f32(const float* dinv, const float* an, const float* bw,
                        const float* r0, float* w, float* ap, float* zpub,
                        float* ppub, double* partials, int* status, float* diff,
                        int g1, int g2, int span, int resident, int nblocks,
                        int smem, int max_iter, float h1h2, float delta,
                        int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_bf16(const __nv_bfloat16* dinv, const __nv_bfloat16* an,
                         const __nv_bfloat16* bw, const __nv_bfloat16* r0,
                         __nv_bfloat16* w, __nv_bfloat16* ap, float* zpub,
                         float* ppub, double* partials, int* status,
                         __nv_bfloat16* diff,
                         int g1, int g2, int span, int resident, int nblocks,
                         int smem, int max_iter, float h1h2, float delta,
                         int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_f32_bf16(const __nv_bfloat16* dinv,
                             const __nv_bfloat16* an, const __nv_bfloat16* bw,
                             const float* r0, float* w, float* ap, float* zpub,
                             float* ppub, double* partials, int* status,
                             float* diff, int g1, int g2, int span,
                             int resident, int nblocks, int smem, int max_iter,
                             float h1h2, float delta, int weighted,
                             void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_f32_f16(const __half* dinv, const __half* an,
                            const __half* bw, const float* r0, float* w,
                            float* ap, float* zpub, float* ppub,
                            double* partials, int* status, float* diff, int g1,
                            int g2, int span, int resident, int nblocks,
                            int smem, int max_iter, float h1h2, float delta,
                            int weighted, void* stream) {
  return launch(dinv, an, bw, r0, w, ap, zpub, ppub, partials, status, diff,
                g1, g2, span, resident, nblocks, smem, max_iter, h1h2, delta,
                weighted, stream);
}

int pe_streamed_pcg_launch_query(int device, int smem, int* cooperative,
                                 int* blocks_per_sm) {
  return pe::launch_query(streamed_kernel<float, float>, kThreads, device,
                          smem, cooperative, blocks_per_sm);
}

const char* pe_streamed_pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
