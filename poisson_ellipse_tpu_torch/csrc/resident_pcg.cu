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
// of ops/fused_pcg.py, in 7 arrays instead of 10. ap is not an eighth
// array: it lives in registers (kPerThread values a thread, fixed by
// kThreads * kPerThread >= span, the gate of ops/resident_pcg.py) from the
// stencil to the update across the barrier between them.
//
// Halo: the stencil needs pn one row beyond the span's ends, owned by
// other blocks; each block publishes z = r*dinv and p at its span's edges
// and rebuilds a neighbour's pn from them (grid_sync.cuh: span_pn), as K1
// rebuilds its halo.
//
// Scalars: the two grid sums per iteration (grid_sync.cuh, accumulated in
// double) give every block the same carry, so every block takes the same
// exit; block 0 writes the status word. Built with -fmad=false, so every
// array value is the plain PyTorch version's
// (ops/resident_pcg.py:resident_plain) bitwise, and with the sums in
// double the whole solve is too, in practice.
//
// Compute type: the kernel is a template on TC, float or __nv_bfloat16
// (pe_resident_pcg_f32 / _bf16). The seven arrays, w_out and diff are TC
// (the halo buffers float); each value is computed in float and rounded to
// TC where it is stored (grid_sync.cuh), as resident_plain rounds it, so
// the bf16 form is its plain version bitwise and the float form is the f32
// kernel as before. At 2 bytes a node a block holds twice the span, so the
// bf16 form keeps 32 ap values a thread (kPerThread) where f32 keeps 16:
// the gate then scales with the element size (ops/resident_pcg.py:layout).
//
// What bounds it: operations, not bytes. Device memory is touched once to
// load the operands and once to store w; per iteration only the halo
// (2 rows a block, from L2) and the partials move. The floor per iteration
// is the arithmetic (about 24 flops a node) plus two grid barriers.

#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kArrays = 7;  // an, bw, d, dinv, w, r, p

// ap values a thread keeps in registers: the span a block holds over
// kThreads (ops/resident_pcg.py:PER_THREAD holds the same)
template <typename TC>
struct PerThread {
  static constexpr int value = sizeof(TC) == 4 ? 16 : 32;
};

template <typename TC>
__global__ void __launch_bounds__(kThreads, 1)
resident_kernel(const TC* __restrict__ an_g, const TC* __restrict__ bw_g,
                const TC* __restrict__ d_g, const TC* __restrict__ dinv_g,
                const TC* __restrict__ r0_g, TC* __restrict__ w_out,
                float* zpub, float* ppub, double* partials, int* status,
                TC* diff_out, int g1, int g2, int span, int max_iter,
                float h1h2, float delta, int weighted) {
  constexpr int kPerThread = PerThread<TC>::value;
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
  const int n = g1 * g2;
  const int s = blockIdx.x * span;
  const int len = max(0, min(n, s + span) - s);
  const int M = g1 - 1, N = g2 - 1;
  const int nb = gridDim.x;
  double* part_denom = partials;
  double* part_dw2 = partials + nb;
  double* part_zr = partials + 2 * nb;
  const auto R = [](float x) { return rn<TC>(x); };

  // -- load the operands once; w = 0, r = r0, p = 0 (beta0 = 0: p1 = z0)
  for (int l = tid; l < len; l += kThreads) {
    const int q = s + l;
    s_an[l] = an_g[q];
    s_bw[l] = bw_g[q];
    s_d[l] = d_g[q];
    s_dinv[l] = dinv_g[q];
    s_r[l] = r0_g[q];
    s_w[l] = down<TC>(0.f);
    s_p[l] = down<TC>(0.f);
  }
  __syncthreads();

  // zr0 = h1h2 * sum(z0*r0), and the first publish of the halo (p = 0)
  double acc = 0.0;
  for (int l = tid; l < len; l += kThreads) {
    const float r = up(s_r[l]);
    const float z = r * up(s_dinv[l]);
    acc += z * r;
    if (pe::at_span_edge(l, len, g2)) {
      zpub[s + l] = z;
      ppub[s + l] = 0.f;
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
  while (k < max_iter && !c.converged && !c.breakdown) {
    // -- stencil phase: pn over the span, then ap and the (ap, pn) partial
    for (int l = tid; l < len; l += kThreads) {
      s_p[l] = down<TC>(up(s_r[l]) * up(s_dinv[l]) + c.beta * up(s_p[l]));
    }
    __syncthreads();
    float ap[kPerThread];
    acc = 0.0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int l = tid + j * kThreads;
      float v = 0.f;
      if (l < len) {
        const int q = s + l;
        const int i = q / g2;
        const int jj = q - i * g2;
        if (i >= 1 && i <= M - 1 && jj >= 1 && jj <= N - 1) {
          const float pc = up(s_p[l]);
          const float pu = pn_at(q - g2);
          const float pd = pn_at(q + g2);
          const float pl = pn_at(q - 1);
          const float pr = pn_at(q + 1);
          const float as_ = up(l + g2 < len ? s_an[l + g2] : an_g[q + g2]);
          const float be = up(l + 1 < len ? s_bw[l + 1] : bw_g[q + 1]);
          v = R(up(s_d[l]) * pc -
                (up(s_an[l]) * pu + as_ * pd + up(s_bw[l]) * pl + be * pr));
          acc += v * pc;
        }
      }
      ap[j] = v;
    }
    const float denom =
        R(R(pe::grid_reduce(acc, part_denom, scratch)) * h1h2);
    const bool breakdown = pe::below_guard<TC>(denom);
    const float alpha = pe::guarded_alpha<TC>(c.zr, denom);

    // -- update phase: w, r, the two partials, and the halo publish
    double dw2 = 0.0, zrs = 0.0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int l = tid + j * kThreads;
      if (l < len) {
        const float pn = up(s_p[l]);
        const float wo = up(s_w[l]);
        const float wn = R(wo + alpha * pn);
        const float rn_ = R(up(s_r[l]) - alpha * ap[j]);
        s_w[l] = down<TC>(wn);
        s_r[l] = down<TC>(rn_);
        const float dw = wn - wo;  // the realised step, not alpha*pn
        dw2 += dw * dw;
        const float z = rn_ * up(s_dinv[l]);
        zrs += z * rn_;
        if (pe::at_span_edge(l, len, g2)) {
          zpub[s + l] = z;
          ppub[s + l] = pn;
        }
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

// ``smem`` is the dynamic shared memory ops/resident_pcg.py:layout sized,
// the number its gate reads; a size below what ``span`` nodes of the
// seven arrays need is refused rather than overrun. h1h2 and delta are
// the TC-rounded values.
template <typename TC>
int launch(const TC* an, const TC* bw, const TC* d, const TC* dinv,
           const TC* r0, TC* w, float* zpub, float* ppub, double* partials,
           int* status, TC* diff, int g1, int g2, int span, int nblocks,
           int smem, int max_iter, float h1h2, float delta, int weighted,
           void* stream) {
  const long need =
      static_cast<long>(sizeof(TC)) * kArrays * span + pe::kReduceBytes;
  if (span > kThreads * PerThread<TC>::value || smem < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&an,   &bw,     &d,    &dinv, &r0, &w,        &zpub,
                  &ppub, &partials, &status, &diff, &g1, &g2, &span,
                  &max_iter, &h1h2, &delta, &weighted};
  return pe::cooperative_launch(resident_kernel<TC>, nblocks, kThreads, smem,
                                args, stream);
}

}  // namespace

extern "C" {

int pe_resident_pcg_f32(const float* an, const float* bw, const float* d,
                        const float* dinv, const float* r0, float* w,
                        float* zpub, float* ppub, double* partials, int* status,
                        float* diff, int g1, int g2, int span, int nblocks,
                        int smem, int max_iter, float h1h2, float delta,
                        int weighted, void* stream) {
  return launch(an, bw, d, dinv, r0, w, zpub, ppub, partials, status, diff,
                g1, g2, span, nblocks, smem, max_iter, h1h2, delta, weighted,
                stream);
}

int pe_resident_pcg_bf16(const __nv_bfloat16* an, const __nv_bfloat16* bw,
                         const __nv_bfloat16* d, const __nv_bfloat16* dinv,
                         const __nv_bfloat16* r0, __nv_bfloat16* w,
                         float* zpub, float* ppub, double* partials,
                         int* status, __nv_bfloat16* diff,
                         int g1, int g2, int span, int nblocks, int smem,
                         int max_iter, float h1h2, float delta, int weighted,
                         void* stream) {
  return launch(an, bw, d, dinv, r0, w, zpub, ppub, partials, status, diff,
                g1, g2, span, nblocks, smem, max_iter, h1h2, delta, weighted,
                stream);
}

int pe_resident_pcg_launch_query(int device, int smem, int* cooperative,
                                 int* blocks_per_sm) {
  return pe::launch_query(resident_kernel<float>, kThreads, device, smem,
                          cooperative, blocks_per_sm);
}

const char* pe_resident_pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
