// The 5-point variable-coefficient stencil at one node, in the reference's
// expression tree (stage0/Withoutopenmp1.cpp:83-85; ops/stencil.py
// apply_a_block): each difference is divided by h before the terms are
// combined,
//   ax = -(a_s*(w_s - wc)/h1 - a_c*(wc - w_n)/h1)/h1
//   ay = -(b_e*(w_e - wc)/h2 - b_c*(wc - w_w)/h2)/h2
//   A.w = ax + ay
// with w_n/w_s the values at rows i-1/i+1, w_w/w_e at columns j-1/j+1,
// a_c = a[i,j], a_s = a[i+1,j], b_c = b[i,j], b_e = b[i,j+1]. Built with
// -fmad=false, no product is contracted into an FMA, so a kernel that
// calls it computes the plain PyTorch version's bits.
//
// The tree is four face fluxes, coef*(hi - lo)/h, combined. A face's flux
// is one expression of the same operands from either node beside it: node
// (i, j)'s south term a_s*(w_s - wc)/h1 is node (i+1, j)'s north term
// a_c*(wc - w_n)/h1, and its east term node (i, j+1)'s west term. So a
// kernel may compute a flux once and hand it to both nodes (stencil_dots.cu
// does) and still compute this tree's bits.
//
// K-a, K-e and K-g (stencil.cu), the K-d family (stencil_dots.cu) and
// K1-shard (fused_sharded.cu) share it.

#pragma once

// x / h for h > 0, bitwise IEEE division: a zero x is its own quotient
// (+0 or -0), and only a nonzero x is divided. A zero dividend takes the
// division's slow path (FCHK), so a grid whose fluxes are mostly zero (the
// solver's state outside the ellipse) ran K-a at 90 us against 65 on
// seeded values on the H100 (PERF.md, section 7).
__device__ __forceinline__ float div_pos(float x, float h) {
  // the division as PTX, so the compiler cannot fold the select into it
  // and divide x itself
  float q;
  asm("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(x == 0.0f ? 1.0f : x),
      "f"(h));
  return x == 0.0f ? x : q;
}

// The flux through one face: coef*(hi - lo)/h, a rounded difference, a
// rounded product, a rounded division (div_pos: the same bits).
__device__ __forceinline__ float face_flux(float coef, float hi, float lo,
                                           float h) {
  return div_pos(coef * (hi - lo), h);
}

// A.w at a node from its four face fluxes (south, north, east, west).
__device__ __forceinline__ float stencil_of_fluxes(float f_s, float f_n,
                                                   float f_e, float f_w,
                                                   float h1, float h2) {
  const float ax = div_pos(-(f_s - f_n), h1);
  const float ay = div_pos(-(f_e - f_w), h2);
  return ax + ay;
}

__device__ __forceinline__ float stencil_tree(float wc, float w_n, float w_s,
                                              float w_w, float w_e, float a_c,
                                              float a_s, float b_c, float b_e,
                                              float h1, float h2) {
  return stencil_of_fluxes(face_flux(a_s, w_s, wc, h1),
                           face_flux(a_c, wc, w_n, h1),
                           face_flux(b_e, w_e, wc, h2),
                           face_flux(b_c, wc, w_w, h2), h1, h2);
}
