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
// K-a (stencil.cu) and K1-shard (fused_sharded.cu) share it.

#pragma once

__device__ __forceinline__ float stencil_tree(float wc, float w_n, float w_s,
                                              float w_w, float w_e, float a_c,
                                              float a_s, float b_c, float b_e,
                                              float h1, float h2) {
  const float ax = -(a_s * (w_s - wc) / h1 - a_c * (wc - w_n) / h1) / h1;
  const float ay = -(b_e * (w_e - wc) / h2 - b_c * (wc - w_w) / h2) / h2;
  return ax + ay;
}
