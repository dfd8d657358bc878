// The pieces of a march that forms pn = z + beta*p as it goes down a strip
// of rows, with a lane owning two columns (one 4-byte word of bf16): the
// word loads and stores, pn's formation, and each node's west and east
// neighbours in pn. csrc/fused_pcg.cu's K1 bf16 form (k1_march_kernel) is
// built from them; the vector-lane march (lane_march.cuh) takes its word
// type and pn_of, with which the mesh's K1-shard bf16 forms pn.
//
// Frames. A row of an unpadded (g1, g2) grid starts at element i*g2, so at
// an odd g2 every other row starts in the middle of a 4-byte word. Words
// are never split across lanes: in row i a lane owns the word whose first
// element is column 2q - o(i), o(i) = (i*g2) & 1, the row's frame. Strip
// s, lane L owns columns (kStrip*s + 2L - o, kStrip*s + 2L + 1 - o): at
// an odd g2 the strip's columns move by one between rows, and every load
// and store is one aligned word. A neighbour row in the other frame is
// moved into this one with the shuffles the west and east neighbours take
// anyway: from frame 1 to frame 0 a lane needs (own y, next lane's x), its
// east pair; from frame 0 to frame 1 (previous lane's y, own x), its west
// pair. The columns a strip lacks come from its edges: pn one column west
// of lane 0's first and one column east of lane 31's last, recomputed
// from z and p.
//
// Masks. A word may hold a column outside the grid (column -1, the last
// element of the row above, or column g2, the first of the row below). A
// masked load reads the whole word where either half is in the grid, with
// one predicated load (two loads into one register would wait for each
// other), and pn's halves outside the grid are set to 0 (keep); a masked
// store writes only the halves inside, so no word is written by two strips
// or two rows, and nothing computed outside the grid is stored or summed.
// The last element of an array of odd length starts a word that would end
// past the array: that row is read element by element (load_end).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "storage.cuh"

namespace pn_march {

constexpr unsigned kFull = 0xffffffffu;
// columns a lane owns, and a warp's strip
constexpr int kPair = 2;
constexpr int kStrip = 32 * kPair;

// Strips of a row: its words, ceil(g2 / 2) in either frame, 32 a strip.
__host__ __device__ inline int strips(int g2) {
  return ((g2 + 1) / 2 + 31) / 32;
}

// Two bf16 in one word, the element at the lower address in the low half.
struct Two {
  using W = uint32_t;
  static __device__ __forceinline__ W load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  // The word at p where either half is in the grid, 0 where neither is:
  // one predicated load. The half outside the grid holds what the array
  // has there (a node of the next or the previous row); whoever uses it
  // masks it (keep, the masked store). Nothing is combined here, so the
  // load is not waited for until it is used.
  static __device__ __forceinline__ W load(const __nv_bfloat16* p,
                                           bool any) {
    W w = 0u;
    if (any) w = load(p);
    return w;
  }
  // The same at element o of an array of n, where the word may end past
  // the array (its last element starting a word): that element is read
  // alone.
  static __device__ __forceinline__ W load_end(const __nv_bfloat16* a,
                                               int64_t o, int64_t n, bool vx,
                                               bool vy) {
    if (o + 1 < n) return load(a + o, vx || vy);
    return vx ? W(__bfloat16_as_ushort(__ldg(a + o))) : 0u;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, W w) {
    *reinterpret_cast<unsigned int*>(p) = w;
  }
  // the halves inside the grid: the word, or one half alone
  static __device__ __forceinline__ void store(__nv_bfloat16* p, W w,
                                               bool vx, bool vy) {
    const bool both = vx && vy;
    if (both) store(p, w);
    if (vx && !both) {
      p[0] = __ushort_as_bfloat16(static_cast<unsigned short>(w));
    }
    if (vy && !both) {
      p[1] = __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16));
    }
  }
  // the halves inside the grid kept, the others +0
  static __device__ __forceinline__ W keep(W w, bool vx, bool vy) {
    return w & ((vx ? 0x0000ffffu : 0u) | (vy ? 0xffff0000u : 0u));
  }
  // exact widening
  static __device__ __forceinline__ float2 unpack(W w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
  // x and y each rounded to bf16 (nearest even), as rn/down round one
  static __device__ __forceinline__ W pack(float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned int*>(&h);
  }
};

// pn = z + beta*p for both columns of a word, each rounded to bf16: the
// value rn<bf16>(up(z) + beta * up(p)) of one node.
__device__ __forceinline__ Two::W pn_of(Two::W z, Two::W p, float beta) {
  const float2 zz = Two::unpack(z);
  const float2 pp = Two::unpack(p);
  return Two::pack(zz.x + beta * pp.x, zz.y + beta * pp.y);
}

// Each node's west neighbour in a row r of pn: the previous lane's second
// column, the strip's west edge e for lane 0.
__device__ __forceinline__ float2 west(float2 r, float e, int lane) {
  float w = __shfl_up_sync(kFull, r.y, 1);
  if (lane == 0) w = e;
  return make_float2(w, r.x);
}

// Each node's east neighbour: the next lane's first column, the strip's
// east edge e for lane 31.
__device__ __forceinline__ float2 east(float2 r, float e, int lane) {
  float v = __shfl_down_sync(kFull, r.x, 1);
  if (lane == 31) v = e;
  return make_float2(r.y, v);
}

}  // namespace pn_march
