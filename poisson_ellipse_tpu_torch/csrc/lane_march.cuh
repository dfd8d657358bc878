// The vector-lane march of the bf16 stencils: K-e bf16 (stencil.cu,
// pe_batched_stencil_bf16), K-f bf16 (stencil_dots.cu,
// pe_batched_stencil_dots_bf16) and K1-shard bf16 (fused_sharded.cu,
// pe_fused_sharded_k1_bf16). A lane owns two columns, a warp marches a
// strip of 64 columns down ``rows`` rows of one lane's grid (a unit), and
// a block takes kWarps units of one lane in a row, numbered row tile by
// row tile, so the grid, the split of the nodes and the order of every
// sum follow the grid's shape (g1, g2, pad, lanes) alone.
//
// Columns. Lane L of strip s owns the fixed columns c = 64 s + 2 L and
// c + 1 in every row, of every array. An array's row holds those two
// columns in one aligned 4-byte word where the row's element c is at an
// even offset (frame 0), and else in the halves of two (frame 1): the
// lane then loads the aligned word (c - 1, c) and takes its high half and
// the next lane's low half (``fixed``), lane 31 the low half of the word
// past the strip, whose first column the unit's edge lanes hold. So every
// load is one aligned word, predicated, and no value is formed twice: the
// stencil, its fluxes and each product are computed in the fixed columns
// (the products of K-f in each operand's own word, no move needed).
//
// Frames. With a and b 4-byte aligned, element (l, i, j) of a (B, g1, g2)
// stack is at l g1 g2 + i g2 + j. The lane-shared a and b are in frame
// (i g2) & 1 in row i, lane l's w, out and pair operands in frame
// ((l g1 g2 + i g2) & 1): at an odd width the rows alternate, and odd lanes
// of an odd g1 g2 sit in the other frame from a and b (delta). A block-
// form out (pad 0, (B, g1 - 2, g2 - 2)) is in w's frame at an odd width and
// in frame 1 at an even one (flip). A unit starts at an even row, so each
// row's frames are fixed where the march is compiled (kOdd, kFlip, delta).
//
// Sources. The stencil's input rows come from a source policy: K-e and K-f
// read w itself (WRows, in the lane's delta); K1-shard forms pn = rn(z +
// beta p) from two windows (PnRows), each in a frame of its own against a
// and b (p starts mid-word in the halo exchange's stack where g1 g2 is
// odd), moving each word into the fixed columns before forming pn, so pn
// is formed once a node. A window in frame 1 starts mid-word: its row 0's
// first word begins one element before it, inside the same aligned word.
//
// Edges. A unit's lane k holds row r0 - 1 + k's values outside the strip,
// loaded once: w one column west of the strip, the west flux one column
// east of it (its last column's east flux), and w, a and b in the strip's
// last column (the halves a frame-1 row takes from the next strip). A row
// step takes them by a broadcast shuffle.
//
// The array's last element. A frame-0 word in an odd-width grid's last row
// at column g2 - 1 would end past an array of odd length, as would a
// window's frame-1 word at the grid's last column in an even-width grid
// (window_word). That element (the grid's corner, on the boundary ring)
// enters no node's stencil, so that one word is not loaded.
//
// What paces it: instructions, not bytes. A row step of 64 nodes takes
// about 210 instructions, its 8 IEEE divisions (div_pos, each a reciprocal
// refined by FMAs, a range check and a branch to the slow path) about 14
// each. Measured on the H100 (PERF.md, section 6; tools/lane_sweep.py):
// a product by the reciprocal in place of div_pos, not bitwise, would take
// K-e bf16 from 42.6 to 26.2 us; two rows of loads ahead are enough (an L2
// prefetch further ahead ran slower), four rows ahead doubled the loop
// and ran slower, as did two lanes a thread and a K-f whose warps split
// the stencil and the dot products.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "pn_march.cuh"
#include "stencil_tree.cuh"
#include "storage.cuh"

namespace lane_march {

using X = pn_march::Two;
using W = X::W;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStrip = pn_march::kStrip;  // columns a warp marches
constexpr int kWarps = 8;                  // units a block
constexpr int kThreads = 32 * kWarps;
// rows a unit marches: kMaxRows, halved (not below kMinRows) while the
// launch would give fewer than kFillBlocks blocks: two waves of three
// blocks on each of an H100's 132 SMs
constexpr int kMaxRows = 16;
constexpr int kMinRows = 4;
constexpr int64_t kFillBlocks = 2 * 132 * 3;
static_assert(kMaxRows + 2 <= 32, "lane k holds row r0 - 1 + k's edges");

template <int N>
using I = std::integral_constant<int, N>;

__host__ __device__ inline int strips(int g2) {
  return (g2 + kStrip - 1) / kStrip;
}
// row tiles of ``rows`` over the extended rows 0 .. g1 - 2 + pad (pad 0's
// first row takes part in no output row; it starts the first tile)
__host__ __device__ inline int tiles(int g1, int pad, int rows) {
  return (g1 - 1 + pad + rows - 1) / rows;
}
__host__ __device__ inline int64_t lane_blocks(int g1, int g2, int pad,
                                               int rows) {
  return ((int64_t)strips(g2) * tiles(g1, pad, rows) + kWarps - 1) / kWarps;
}
inline int rows_of(int g1, int g2, int pad, int lanes) {
  int rows = kMaxRows;
  while (rows > kMinRows &&
         lane_blocks(g1, g2, pad, rows) * lanes < kFillBlocks) {
    rows /= 2;
  }
  return rows;
}

// The lane of block z: the even lanes first, so that blocks of one frame
// run together (an odd g1 g2 alternates the frame by lane).
__device__ __forceinline__ int lane_of(int z, int lanes) {
  const int half = (lanes + 1) / 2;
  return z < half ? 2 * z : 2 * (z - half) + 1;
}

// Whether an array starts on a 4-byte boundary: the march loads words.
inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// Extended grid (g1, g2), output layout, spacings and rows a unit.
struct Geo {
  int g1, g2, pad, rows;
  float h1, h2;
};

// A lane's columns and what follows from them.
struct Cols {
  int c;          // first column (c, c + 1)
  bool ld0;       // frame 0: the word (c, c + 1) holds a column of the row
  bool corner;    // ... and is the odd-width grid's last column
  bool ld1;       // frame 1: the word (c - 1, c) holds a column of the row
  bool nx, ny;    // c, c + 1 are node columns
  bool nm;        // c - 1 is a node column (a frame-1 operand word's low)
  bool ox, oy;    // out holds column c, c + 1
  bool om;        // out holds column c - 1
};

__device__ __forceinline__ Cols cols_of(int c, int g2, int pad) {
  Cols k;
  k.c = c;
  k.ld0 = c < g2;
  k.corner = c == g2 - 1;
  k.ld1 = c - 1 < g2;
  k.nx = c >= 1 && c <= g2 - 2;
  k.ny = c + 1 <= g2 - 2;
  k.nm = c - 1 >= 1 && c - 1 <= g2 - 2;
  const int lo = 1 - pad, hi = g2 - 2 + pad;
  k.ox = c >= lo && c <= hi;
  k.oy = c + 1 >= lo && c + 1 <= hi;
  k.om = c - 1 >= lo && c - 1 <= hi;
  return k;
}

// A lane of a unit whose columns are all nodes: every flag set, no corner.
__device__ __forceinline__ Cols cols_inside(int c) {
  Cols k;
  k.c = c;
  k.ld0 = k.ld1 = k.nx = k.ny = k.nm = k.ox = k.oy = k.om = true;
  k.corner = false;
  return k;
}

// The word holding column c, whose element in an extended array's row is
// at ``pc``, in frame F; 0 where it holds none of the row. ``last``: the
// row is the grid's last, whose frame-0 word at the corner is not loaded.
template <int F>
__device__ __forceinline__ W word(const __nv_bfloat16* pc, const Cols& k,
                                  bool last) {
  if (F == 0) return X::load(pc, k.ld0 && !(k.corner && last));
  return X::load(pc - 1, k.ld1);
}

// ``word`` for a window in frame 1 at an even width (K1-shard's z or p off
// a word): there the frame-1 word at the grid's last column in its last
// row ends past the array; the corner, as above, is not loaded either.
template <int F>
__device__ __forceinline__ W window_word(const __nv_bfloat16* pc,
                                         const Cols& k, bool last, int g2) {
  if (F == 0) return word<0>(pc, k, last);
  return X::load(pc - 1, k.ld1 && !(last && k.c == g2));
}

// A row's word in frame F moved into the fixed columns: frame 0 as it is;
// frame 1 its high half and the next lane's low half, for lane 31 the
// strip's last-column value ``edge`` (raw, low half) that lane ``k``
// holds.
template <int F>
__device__ __forceinline__ W fixed(W w, W edge, int k, int lane) {
  if (F == 0) return w;
  W n = __shfl_down_sync(kFull, w, 1);
  const W e = __shfl_sync(kFull, edge, k);
  if (lane == 31) n = e;
  return __byte_perm(w, n, 0x5432);
}

__device__ __forceinline__ W raw(__nv_bfloat16 v) {
  return W(__bfloat16_as_ushort(v));
}

// Stores of out (written once): a word, or a half; streaming (evict
// first) unless kStream is false (K1-shard's pn and ap, which K2-shard
// reads next).
template <bool kStream>
__device__ __forceinline__ void st_word(__nv_bfloat16* p, W v) {
  if (kStream) {
    __stcs(reinterpret_cast<unsigned int*>(p), v);
  } else {
    *reinterpret_cast<unsigned int*>(p) = v;
  }
}
template <bool kStream>
__device__ __forceinline__ void st_half(__nv_bfloat16* p, W v) {
  if (kStream) {
    __stcs(reinterpret_cast<unsigned short*>(p),
           static_cast<unsigned short>(v));
  } else {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(v);
  }
}

// The fixed columns' values v = (col c, col c + 1) into out, whose element
// of column c is ``at``, in out's frame F: frame 0 one word, its halves
// masked; frame 1 the words (c - 1, c) from the previous lane's second
// value and this lane's first (lane 0 its first alone), lane 31 its second
// alone as well.
template <int F, bool kStream = true>
__device__ __forceinline__ void store(__nv_bfloat16* at, W v, const Cols& k,
                                      int lane) {
  if (F == 0) {
    if (k.ox && k.oy) st_word<kStream>(at, v);
    if (k.ox && !k.oy) st_half<kStream>(at, v);
    if (!k.ox && k.oy) st_half<kStream>(at + 1, v >> 16);
    return;
  }
  const W p = __shfl_up_sync(kFull, v, 1);
  const W s = __byte_perm(p, v, 0x5432);
  const bool lo = lane > 0 && k.om;
  if (lo && k.ox) st_word<kStream>(at - 1, s);
  if (lo && !k.ox) st_half<kStream>(at - 1, s);
  if (!lo && k.ox) st_half<kStream>(at, v);
  if (lane == 31 && k.oy) st_half<kStream>(at + 1, v >> 16);
}

// A unit's row-r0 - 1 + k edges (lane k): w one column west of the strip,
// the west flux of the column east of it, w in its last column.
struct LaneEdges {
  float ew, ef;
  W w63;
};
// The lane-shared coefficients in the strip's last column.
struct SharedEdges {
  W a63, b63;
};

__device__ __forceinline__ LaneEdges lane_edges(const __nv_bfloat16* w,
                                                const __nv_bfloat16* b,
                                                const Geo& g, int r0, int c0,
                                                int lane) {
  LaneEdges e{0.f, 0.f, 0u};
  const int i = r0 - 1 + lane;
  if (lane <= g.rows + 1 && i >= 0 && i < g.g1) {
    const int at = i * g.g2;
    if (c0 >= 1) e.ew = up(__ldg(w + at + c0 - 1));
    if (c0 + 63 < g.g2) e.w63 = raw(__ldg(w + at + c0 + 63));
    if (c0 + 64 < g.g2) {
      e.ef = face_flux(up(__ldg(b + at + c0 + 64)),
                       up(__ldg(w + at + c0 + 64)),
                       X::unpack(e.w63).x, g.h2);
    }
  }
  return e;
}

__device__ __forceinline__ SharedEdges shared_edges(const __nv_bfloat16* a,
                                                    const __nv_bfloat16* b,
                                                    const Geo& g, int r0,
                                                    int c0, int lane) {
  SharedEdges e{0u, 0u};
  const int i = r0 - 1 + lane;
  if (lane <= g.rows + 1 && i >= 0 && i < g.g1 && c0 + 63 < g.g2) {
    const int at = i * g.g2 + c0 + 63;
    e.a63 = raw(__ldg(a + at));
    e.b63 = raw(__ldg(b + at));
  }
  return e;
}

// The march state: w's current row and the north flux, in the fixed
// columns.
struct State {
  float2 wc, fn;
};

// K-e and K-f's source: w itself, lane l's grid, in frame D against a and
// b (1 for an odd lane of an odd g1 g2).
template <int D>
struct WRows {
  using Edges = LaneEdges;
  struct Slot {
    W w;
  };
  struct Cur {
    const __nv_bfloat16* pw;
  };
  const __nv_bfloat16* w;
  const __nv_bfloat16* wc = nullptr;  // w at the lane's column c of row 0

  __device__ __forceinline__ Edges edges(const __nv_bfloat16* b,
                                         const Geo& g, int r0, int c0,
                                         int lane) const {
    return lane_edges(w, b, g, r0, c0, lane);
  }
  __device__ __forceinline__ void at(int c) { wc = w + c; }
  // row i (a and b in frame F there) in the fixed columns; lane t holds
  // its edges
  template <int F>
  __device__ __forceinline__ W row(int i, int g2, const Cols& k, bool last,
                                   const Edges& e, int t, int lane) const {
    return fixed<F ^ D>(word<F ^ D>(wc + i * g2, k, last), e.w63, t, lane);
  }
  __device__ __forceinline__ Cur cursor(int i, int g2) const {
    return Cur{wc + i * g2};
  }
  // the next row's word from the cursor (a and b in frame F there)
  template <int F>
  __device__ __forceinline__ void issue(Cur& cur, Slot& sl, const Cols& k,
                                        bool down, bool last, int) const {
    sl.w = down ? word<F ^ D>(cur.pw, k, last) : 0u;
  }
  __device__ __forceinline__ void step(Cur& cur, int g2) const {
    cur.pw += g2;
  }
  template <int F>
  __device__ __forceinline__ W take(const Slot& sl, const Edges& e, int t,
                                    int lane) const {
    return fixed<F ^ D>(sl.w, e.w63, t, lane);
  }
};

// pn = rn(z + beta p) of one node from its stored z and p, as pn_of forms
// it for two.
__device__ __forceinline__ float pn_at(__nv_bfloat16 z, __nv_bfloat16 p,
                                       float beta) {
  return rn<__nv_bfloat16>(up(z) + beta * up(p));
}

// K1-shard's unit edges (lane k, row r0 - 1 + k): pn one column west of
// the strip, the west flux of the column east of it, and z and p (raw) in
// its last column.
struct PnEdges {
  float ew, ef;
  W z63, p63;
};

// K1-shard's source: pn = rn(z + beta p) on the (g1, g2) windows z and p,
// each in its own frame against a and b (DZ, DP), each word moved into the
// fixed columns and pn formed there, once a node.
template <int DZ, int DP>
struct PnRows {
  using Edges = PnEdges;
  struct Slot {
    W z, p;
  };
  struct Cur {
    const __nv_bfloat16 *pz, *pp;
  };
  const __nv_bfloat16* z;
  const __nv_bfloat16* p;
  float beta;
  const __nv_bfloat16* zc = nullptr;  // z and p at column c of row 0
  const __nv_bfloat16* pc = nullptr;

  __device__ __forceinline__ Edges edges(const __nv_bfloat16* b,
                                         const Geo& g, int r0, int c0,
                                         int lane) const {
    Edges e{0.f, 0.f, 0u, 0u};
    const int i = r0 - 1 + lane;
    if (lane <= g.rows + 1 && i >= 0 && i < g.g1) {
      const int at = i * g.g2;
      if (c0 >= 1) {
        e.ew = pn_at(__ldg(z + at + c0 - 1), __ldg(p + at + c0 - 1), beta);
      }
      if (c0 + 63 < g.g2) {
        e.z63 = raw(__ldg(z + at + c0 + 63));
        e.p63 = raw(__ldg(p + at + c0 + 63));
      }
      if (c0 + 64 < g.g2) {
        const float w63 = X::unpack(pn_march::pn_of(e.z63, e.p63, beta)).x;
        e.ef = face_flux(up(__ldg(b + at + c0 + 64)),
                         pn_at(__ldg(z + at + c0 + 64),
                               __ldg(p + at + c0 + 64), beta),
                         w63, g.h2);
      }
    }
    return e;
  }
  __device__ __forceinline__ void at(int c) {
    zc = z + c;
    pc = p + c;
  }
  template <int F>
  __device__ __forceinline__ W pn(W zw, W pw, const Edges& e, int t,
                                  int lane) const {
    return pn_march::pn_of(fixed<F ^ DZ>(zw, e.z63, t, lane),
                           fixed<F ^ DP>(pw, e.p63, t, lane), beta);
  }
  template <int F>
  __device__ __forceinline__ W row(int i, int g2, const Cols& k, bool last,
                                   const Edges& e, int t, int lane) const {
    return pn<F>(window_word<F ^ DZ>(zc + i * g2, k, last, g2),
                 window_word<F ^ DP>(pc + i * g2, k, last, g2), e, t, lane);
  }
  __device__ __forceinline__ Cur cursor(int i, int g2) const {
    return Cur{zc + i * g2, pc + i * g2};
  }
  template <int F>
  __device__ __forceinline__ void issue(Cur& cur, Slot& sl, const Cols& k,
                                        bool down, bool last, int g2) const {
    sl.z = down ? window_word<F ^ DZ>(cur.pz, k, last, g2) : 0u;
    sl.p = down ? window_word<F ^ DP>(cur.pp, k, last, g2) : 0u;
  }
  __device__ __forceinline__ void step(Cur& cur, int g2) const {
    cur.pz += g2;
    cur.pp += g2;
  }
  template <int F>
  __device__ __forceinline__ W take(const Slot& sl, const Edges& e, int t,
                                    int lane) const {
    return pn<F>(sl.z, sl.p, e, t, lane);
  }
};

// The policy for what a row step does besides the stencil (K-f's dot
// products, K1-shard's mask, pn and sum), each call given out's frame F of
// the row: ``issue`` loads its operands of row r kAhead steps ahead;
// with ``kOut``, ``out`` forms the word stored in out from the stencil's
// (lane t holds row r's edges); ``take`` does the rest, after out's store,
// given that word (kOut; else 0) and the source's row r (wr).
// ``kStream``: out's stores stream (evict first). No dot products: K-e's
// march.
struct NoDots {
  static constexpr bool kOut = false;
  static constexpr bool kStream = true;
  struct Slot {};
  template <int F>
  __device__ __forceinline__ void issue(Slot&, int, bool, const Cols&) {}
  template <int F>
  __device__ __forceinline__ void take(const Slot&, W, float2, int, bool,
                                       const Cols&, int) {}
};

// One unit: strip s of one lane (the source's rows, in the frames it
// compiles against a and b; out at the lane's first element, in frame kD
// against a and b: 1 for an odd lane of an odd g1 g2) down rows r0 .. r0 +
// rows - 1 of the extended grid, r0 even. Row r is taken in step r, whose
// loads (the source's and a's of row r + 1; b and the dots' operands, in
// out's layout, of row r) are issued kAhead steps ahead. A unit whose rows
// and columns are all nodes, and whose issues load only rows above the
// grid's last, takes a march with no masks (kIn); the others mask by row
// and column.
template <bool kOdd, bool kFlip, bool kD, int kAhead, class Src, class Dots>
__device__ __forceinline__ void march_rows(Src& src,
                                           const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ b,
                                           __nv_bfloat16* __restrict__ out,
                                           const Geo& g, int r0, int s,
                                           Dots& dots) {
  static_assert(kAhead % 2 == 0, "a trip of whole row pairs");
  constexpr int d = kOdd && kD ? 1 : 0;
  constexpr int fl = kFlip ? 1 : 0;
  const int lane = threadIdx.x & 31;
  const int c0 = kStrip * s;
  const int c = c0 + 2 * lane;
  const int g1 = g.g1, g2 = g.g2;
  const int on = g2 - 2 + 2 * g.pad;
  const int end = min(r0 + g.rows, g1 - 1 + g.pad);  // past the last row
  if (r0 >= end) return;  // warp-uniform

  const typename Src::Edges le = src.edges(b, g, r0, c0, lane);
  const SharedEdges se = shared_edges(a, b, g, r0, c0, lane);
  // each array at the lane's column c of its row 0: a row r's element c is
  // base + r*g2 (the source's, a, b) or base + r*on (out; its first row is
  // row 1 - pad)
  src.at(c);
  const __nv_bfloat16* ac = a + c;
  const __nv_bfloat16* bc = b + c;
  __nv_bfloat16* oc = out + (g.pad - 1) * on + (c - 1 + g.pad);

  // rows r0 - 1 and r0 into the fixed columns: the source's rows and the
  // north flux (a of row r0, frame 0: r0 is even; the source's row r0,
  // lane 1 holding its edges, and row r0 - 1, a and b in frame kOdd there)
  State st;
  {
    const Cols k = cols_of(c, g2, g.pad);
    const float2 av = X::unpack(word<0>(ac + r0 * g2, k, r0 == g1 - 1));
    st.wc = X::unpack(src.template row<0>(r0, g2, k, r0 == g1 - 1, le, 1,
                                          lane));
    st.fn = make_float2(0.f, 0.f);
    if (r0 >= 1) {
      constexpr int fm = kOdd ? 1 : 0;
      const float2 mv = X::unpack(
          src.template row<fm>(r0 - 1, g2, k, false, le, 0, lane));
      st.fn = make_float2(face_flux(av.x, st.wc.x, mv.x, g.h1),
                          face_flux(av.y, st.wc.y, mv.y, g.h1));
    }
  }

  // a step's loads: the source's and a of row r + 1, b of row r
  struct Slot {
    typename Src::Slot w;
    W a, b;
    typename Dots::Slot d;
  };

  const auto body = [&](auto inside) {
    constexpr bool kIn = decltype(inside)::value;
    const Cols k = kIn ? cols_inside(c) : cols_of(c, g2, g.pad);
    // the rows the next issue loads (the source and a one row down, b its
    // own row) and the next step stores, each at column c
    typename Src::Cur pw = src.cursor(r0 + 1, g2);
    const __nv_bfloat16* pa = ac + (r0 + 1) * g2;
    const __nv_bfloat16* pb = bc + r0 * g2;
    __nv_bfloat16* po = oc + r0 * on;
    // the loads of step r (parity P): a and b's frame in row r is Fr, in
    // row r + 1 Fd
    const auto issue = [&](int r, Slot& sl, auto P) {
      constexpr int Fr = kOdd ? decltype(P)::value : 0;
      constexpr int Fd = kOdd ? 1 - Fr : 0;
      const bool down = kIn || r + 1 <= g1 - 1;
      const bool last_down = !kIn && r + 1 == g1 - 1;
      src.template issue<Fd>(pw, sl.w, k, down, last_down, g2);
      sl.a = down ? word<Fd>(pa, k, last_down) : 0u;
      sl.b = word<Fr>(pb, k, !kIn && r == g1 - 1);
      src.step(pw, g2);
      pa += g2;
      pb += g2;
      dots.template issue<d ^ Fr ^ fl>(sl.d, r,
                                       kIn || (r >= 1 && r <= g1 - 2), k);
    };

    // step r (parity P): the stencil of row r in the fixed columns, out's
    // row r, the dots of row r
    const auto step = [&](int r, const Slot& sl, auto P) {
      constexpr int Fr = kOdd ? decltype(P)::value : 0;
      constexpr int Fd = kOdd ? 1 - Fr : 0;
      constexpr int Fo = d ^ Fr ^ fl;
      const int t = r - r0 + 1;  // the lane holding row r's edges
      const bool node_row = kIn || (r >= 1 && r <= g1 - 2);
      const float2 bb = X::unpack(fixed<Fr>(sl.b, se.b63, t, lane));
      const float2 as = X::unpack(fixed<Fd>(sl.a, se.a63, t + 1, lane));
      const float2 ws =
          X::unpack(src.template take<Fd>(sl.w, le, t + 1, lane));
      float w_w = __shfl_up_sync(kFull, st.wc.y, 1);
      const float e_w = __shfl_sync(kFull, le.ew, t);
      const float e_f = __shfl_sync(kFull, le.ef, t);
      if (lane == 0) w_w = e_w;
      const float2 f_s = make_float2(face_flux(as.x, ws.x, st.wc.x, g.h1),
                                     face_flux(as.y, ws.y, st.wc.y, g.h1));
      const float2 f_w = make_float2(face_flux(bb.x, st.wc.x, w_w, g.h2),
                                     face_flux(bb.y, st.wc.y, st.wc.x, g.h2));
      float f_e = __shfl_down_sync(kFull, f_w.x, 1);
      if (lane == 31) f_e = e_f;
      float vx = 0.f, vy = 0.f;
      if (node_row && k.nx) {
        vx = stencil_of_fluxes(f_s.x, st.fn.x, f_w.y, f_w.x, g.h1, g.h2);
      }
      if (node_row && k.ny) {
        vy = stencil_of_fluxes(f_s.y, st.fn.y, f_e, f_w.y, g.h1, g.h2);
      }
      W v = 0u;
      if (kIn || r >= 1 - g.pad) {
        if constexpr (Dots::kOut) {
          v = dots.template out<Fo>(sl.d, X::pack(vx, vy), t, lane);
          store<Fo, Dots::kStream>(po, v, k, lane);
        } else {
          store<Fo, Dots::kStream>(po, X::pack(vx, vy), k, lane);
        }
      }
      po += on;
      const float2 wr = st.wc;
      st.fn = f_s;
      st.wc = ws;
      dots.template take<Fo>(sl.d, v, wr, r, node_row, k, lane);
    };

    Slot ring[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; q += 2) {
      if (kIn || r0 + q < end) issue(r0 + q, ring[q], I<0>{});
      if (kIn || r0 + q + 1 < end) issue(r0 + q + 1, ring[q + 1], I<1>{});
    }
#pragma unroll 1
    for (int t = 0; t < g.rows; t += kAhead) {
#pragma unroll
      for (int q = 0; q < kAhead; q += 2) {
        const int r = r0 + t + q;
        if (!kIn && r >= end) return;  // warp-uniform
        {
          const Slot cur = ring[q];
          if (kIn || r + kAhead < end) issue(r + kAhead, ring[q], I<0>{});
          step(r, cur, I<0>{});
        }
        if (!kIn && r + 1 >= end) return;
        {
          const Slot cur = ring[q + 1];
          if (kIn || r + 1 + kAhead < end) {
            issue(r + 1 + kAhead, ring[q + 1], I<1>{});
          }
          step(r + 1, cur, I<1>{});
        }
      }
    }
  };
  // every row a node row and every row the issues load (kAhead past the
  // unit) above the grid's last row, every column a node column with the
  // strip's edges inside the grid
  if (r0 >= 1 && r0 + g.rows + kAhead <= g1 - 2 && c0 >= 1 &&
      c0 + 64 <= g2 - 2) {
    body(std::true_type{});
  } else {
    body(std::false_type{});
  }
}

// K-e and K-f's march: the source is w, in out's frame kD.
template <bool kOdd, bool kFlip, bool kD, int kAhead, class Dots>
__device__ __forceinline__ void march(const __nv_bfloat16* __restrict__ w,
                                      const __nv_bfloat16* __restrict__ a,
                                      const __nv_bfloat16* __restrict__ b,
                                      __nv_bfloat16* __restrict__ out,
                                      const Geo& g, int r0, int s,
                                      Dots& dots) {
  WRows<kOdd && kD ? 1 : 0> src{w};
  march_rows<kOdd, kFlip, kD, kAhead>(src, a, b, out, g, r0, s, dots);
}

}  // namespace lane_march
