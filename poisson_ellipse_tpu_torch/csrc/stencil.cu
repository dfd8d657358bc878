// The plain-stencil family for Hopper (sm_90a): K-a, its bf16 form, K-e
// and K-g, four forms of one kernel, march_kernel below; and K-e's bf16
// form, the vector-lane march of csrc/lane_march.cuh (lane_stencil_kernel).
//
// K-a: the 5-point variable-coefficient stencil A·w. For every owned node
// of a halo-extended (bm+2, bn+2) block,
//   ax = -(a[i+1,j]*(w[i+1,j]-w[i,j])/h1 - a[i,j]*(w[i,j]-w[i-1,j])/h1)/h1
//   ay = -(b[i,j+1]*(w[i,j+1]-w[i,j])/h2 - b[i,j]*(w[i,j]-w[i,j-1])/h2)/h2
//   out = ax + ay
// term for term in the reference's order (each difference divided by h
// before the terms are combined): stencil_tree.cuh, which the K-d family
// (stencil_dots.cu) and K1-shard (fused_sharded.cu) share. Built with
// -fmad=false, so no product is contracted into an FMA and the result is
// bitwise the plain PyTorch version's on the same card.
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py:_stencil_kernel
// (launched by apply_a_block_pallas / apply_a_pallas), the TPU form of the
// reference's stage-4 apply_A_kernel (poisson_mpi_cuda2.cu:507-536): the
// stencil of the pallas loop, of pipelined-pallas's w0 and rebuilds and of
// sstep-pallas's basis chain.
//
// What bounds it: bytes. Per node it reads w, a, b once and writes one
// value (4 array passes); at 2401x3201 f32 that is 123 MB, 36.7 us at
// 3.35 TB/s. The arithmetic (4 divisions, 12 other flops) is far below the
// card's rate.
//
// Layouts: with pad == 0 the output is the (bm, bn) block; with pad == 1
// it is the full (bm+2, bn+2) grid with a zero ring (apply_a_pallas's
// jnp.pad), written by the kernel itself so no second pass is needed.
//
// The bf16 form of K-a: w, a, b and out in bf16. Each load is widened
// exactly, the tree is computed in float, and the result is rounded once
// to bf16 where it is stored (rn/down in storage.cuh, the rule of the bf16
// whole-solve forms, ops/whole_solve.py:rounder). h1 and h2 are the
// bf16-rounded spacings, widened, as the bf16 loops use them. Replaces the
// same _stencil_kernel at bf16 (apply_a_block_pallas's call at
// pallas_kernels.py:169 with bf16 operands). Bound: 4 passes at 2 B,
// 61.5 MB at 2401x3201, 18.4 us.
//
// K-e, the lane-batched form: A·w for B lanes of w with lane-shared a and
// b, the lane on gridDim.z. Block (x, y, l) does for lane l exactly what
// block (x, y) does in a one-lane launch, so lane l of the output is K-a
// on lane l by construction. Each lane's base is offset in 64 bits; the
// march within a lane indexes in 32. Replaces: pallas_kernels.py:
// _batched_stencil_kernel (launched by apply_a_batched_block_pallas /
// apply_a_batched_pallas), the batched engines' stencil
// (poisson_ellipse_tpu/batch/batched_pcg.py:280-296). Bound: a and b once
// and each lane's w and out once, (2 + 2B) passes of one lane's grid; at
// 401x601 f32 with B = 32, 66 passes of 0.964 MB, 19.0 us. The
// coefficients are re-read for every lane, from L2 after the first (1.9
// MB at 401x601, 7.7 MB at 801x1201).
//
// K-e's bf16 form: K-e with w, a, b and out in bf16, each node computed as
// K-a's bf16 form computes it, so lane l is bitwise K-a bf16 on lane l.
// Replaces _batched_stencil_kernel at bf16 (apply_a_batched_block_pallas's
// call at pallas_kernels.py:409 with bf16 operands): the bf16
// batched-pallas engine's stencil, and the w0 and rebuilds of bf16
// batched-pipelined-pallas. Bound: (2 + 2B) passes at 2 B; at 401x601
// with B = 32, 31.8 MB, 9.5 us. Its kernel is the vector-lane march of
// csrc/lane_march.cuh (lane_stencil_kernel below), not march_kernel: with a
// lane a column and 2-byte loads the march took as many instructions a node
// as in f32 and ran at 18-19% of its bound. A lane owns two columns, one
// aligned 4-byte word of each array, a warp a 64-column strip: 42.6 us
// against that form's 51.3 on the H100 (PERF.md, section 6), still paced
// by the instructions of the tree's eight divisions a row step.

// K-g, the mixed-precision form: w in the storage type (bf16 or f16) or
// f32, a and b in the storage type, out f32. Each load is upcast exactly
// (__bfloat162float / __half2float), so a narrow input gives bit for bit
// what K-a gives on the upcast input. Replaces: pallas_kernels.py:
// _stencil_kernel_mixed (launched by apply_a_block_mixed_pallas /
// apply_a_mixed_pallas), the storage axis's stencil of the pallas loop,
// of pipelined-pallas's rebuilds and of sstep-pallas's basis chain.
// Bound: 10 B a node with w narrow, 12 B with w f32; at 2401x3201 76.9 MB
// (22.9 us) and 92.2 MB (27.5 us).
//
// Design (the march, K-d's without the dots): a lane owns a column, a warp
// marches kRows rows down it, and a block's warps march side by side.
// Each face flux is computed once (stencil_tree.cuh): w and a's row below
// and b's own row are loaded once, the north flux is carried down, the
// west flux comes from w one lane west (a shuffle), the east flux is the
// next lane's west flux; the values the edge lanes lack are formed once a
// tile, lane k for row k. kAhead rows of loads are in flight in registers.
// Tiles of nodes only take a march with no masks. 4 divisions and 3 loads
// a node where the first K-a's one thread a node took 6 and 9, each
// division through div_pos, so the zero fluxes of the solver's state
// outside the ellipse skip IEEE division's slow path: on the H100, K-a ran
// 105 us on w = 0 and 101 us a launch in the pallas loop against 65 on
// seeded values (PERF.md, sections 6-7). Rows in flight through shared
// memory (a cp.async ring of 4-byte copies, or of each warp's 16-byte
// aligned row segments read at the row's alignment shift) ran slower
// (PERF.md, section 6). The shape a form takes (warps a block, rows ahead,
// blocks an SM) depends on its types alone, and the result on the grid's
// shape alone.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "lane_march.cuh"
#include "stencil_tree.cuh"
#include "storage.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The march's shape a form: warps side by side in a block, rows a warp
// marches (at most 32: the edge values are held one row a lane), rows of
// loads in flight behind a row, blocks an SM (with the warps, the
// registers a thread may take: 65536 / (32 warps blocks)). Narrow loads
// (K-g, K-a's bf16 form): 4 warps of 16 rows, 2 rows ahead, 8 blocks.
template <typename TW, typename TC, typename TO>
struct Shape {
  static constexpr int kWarps = 4;
  static constexpr int kRows = 16;
  static constexpr int kAhead = 2;
  static constexpr int kMinBlocks = 8;
};
// K-a f32 and K-e, 16 bytes a node: 6 rows in flight at 4 blocks an SM
// (128 registers), and tiles of 8 rows, so a tile that meets the slow
// path of a division holds up fewer rows.
template <>
struct Shape<float, float, float> {
  static constexpr int kWarps = 4;
  static constexpr int kRows = 8;
  static constexpr int kAhead = 6;
  static constexpr int kMinBlocks = 4;
};

// out, written once: a streaming store.
__device__ __forceinline__ void st_once(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;" ::"l"(p), "f"(v));
}
__device__ __forceinline__ void st_once(__nv_bfloat16* p, __nv_bfloat16 v) {
  asm volatile("st.global.cs.b16 [%0], %1;" ::"l"(p),
               "h"(__bfloat16_as_ushort(v)));
}

// TW: the type of w; TC: the type of a and b; TO: the type of out.
// kLanes: the lane is blockIdx.z (K-e); a one-lane form keeps its
// pointers as passed.
template <typename TW, typename TC, typename TO, bool kLanes>
__global__ void __launch_bounds__(32 * Shape<TW, TC, TO>::kWarps,
                                  Shape<TW, TC, TO>::kMinBlocks)
march_kernel(const TW* __restrict__ w, const TC* __restrict__ a,
             const TC* __restrict__ b, TO* __restrict__ out, int bm, int bn,
             int pad, float h1, float h2) {
  using S = Shape<TW, TC, TO>;
  constexpr int kRows = S::kRows;
  static_assert(kRows <= 32, "the edge values are held one row a lane");
  const int lane = threadIdx.x;
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  const int ld = bn + 2;
  if (kLanes) {
    // this block's lane: its slice of w and out
    w += blockIdx.z * (int64_t)(bm + 2) * ld;
    out += blockIdx.z * (int64_t)om * on;
  }
  // this lane's output column oj and extended column c; lane 0's column
  const int oj = (blockIdx.x * S::kWarps + threadIdx.y) * 32 + lane;
  const int c = oj + 1 - pad;
  const int c0 = c - lane;
  // w, a and b exist at column c; c holds a node; out has column oj
  const bool col_in = c <= bn + 1;
  const bool col_node = c >= 1 && c <= bn;
  const bool col_out = oj < on;
  // the warp's first output row and its extended row
  const int oi0 = blockIdx.y * kRows;
  const int r0 = oi0 + 1 - pad;
  if (oi0 >= om || oj - lane >= on) return;  // warp-uniform
  // lane k holds row r0 + k's edge values: w one column west of lane 0
  // and the west flux one column east of lane 31 (the east flux of lane
  // 31's node)
  float edge_w = 0.f, edge_f = 0.f;
  {
    const int r = r0 + lane;
    const int ce = c0 + 32;
    if (lane < kRows && r <= bm + 1) {
      const int row = r * ld;
      if (c0 >= 1) edge_w = up(__ldg(w + row + c0 - 1));
      if (ce <= bn + 1) {
        edge_f = face_flux(up(__ldg(b + row + ce)), up(__ldg(w + row + ce)),
                           up(__ldg(w + row + ce - 1)), h2);
      }
    }
  }
  // row r0's w and its north flux (the south flux of row r0 - 1)
  int rc = r0 * ld + c;
  float wc = 0.f, f_n = 0.f;
  if (col_in) {
    wc = up(__ldg(w + rc));
    if (r0 >= 1) {
      f_n = face_flux(up(__ldg(a + rc)), wc, up(__ldg(w + rc - ld)), h1);
    }
  }
  // the row a step loads: w and a one row down, b its own row
  struct Row {
    float w_s, a_s, b_c;
  };
  auto march = [&](auto interior) {
    constexpr bool kIn = decltype(interior)::value;
    auto load = [&](int r, int at, Row& row) {
      const bool in = kIn || (col_in && r <= bm + 1);
      const bool down_in = kIn || (col_in && r + 1 <= bm + 1);
      row.w_s = down_in ? up(__ldg(w + at + ld)) : 0.f;
      row.a_s = down_in ? up(__ldg(a + at + ld)) : 0.f;
      row.b_c = in ? up(__ldg(b + at)) : 0.f;
    };
    Row ring[S::kAhead];
#pragma unroll
    for (int k = 0; k < S::kAhead; ++k) {
      ring[k] = Row{};
      if (kIn || oi0 + k < om) load(r0 + k, rc + k * ld, ring[k]);
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int oi = oi0 + t;
      if (!kIn && oi >= om) break;
      const int r = r0 + t;
      const Row cur = ring[t % S::kAhead];
      if (t + S::kAhead < kRows && (kIn || oi + S::kAhead < om)) {
        load(r + S::kAhead, rc + S::kAhead * ld, ring[t % S::kAhead]);
      }
      const float f_s = face_flux(cur.a_s, cur.w_s, wc, h1);
      float w_w = __shfl_up_sync(kFull, wc, 1);
      const float e_w = __shfl_sync(kFull, edge_w, t);
      if (lane == 0) w_w = e_w;
      const float f_w = face_flux(cur.b_c, wc, w_w, h2);
      float f_e = __shfl_down_sync(kFull, f_w, 1);
      const float e_f = __shfl_sync(kFull, edge_f, t);
      if (lane == 31) f_e = e_f;
      float val = 0.f;
      if (kIn || (col_node && r >= 1 && r <= bm)) {
        val = stencil_of_fluxes(f_s, f_n, f_e, f_w, h1, h2);
      }
      if (kIn || col_out) st_once(out + oi * on + oj, down<TO>(val));
      f_n = f_s;
      wc = cur.w_s;
      rc += ld;
    }
  };
  if (c0 >= 1 && c0 + 31 <= bn && r0 >= 1 && r0 + kRows - 1 <= bm) {
    march(std::true_type{});
  } else {
    march(std::false_type{});
  }
}

// Every form's launch. The march indexes a lane's grid in 32 bits (with
// room for the rows a tile reads past its last): a larger grid, a lane
// count gridDim.z cannot hold, or more row tiles than gridDim.y can, is
// refused with cudaErrorInvalidValue.
template <bool kLanes, typename TW, typename TC, typename TO>
int launch_march(const TW* w, const TC* a, const TC* b, TO* out, int lanes,
                 int bm, int bn, int pad, float h1, float h2, void* stream) {
  using S = Shape<TW, TC, TO>;
  const int on = bn + 2 * pad;
  const int om = bm + 2 * pad;
  const int span = 32 * S::kWarps;
  const int64_t tiles = (om + S::kRows - 1) / S::kRows;
  if ((int64_t)(bm + 2 + 2 * S::kRows) * (bn + 2) >= (int64_t{1} << 31) ||
      lanes < 1 || lanes > 65535 || tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((on + span - 1) / span, static_cast<unsigned>(tiles), lanes);
  march_kernel<TW, TC, TO, kLanes><<<grid, dim3(32, S::kWarps), 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      w, a, b, out, bm, bn, pad, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

// K-e bf16's march (csrc/lane_march.cuh): a warp a unit (a 64-column
// strip over ``rows`` rows), a block kWarps units of one lane (blockIdx.z,
// even lanes first). kOdd: g2 is odd; kD1: odd lanes are in the other
// frame from a and b (an odd g1 g2); kFlip: out is in the other frame from
// w (pad 0 at an even width). Rows in flight behind a row, and blocks an
// SM (lane_march's registers stay under their 85): two rows ahead fill the
// long row step; four ran slower, as did two lanes a thread, with a and b
// loaded once for both (PERF.md, section 6).
constexpr int kLaneAhead = 2;
constexpr int kLaneMinBlocks = 3;

namespace lm = lane_march;

template <bool kOdd, bool kFlip, bool kD1>
__global__ void __launch_bounds__(lm::kThreads, kLaneMinBlocks)
lane_stencil_kernel(const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    __nv_bfloat16* __restrict__ out, int lanes, lm::Geo g) {
  const int l = lm::lane_of(blockIdx.z, lanes);
  const int nstrips = lm::strips(g.g2);
  const int unit = blockIdx.x * lm::kWarps + (threadIdx.x >> 5);
  if (unit >= nstrips * lm::tiles(g.g1, g.pad, g.rows)) return;
  const int tile = unit / nstrips;  // warp-uniform
  const int s = unit - tile * nstrips;
  w += l * (int64_t)(g.g1 * g.g2);
  out += l * (int64_t)((g.g1 - 2 + 2 * g.pad) * (g.g2 - 2 + 2 * g.pad));
  lm::NoDots none;
  if (kD1 && (l & 1)) {
    lm::march<kOdd, kFlip, true, kLaneAhead>(w, a, b, out, g, tile * g.rows,
                                             s, none);
  } else {
    lm::march<kOdd, kFlip, false, kLaneAhead>(w, a, b, out, g,
                                              tile * g.rows, s, none);
  }
}

// K-e bf16's launch. The march indexes a lane's grid in 32 bits and loads
// words: a larger grid, an array off a 4-byte boundary or more lanes than
// gridDim.z holds is refused with cudaErrorInvalidValue.
int launch_lanes(const __nv_bfloat16* w, const __nv_bfloat16* a,
                 const __nv_bfloat16* b, __nv_bfloat16* out, int lanes,
                 int bm, int bn, int pad, float h1, float h2, void* stream) {
  const int g1 = bm + 2, g2 = bn + 2;
  if (lanes < 1 || lanes > 65535 || bm < 1 || bn < 1 ||
      (pad != 0 && pad != 1) ||
      (int64_t)(g1 + 2) * g2 >= (int64_t{1} << 31) || !lm::aligned4(w) ||
      !lm::aligned4(a) || !lm::aligned4(b) || !lm::aligned4(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lm::Geo geo{g1, g2, pad, lm::rows_of(g1, g2, pad, lanes), h1, h2};
  const dim3 grid(
      static_cast<unsigned>(lm::lane_blocks(g1, g2, pad, geo.rows)), 1,
      lanes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool odd = g2 & 1;
  if (odd && (g1 & 1)) {
    lane_stencil_kernel<true, false, true>
        <<<grid, lm::kThreads, 0, st>>>(w, a, b, out, lanes, geo);
  } else if (odd) {
    lane_stencil_kernel<true, false, false>
        <<<grid, lm::kThreads, 0, st>>>(w, a, b, out, lanes, geo);
  } else if (pad == 0) {
    lane_stencil_kernel<false, true, false>
        <<<grid, lm::kThreads, 0, st>>>(w, a, b, out, lanes, geo);
  } else {
    lane_stencil_kernel<false, false, false>
        <<<grid, lm::kThreads, 0, st>>>(w, a, b, out, lanes, geo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K-a: w, a, b (bm+2, bn+2) and out (bm+2*pad, bn+2*pad) f32.
int pe_stencil_f32(const float* w, const float* a, const float* b, float* out,
                   int bm, int bn, int pad, float h1, float h2, void* stream) {
  return launch_march<false>(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

// K-e: w (lanes, bm+2, bn+2), a and b (bm+2, bn+2) shared by every lane,
// out (lanes, bm+2*pad, bn+2*pad).
int pe_batched_stencil_f32(const float* w, const float* a, const float* b,
                           float* out, int lanes, int bm, int bn, int pad,
                           float h1, float h2, void* stream) {
  return launch_march<true>(w, a, b, out, lanes, bm, bn, pad, h1, h2,
                            stream);
}

// K-e's bf16 form: as pe_batched_stencil_f32 with every array bf16 and
// 4-byte aligned; h1, h2 the bf16-rounded spacings.
int pe_batched_stencil_bf16(const __nv_bfloat16* w, const __nv_bfloat16* a,
                            const __nv_bfloat16* b, __nv_bfloat16* out,
                            int lanes, int bm, int bn, int pad, float h1,
                            float h2, void* stream) {
  return launch_lanes(w, a, b, out, lanes, bm, bn, pad, h1, h2, stream);
}

// K-g: w (bm+2, bn+2) in the storage type or f32, a and b (bm+2, bn+2) in
// the storage type, out (bm+2*pad, bn+2*pad) f32.
int pe_stencil_mixed_bf16_bf16(const __nv_bfloat16* w,
                               const __nv_bfloat16* a,
                               const __nv_bfloat16* b, float* out, int bm,
                               int bn, int pad, float h1, float h2,
                               void* stream) {
  return launch_march<false>(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

int pe_stencil_mixed_f32_bf16(const float* w, const __nv_bfloat16* a,
                              const __nv_bfloat16* b, float* out, int bm,
                              int bn, int pad, float h1, float h2,
                              void* stream) {
  return launch_march<false>(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

int pe_stencil_mixed_f16_f16(const __half* w, const __half* a,
                             const __half* b, float* out, int bm, int bn,
                             int pad, float h1, float h2, void* stream) {
  return launch_march<false>(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

int pe_stencil_mixed_f32_f16(const float* w, const __half* a,
                             const __half* b, float* out, int bm, int bn,
                             int pad, float h1, float h2, void* stream) {
  return launch_march<false>(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

// The bf16 form of K-a: w, a, b (bm+2, bn+2) and out (bm+2*pad, bn+2*pad)
// bf16; h1, h2 the bf16-rounded spacings.
int pe_stencil_bf16(const __nv_bfloat16* w, const __nv_bfloat16* a,
                    const __nv_bfloat16* b, __nv_bfloat16* out, int bm,
                    int bn, int pad, float h1, float h2, void* stream) {
  return launch_march<false>(w, a, b, out, 1, bm, bn, pad, h1, h2, stream);
}

const char* pe_stencil_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
