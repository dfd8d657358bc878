// K1-shard and K2-shard: the fused PCG iteration on one rank of the mesh,
// for Hopper (sm_90a).
//
// Replaces: poisson_ellipse_tpu/parallel/fused_sharded.py build_shard_kernels,
// K1 (the pallas_call at :179, body _k1_kernel :92-144) and K2 (the
// pallas_call at :207, body ops/fused_pcg.py:_k2_kernel :152-193).
//
//   K1-shard  pn = z + beta*p on the halo-extended (bm+2, bn+2) window;
//             ap = A(pn), the apply_a_block tree (stencil_tree.cuh, K-a's),
//             0 where d == 0; the rank's sum(ap*pn) as per-block partials
//   K2-shard  alpha = zr/denom, 0 when denom is under the 1e-15 guard;
//             w += alpha*pn; r -= alpha*ap; z = r*dinv; the rank's
//             sum(z*r) and sum(dw^2), dw = w_new - w, as per-block partials
//
// Around them, on every rank (parallel/fused_sharded.py): the stacked (z, p)
// halo exchange before K1, the reduction of the denominator between the two,
// and after K2 the reduction of the pair and the scalar tail
// (ops/fused_pcg.py rotated_next_state). Unlike K-b and K-c, neither kernel
// finishes a sum or runs the tail: on the mesh the denominator and the
// convergence test wait for the other ranks. So each block writes its part
// of each sum, in double, and the launcher's caller adds them.
//
// zr, beta and the reduced denominator come from the device carry `scal`
// (layout of ops/fused_pcg.py), the loop's state from `flags`. Once the
// flags say the loop has exited, both kernels return without writing, so
// the extra bodies of the last chunk change nothing.
//
// The ring and the padding: the halos of z, p, a, b are the neighbours'
// exchanged edges, zeros where there is no neighbour; d is zero outside the
// global interior (ops/fused_pcg.py interior_normalized), so ap is exactly 0
// there and so are z and p. The TPU's (8, 128) tile padding of the rank's
// block and its aligned DMA windows have no counterpart here.
//
// What bounds them: bytes. On a rank's 1201x1601 block (2401x3201 over 2x2)
// one f32 pass is 7.69 MB. K1 reads z, p, a, b on the (bm+2, bn+2) window
// and d, and writes pn and ap (7 passes, 16.1 us at 3.35 TB/s); K2 reads w,
// r, pn, ap, dinv and writes w, r, z (8 passes, 18.4 us). Each node takes a
// few tens of flops.
//
// Design of the f32 forms: one node a thread, as K-a. K1 uses K-a's 32x8
// blocks over the owned block and recomputes pn at each of a node's four
// neighbours from z and p (the same two operations, so the same bits); K2
// is K-c's grid-stride pass. Each block adds its terms in double in a fixed
// order (warp shuffles, then warp 0 over the warp sums); no float atomics.
// Built with -fmad=false, so the arrays are bitwise the plain version's and
// the sums, added in another order, agree once rounded to f32.
//
// The bf16 forms (pe_fused_sharded_k1_bf16, pe_fused_sharded_k2_bf16)
// replace the same two pallas_calls at bf16 (:179 and :207 with bf16
// operands): every array and the scalar carry bf16, each load widened
// exactly, every value computed in float and rounded once to bf16 where it
// is stored (rn/down, storage.cuh): pn = rn(z + beta*p), ap = rn(A(pn))
// with the same tree on the bf16-rounded h1, h2, and w, r, z as K-c's bf16
// form computes them. The sums add products of two bf16 values (exact in
// float) in double, per block, as the f32 forms do. K2-shard bf16 is the
// f32 kernel templated on bf16. Bound: 7 passes at 2 B, 26.9 MB on a
// 1201x1601 block, 8.0 us; K2-shard bf16 8 passes, 30.8 MB, 9.2 us.
//
// K1-shard bf16 is the vector-lane march of csrc/lane_march.cuh
// (k1_march_kernel), on the (g1, g2) = (bm + 2, bn + 2) windows with pad 0,
// so d, pn and ap are the march's block-form out. The node-a-thread kernel
// (the f32 one templated on bf16) formed each pn five times and each flux
// twice, with 2-byte loads, and ran at 36-40% of its bound on an H100; a
// kernel of a lane's word per row on pn_march.cuh formed each pn at three
// rows and was slower still (34.6 us against 22.5 at 1201x1601; PERF.md,
// section 6). The march's source (lane_march::PnRows) loads the z and p
// words of a row, each in its own frame: the halo exchange stacks (z, p) as
// one tensor, so p starts mid-word where g1 g2 is odd. It moves each into
// the lane's fixed columns and forms pn there, once a node, and the
// stencil computes each flux once. The policy here (ShardDots) loads d in
// out's frame, moves it into the fixed columns, sets ap to +0 where d is
// 0, stores pn beside ap, and adds ap*pn in double down the lane's rows;
// then the warp and the block in a fixed order, a partial a block
// (pe_fused_sharded_k1_bf16_blocks). pn and ap are stored as plain words,
// not streamed past L2: K2-shard reads them next. Units are 16 rows at
// every block. a, b, d, pn and ap must start on a 4-byte word (the wrapper
// raises on others); z and p may start on any element. The frames of z and
// p against a and b are compiled (8 instantiations with kOdd: pad 0 fixes
// kFlip), chosen from the pointers, each built for three blocks an SM and,
// for launches of at most a wave of two, for two. Measured on an H100
// (PERF.md, section 6; tools/lane_sweep.py's k1 variants): 66.6-67.2 us at
// 2401x3201 and 21.8-21.9 at 1201x1601 against the node-a-thread kernel's
// 80.3 and 22.7-22.8; bounds, not bitwise: a product by the reciprocal in
// place of div_pos 60.7 / 17.9, pn = z alone 61.6 / 20.6, no pn store
// 61.1 / 20.4.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "lane_march.cuh"
#include "stencil_tree.cuh"
#include "storage.cuh"

namespace {

// ops/fused_pcg.py's carry layout
enum Scal { kZr = 0, kBeta = 1, kDiff = 2, kDenom = 3, kAlpha = 4 };
enum Flag { kK = 0, kConverged = 1, kBreakdown = 2 };

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kK2Threads = 256;
constexpr int kK2MaxBlocks = 1024;

__device__ __forceinline__ bool loop_active(const int* flags, int max_iter) {
  return flags[kConverged] == 0 && flags[kBreakdown] == 0 &&
         flags[kK] < max_iter;
}

// Sum over the block in a fixed order; thread 0 holds the result.
__device__ double block_sum(double v, double* s_warp) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x * blockDim.y + 31) / 32;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // s_warp may still be read by a previous call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (warp == 0) {
    s = lane < nwarps ? s_warp[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

// K1-shard's f32 form: a node a thread.
__global__ void __launch_bounds__(kBlockX * kBlockY)
k1_shard_kernel(const float* __restrict__ z, const float* __restrict__ p,
                const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ d, float* __restrict__ pn,
                float* __restrict__ ap, double* __restrict__ partials,
                const float* __restrict__ scal, const int* __restrict__ flags,
                int bm, int bn, int max_iter, float h1, float h2) {
  if (!loop_active(flags, max_iter)) return;
  __shared__ double s_warp[32];
  const float beta = scal[kBeta];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  double term = 0.0;
  if (i < bm && j < bn) {
    const int64_t ld = bn + 2;
    const int64_t c = (int64_t)(i + 1) * ld + (j + 1);
    const auto at = [&](int64_t o) { return z[o] + beta * p[o]; };
    const float wc = at(c);
    float v = stencil_tree(wc, at(c - ld), at(c + ld), at(c - 1), at(c + 1),
                           a[c], a[c + ld], b[c], b[c + 1], h1, h2);
    const int64_t o = (int64_t)i * bn + j;
    v = d[o] != 0.f ? v : 0.f;
    pn[o] = wc;
    ap[o] = v;
    term = static_cast<double>(v * wc);
  }
  const double s = block_sum(term, s_warp);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// -- K1-shard bf16: the vector-lane march (csrc/lane_march.cuh) ------------

namespace lm = lane_march;
using BF = __nv_bfloat16;

// Rows in flight behind a row, and the blocks an SM the compiler is told
// of: three where the launch takes more than a wave of two blocks on each
// of an H100's 132 SMs, two where it does not (the compiler then keeps 86
// registers, and one wave of fewer warps runs on a shorter step;
// tools/lane_sweep.py, PERF.md section 6).
constexpr int kShardAhead = 2;
constexpr int kShardMinBlocks = 3;
constexpr int kShardFewBlocks = 2;
constexpr int64_t kShardFewWave = 2 * 132;

// K1-shard's step besides the stencil: d's word of row r in out's frame F
// (the block arrays' layout: row r's element of column c at (r - 1) bn +
// c - 1), moved into the fixed columns (lane 31's second half from the
// strip's last column, which the edge lanes hold, d63); ap set to +0 where
// d is 0 (+0 or -0); pn's row stored beside ap; each node's ap*pn (two
// bf16 values, exact in float) widened to double and added into acc, low
// half then high, a half that is no node adding +0. The march issues and
// takes rows r0, r0 + 1, ... in order, so d and pn are read and written
// through row pointers that step a row a call.
struct ShardDots {
  static constexpr bool kOut = true;
  static constexpr bool kStream = false;
  struct Slot {
    lm::W d;
  };
  const BF* __restrict__ d;
  BF* __restrict__ pn;
  int g1, bn;
  lm::W d63;
  double acc;
  const BF* dr;  // d at the lane's column c of the next row issued
  BF* pr;        // pn at column c of the next row taken

  // lane k: d of row r0 - 1 + k in the strip's last column, c0 + 63; the
  // row pointers at row r0
  __device__ __forceinline__ void start(const lm::Geo& g, int r0, int c0,
                                        int lane) {
    const int i = r0 - 1 + lane;
    d63 = 0u;
    if (lane <= g.rows + 1 && i >= 1 && i <= g.g1 - 2 && c0 + 63 <= bn) {
      d63 = lm::raw(__ldg(d + (i - 1) * bn + c0 + 62));
    }
    const int at = (r0 - 1) * bn + c0 + 2 * lane - 1;
    dr = d + at;
    pr = pn + at;
  }

  // the word of row r holding column c in frame F; the word whose low
  // half is the last column of the block's last row (which ends past the
  // array where the block's last element starts a word) one element
  template <int F>
  __device__ __forceinline__ void issue(Slot& sl, int r, bool node_row,
                                        const lm::Cols& k) {
    const bool any = node_row && (F ? (k.nm || k.nx) : (k.nx || k.ny));
    const BF* at = dr - F;
    dr += bn;
    if (r == g1 - 2 && !(F ? k.nx : k.ny)) {
      sl.d = any ? lm::raw(__ldg(at)) : 0u;
    } else {
      sl.d = lm::X::load(at, any);
    }
  }

  // v with a half set to +0 where d's is +0 or -0: (h & 0x7fff) + 0x7fff
  // carries into a half's top bit exactly where h is neither, and prmt
  // replicates each half's top bit over it
  template <int F>
  __device__ __forceinline__ lm::W out(const Slot& sl, lm::W v, int t,
                                       int lane) {
    const lm::W dd = lm::fixed<F>(sl.d, d63, t, lane);
    const lm::W m = (dd & 0x7fff7fffu) + 0x7fff7fffu;
    lm::W keep;
    asm("prmt.b32 %0, %1, %1, 0xBB99;" : "=r"(keep) : "r"(m));
    return v & keep;
  }

  template <int F>
  __device__ __forceinline__ void take(const Slot&, lm::W v, float2 wr,
                                       int, bool node_row,
                                       const lm::Cols& k, int lane) {
    if (node_row) {
      lm::store<F, kStream>(pr, lm::X::pack(wr.x, wr.y), k, lane);
    }
    pr += bn;
    const float2 apv = lm::X::unpack(v);
    const bool lo = node_row && k.nx;
    const bool hi = node_row && k.ny;
    acc += (double)(lo ? apv.x * wr.x : 0.f);
    acc += (double)(hi ? apv.y * wr.y : 0.f);
  }
};

// K1-shard bf16: a warp a unit (a 64-column strip over ``rows`` rows of
// the windows), a block kWarps units, a partial a block. kOdd: g2 is odd
// (out in a and b's frame; at an even width in the other); DZ, DP: z's and
// p's frames against a and b; kBlocks: the blocks an SM it is built for.
template <bool kOdd, int DZ, int DP, int kBlocks>
__global__ void __launch_bounds__(lm::kThreads, kBlocks)
k1_march_kernel(const BF* __restrict__ z, const BF* __restrict__ p,
                const BF* __restrict__ a, const BF* __restrict__ b,
                const BF* __restrict__ d, BF* __restrict__ pn,
                BF* __restrict__ ap, double* __restrict__ partials,
                const BF* __restrict__ scal, const int* __restrict__ flags,
                int max_iter, lm::Geo g) {
  if (!loop_active(flags, max_iter)) return;
  __shared__ double s_warp[32];
  ShardDots dots{d, pn, g.g1, g.g2 - 2, 0u, 0.0, nullptr, nullptr};
  const int nstrips = lm::strips(g.g2);
  const int unit = blockIdx.x * lm::kWarps + (threadIdx.x >> 5);
  if (unit < nstrips * lm::tiles(g.g1, 0, g.rows)) {
    const int tile = unit / nstrips;  // warp-uniform
    const int s = unit - tile * nstrips;
    dots.start(g, tile * g.rows, lm::kStrip * s, threadIdx.x & 31);
    lm::PnRows<DZ, DP> src{z, p, up(scal[kBeta])};
    lm::march_rows<kOdd, !kOdd, false, kShardAhead>(src, a, b, ap, g,
                                                    tile * g.rows, s, dots);
  }
  const double sum = block_sum(dots.acc, s_warp);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// K2-shard in the run type T: float, or bf16 (K-c's bf16 form's body).
template <typename T>
__global__ void __launch_bounds__(kK2Threads)
k2_shard_kernel(T* __restrict__ w, T* __restrict__ r,
                const T* __restrict__ pn, const T* __restrict__ ap,
                const T* __restrict__ dinv, T* __restrict__ z,
                double* __restrict__ partials, const T* __restrict__ scal,
                const int* __restrict__ flags, int64_t n, int max_iter) {
  if (!loop_active(flags, max_iter)) return;
  __shared__ double s_warp[32];
  const auto R = [](float x) { return rn<T>(x); };
  const float denom = up(scal[kDenom]);
  // DENOM_GUARD rounded to T, as the comparison in T rounds it
  const bool bd = denom < rn<T>(1e-15f);
  float alpha = R(up(scal[kZr]) / (bd ? 1.f : denom));
  alpha = bd ? 0.f : alpha;
  double s_zr = 0.0;
  double s_dw = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n;
       o += stride) {
    const float wo = up(w[o]);
    const float wn = R(wo + alpha * up(pn[o]));
    const float rn_ = R(up(r[o]) - alpha * up(ap[o]));
    const float zz = R(rn_ * up(dinv[o]));
    // the realised increment, not alpha*pn: the oracle counts depend on it
    const float dw = wn - wo;
    w[o] = down<T>(wn);
    r[o] = down<T>(rn_);
    z[o] = down<T>(zz);
    s_zr += static_cast<double>(zz * rn_);
    s_dw += static_cast<double>(dw * dw);
  }
  const double b_zr = block_sum(s_zr, s_warp);
  const double b_dw = block_sum(s_dw, s_warp);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = b_zr;
    partials[2 * blockIdx.x + 1] = b_dw;
  }
}

dim3 k1_grid(int bm, int bn) {
  return dim3((bn + kBlockX - 1) / kBlockX, (bm + kBlockY - 1) / kBlockY);
}

int k2_blocks(int64_t n) {
  const int64_t want = (n + kK2Threads - 1) / kK2Threads;
  return static_cast<int>(want < kK2MaxBlocks ? want : kK2MaxBlocks);
}

int launch_k1(const float* z, const float* p, const float* a, const float* b,
              const float* d, float* pn, float* ap, double* partials,
              const float* scal, const int* flags, int bm, int bn,
              int max_iter, float h1, float h2, void* stream) {
  if (bm < 1 || bn < 1) return static_cast<int>(cudaErrorInvalidValue);
  k1_shard_kernel<<<k1_grid(bm, bn), dim3(kBlockX, kBlockY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      z, p, a, b, d, pn, ap, partials, scal, flags, bm, bn, max_iter, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

// K1-shard bf16's rows a unit and blocks at a (bm, bn) block: 16 rows a
// unit whatever the block. A unit's start (its edges and first rows) is a
// chain of loads, so at a rank's 1201x1601 one wave of 16-row units ran
// faster than 2.5 waves of the 4-row units K-e's rule gives (lane_march
// rows_of; tools/lane_sweep.py).
int k1_march_rows(int, int) { return lm::kMaxRows; }
int64_t k1_march_blocks(int bm, int bn) {
  return lm::lane_blocks(bm + 2, bn + 2, 0, k1_march_rows(bm, bn));
}

// A bf16 array's frame: 1 where it starts mid-word.
int frame_of(const BF* x) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 1) & 1);
}

// K1-shard bf16's launch. The march indexes a window in 32 bits, with room
// for the rows a unit's issues reach past the last, and loads words: a
// larger block, or a, b, d, pn or ap off a 4-byte boundary, is refused
// with cudaErrorInvalidValue.
int launch_k1_march(const BF* z, const BF* p, const BF* a, const BF* b,
                    const BF* d, BF* pn, BF* ap, double* partials,
                    const BF* scal, const int* flags, int bm, int bn,
                    int max_iter, float h1, float h2, void* stream) {
  if (bm < 1 || bn < 1 ||
      (int64_t)(bm + 4 + kShardAhead) * (bn + 2) >= (int64_t{1} << 31) ||
      !lm::aligned4(a) || !lm::aligned4(b) || !lm::aligned4(d) ||
      !lm::aligned4(pn) || !lm::aligned4(ap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const lm::Geo geo{bm + 2, bn + 2, 0, k1_march_rows(bm, bn), h1, h2};
  const dim3 grid(static_cast<unsigned>(k1_march_blocks(bm, bn)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool few = grid.x <= kShardFewWave;
  const auto go = [&](auto odd, auto dz, auto dp) {
    constexpr bool o = decltype(odd)::value;
    constexpr int fz = decltype(dz)::value, fp = decltype(dp)::value;
    if (few) {
      k1_march_kernel<o, fz, fp, kShardFewBlocks>
          <<<grid, lm::kThreads, 0, st>>>(z, p, a, b, d, pn, ap, partials,
                                          scal, flags, max_iter, geo);
    } else {
      k1_march_kernel<o, fz, fp, kShardMinBlocks>
          <<<grid, lm::kThreads, 0, st>>>(z, p, a, b, d, pn, ap, partials,
                                          scal, flags, max_iter, geo);
    }
  };
  const auto frames = [&](auto odd) {
    const int fz = frame_of(z), fp = frame_of(p);
    if (fz && fp) {
      go(odd, lm::I<1>{}, lm::I<1>{});
    } else if (fz) {
      go(odd, lm::I<1>{}, lm::I<0>{});
    } else if (fp) {
      go(odd, lm::I<0>{}, lm::I<1>{});
    } else {
      go(odd, lm::I<0>{}, lm::I<0>{});
    }
  };
  if (geo.g2 & 1) {
    frames(std::true_type{});
  } else {
    frames(std::false_type{});
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k2(T* w, T* r, const T* pn, const T* ap, const T* dinv, T* z,
              double* partials, const T* scal, const int* flags, int bm,
              int bn, int max_iter, void* stream) {
  if (bm < 1 || bn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = (int64_t)bm * bn;
  k2_shard_kernel<T><<<k2_blocks(n), kK2Threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      w, r, pn, ap, dinv, z, partials, scal, flags, n, max_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks each kernel launches for one (bm, bn) block: K1 writes one
// partial a block, K2 two. K1's f32 form, its bf16 form (the march), and
// K2 in either form.
int pe_fused_sharded_k1_blocks(int bm, int bn) {
  const dim3 g = k1_grid(bm, bn);
  return static_cast<int>(g.x * g.y);
}

int pe_fused_sharded_k1_bf16_blocks(int bm, int bn) {
  return static_cast<int>(k1_march_blocks(bm, bn));
}

int pe_fused_sharded_k2_blocks(int bm, int bn) {
  return k2_blocks((int64_t)bm * bn);
}

// z, p, a, b: (bm+2, bn+2); d, pn, ap: (bm, bn); partials: k1_blocks
// doubles; h1, h2 rounded to f32.
int pe_fused_sharded_k1_f32(const float* z, const float* p, const float* a,
                            const float* b, const float* d, float* pn,
                            float* ap, double* partials, const float* scal,
                            const int* flags, int bm, int bn, int max_iter,
                            float h1, float h2, void* stream) {
  return launch_k1(z, p, a, b, d, pn, ap, partials, scal, flags, bm, bn,
                   max_iter, h1, h2, stream);
}

// The bf16 form: every array and scal bf16; a, b, d, pn and ap 4-byte
// aligned; partials: k1_bf16_blocks doubles; h1, h2 rounded to bf16.
int pe_fused_sharded_k1_bf16(const __nv_bfloat16* z, const __nv_bfloat16* p,
                             const __nv_bfloat16* a, const __nv_bfloat16* b,
                             const __nv_bfloat16* d, __nv_bfloat16* pn,
                             __nv_bfloat16* ap, double* partials,
                             const __nv_bfloat16* scal, const int* flags,
                             int bm, int bn, int max_iter, float h1, float h2,
                             void* stream) {
  return launch_k1_march(z, p, a, b, d, pn, ap, partials, scal, flags, bm, bn,
                         max_iter, h1, h2, stream);
}

// w, r, pn, ap, dinv, z: (bm, bn); w, r updated in place; partials:
// 2 * k2_blocks doubles.
int pe_fused_sharded_k2_f32(float* w, float* r, const float* pn,
                            const float* ap, const float* dinv, float* z,
                            double* partials, const float* scal,
                            const int* flags, int bm, int bn, int max_iter,
                            void* stream) {
  return launch_k2(w, r, pn, ap, dinv, z, partials, scal, flags, bm, bn,
                   max_iter, stream);
}

// The bf16 form: every array and scal bf16.
int pe_fused_sharded_k2_bf16(__nv_bfloat16* w, __nv_bfloat16* r,
                             const __nv_bfloat16* pn,
                             const __nv_bfloat16* ap,
                             const __nv_bfloat16* dinv, __nv_bfloat16* z,
                             double* partials, const __nv_bfloat16* scal,
                             const int* flags, int bm, int bn, int max_iter,
                             void* stream) {
  return launch_k2(w, r, pn, ap, dinv, z, partials, scal, flags, bm, bn,
                   max_iter, stream);
}

const char* pe_fused_sharded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
