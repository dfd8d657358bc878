// The reference's stage-4 vector kernels for Hopper (sm_90a): z = r/D, the
// weighted dot product, the fused w/r update with its step norm, and the
// direction update.
//
// Replaces: poisson_ellipse_tpu/ops/pallas_kernels.py
//   _dinv_kernel      (apply_dinv_pallas, pallas_call at :570)
//   _dot_kernel       (dot_pallas, :610)
//   _update_wr_kernel (update_w_r_pallas, :662)
//   _update_p_kernel  (update_p_pallas, :699)
// the TPU forms of the reference's apply_Dinv_kernel, dot_kernel,
// update_w_r_kernel and update_p_kernel (poisson_mpi_cuda2.cu:541-676).
//
// Computes, over every node of a (g1, g2) grid, in T (float or double):
//   dinv:       z = d != 0 ? r / d : 0
//   dot:        out = (T)(sum x*y) * h1 * h2
//   update_w_r: w_new = w + alpha*p;  r_new = r - alpha*ap;
//               dw2 = (T)(sum (w_new - w)^2)   (unweighted)
//   update_p:   p_new = z + beta*p
// alpha and beta are 0-d device tensors read through a pointer, as the TPU
// kernels read them from SMEM: the host never reads them back. Built with
// -fmad=false, so a*b + c is a rounded product and then a rounded sum, and
// every array is bitwise the plain PyTorch version's (the same two
// operations, each rounded once).
//
// What bounds them: bytes. Per node dinv reads r, d and writes z (3
// passes), dot reads x, y (2), update_w_r reads w, r, p, ap and writes
// w_new, r_new (6), update_p reads z, p and writes p_new (3); one f32 pass
// at 2401x3201 is 30.74 MB, 9.18 us at 3.35 TB/s, so 27.5, 18.4, 55.1 and
// 27.5 us. The arithmetic (1-4 flops a node) is far below the card's rate.
// Each operand (61.5 MB for dot, 92.2 MB for update_p at f32) outsizes
// the 50 MB L2 and is read once: the time is HBM's, given enough bytes in
// flight (about 2-3 MB across the card) to cover its latency.
//
// Design:
// - dinv and update_w_r take one node a thread, 256 threads a block, over
//   the flat array: the four TPU kernels tile rows only to fit VMEM, and
//   the row padding they need (a multiple of 8) has no counterpart.
// - dot and update_p stream: 16-byte vector loads (float4 / double2)
//   through the read-only path, no L1 allocation, a 256-byte L2 prefetch
//   and an L2 evict-first policy (each byte is read once). update_p takes
//   one vector of each operand a thread, a block for each 256 vectors,
//   and stores streaming (__stcs); beta is read once a thread. dot keeps
//   kUnroll vectors of each operand in flight a thread before any is
//   used, over a persistent grid of as many blocks as the card holds at
//   once (SMs x occupancy, asked once a device), each thread striding
//   over vectors tid, tid + T, ... so every thread has the same count to
//   within one, and multiplies and adds an f32 product in one DFMA
//   (dot_into). An array's head up to the first 16-byte boundary and its
//   tail after the last whole vector go through scalar loads in the same
//   launch (Span); where the operands differ in their alignment mod 16 (a
//   view offset by one element beside an aligned array) the whole array
//   goes through the scalar loop. Measured on the H100 (PERF.md, section
//   6): for update_p the one-vector grid beat the persistent one by
//   1.5% (f32) and 2.4% (f64); a ring of 1-D bulk copies (TMA) into shared
//   memory, plain loads and stores, block-contiguous ranges and two or
//   eight vectors in flight were slower for both.
// - Sums (dot, dw2): the TPU grid runs in order and carries one SMEM
//   accumulator; here blocks run in no order. Each product is taken in
//   double (exact for f32 operands) and summed in double: dot keeps
//   kUnroll independent accumulators a thread, added in index order;
//   each block adds its threads in a fixed order (shuffles within a warp,
//   then the warps in index order) and writes its partial. The block that
//   arrives last (an atomic ticket after __threadfence, as in
//   csrc/stencil_dots.cu) adds the partials in block-index order, rounds
//   once to T and writes the ticket back to 0, so the scratch (partials
//   and ticket) is zeroed once and reused by every later launch on its
//   stream: a call is one device kernel. The grid is a function of the
//   node count, the operands' alignment class and the card, so two
//   launches on one input add in the same order and give the same bits;
//   there is no float atomic.
// - update_w_r keeps w_old in a register and forms the increment from the
//   value it stores, so dw2 is the realised step in one launch.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// update_w_r's grid: at most this many blocks, each thread striding
constexpr int kMaxReduceBlocks = 1024;
// vectors of each operand a thread of dot has in flight
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

// the 16-byte vector of T and its lane count
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int lanes = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int lanes = 2;
};

// The split of n nodes into a scalar head [0, head), whole 16-byte
// vectors from head (nv of them) and a scalar tail [tail, n); scalars =
// head + (n - tail) nodes go through the scalar loop.
struct Span {
  int64_t head, nv, tail, scalars;
};

template <typename T>
Span span_of(int64_t n, const void* const* ptrs, int count) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(ptrs[0]) % 16;
  bool same = true;
  for (int k = 1; k < count; ++k) {
    same = same && reinterpret_cast<uintptr_t>(ptrs[k]) % 16 == mis;
  }
  if (!same || mis % sizeof(T) != 0) return Span{n, 0, n, n};
  int64_t head = static_cast<int64_t>((16 - mis) % 16 / sizeof(T));
  if (head > n) head = n;
  const int64_t nv = (n - head) / Vec<T>::lanes;
  const int64_t tail = head + nv * Vec<T>::lanes;
  return Span{head, nv, tail, head + (n - tail)};
}

// node k of the scalar loop's index space: the head, then the tail
__device__ __forceinline__ int64_t scalar_node(const Span& s, int64_t k) {
  return k < s.head ? k : s.tail + (k - s.head);
}

// An L2 policy that evicts these lines first: each byte is read once.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// A 16-byte load through the read-only path that allocates nothing in L1,
// asks L2 for the whole 256-byte span around it and marks it evict-first.
__device__ __forceinline__ float4 ld_stream(const float4* p,
                                            uint64_t policy) {
  float4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.L2::256B.v4.f32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ double2 ld_stream(const double2* p,
                                             uint64_t policy) {
  double2 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.L2::256B.v2.f64 "
      "{%0, %1}, [%2], %3;"
      : "=d"(v.x), "=d"(v.y)
      : "l"(p), "l"(policy));
  return v;
}

// z + b*p a lane at a time: a rounded product, then a rounded sum
// (-fmad=false), as update_p_plain computes it
__device__ __forceinline__ float4 axpy(float4 z, float b, float4 p) {
  return make_float4(z.x + b * p.x, z.y + b * p.y, z.z + b * p.z,
                     z.w + b * p.w);
}
__device__ __forceinline__ double2 axpy(double2 z, double b, double2 p) {
  return make_double2(z.x + b * p.x, z.y + b * p.y);
}

// the vector's products, each in double, added in lane order into acc
// (a float's product with a float is exact in double, so one fused
// multiply-add rounds once where a product and a sum would: the same bits)
__device__ __forceinline__ double dot_into(double acc, float4 x, float4 y) {
  acc = __fma_rn((double)x.x, (double)y.x, acc);
  acc = __fma_rn((double)x.y, (double)y.y, acc);
  acc = __fma_rn((double)x.z, (double)y.z, acc);
  acc = __fma_rn((double)x.w, (double)y.w, acc);
  return acc;
}
__device__ __forceinline__ double dot_into(double acc, double2 x,
                                           double2 y) {
  acc += x.x * y.x;
  acc += x.y * y.y;
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dinv_kernel(const T* __restrict__ r, const T* __restrict__ d,
            T* __restrict__ z, int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (i >= n) return;
  const T dv = d[i];
  z[i] = dv != T(0) ? r[i] / dv : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_p_kernel(const T* __restrict__ beta, const T* __restrict__ z,
                const T* __restrict__ p, T* __restrict__ out, Span s) {
  using V = typename Vec<T>::type;
  const T b = *beta;
  const int64_t tid = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t nth = (int64_t)gridDim.x * kThreads;
  if (tid < s.nv) {
    const uint64_t policy = evict_first_policy();
    const V* zv = reinterpret_cast<const V*>(z + s.head);
    const V* pv = reinterpret_cast<const V*>(p + s.head);
    V* ov = reinterpret_cast<V*>(out + s.head);
    __stcs(ov + tid, axpy(ld_stream(zv + tid, policy), b,
                          ld_stream(pv + tid, policy)));
  }
  for (int64_t k = tid; k < s.scalars; k += nth) {
    const int64_t i = scalar_node(s, k);
    out[i] = z[i] + b * p[i];
  }
}

// The block's sum of v, threads in a fixed order; valid in thread 0.
__device__ double block_sum(double v, double* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int q = 0; q < kWarps; ++q) s += s_warp[q];
  }
  __syncthreads();  // s_warp may be written again by the caller
  return s;
}

// Writes this block's partial; the last block to arrive adds every
// partial in block-index order, writes the ticket back to 0 for the next
// launch, and returns true in thread 0 with the total in *total.
__device__ bool finish_sum(double acc, double* partials, int* ticket,
                           double* total) {
  __shared__ double s_warp[kWarps];
  __shared__ int s_last;
  const double bsum = block_sum(acc, s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = bsum;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  double s = 0.0;
  for (int q = threadIdx.x; q < (int)gridDim.x; q += kThreads) {
    s += __ldcg(&partials[q]);
  }
  *total = block_sum(s, s_warp);
  if (threadIdx.x == 0) *ticket = 0;  // every block has taken its ticket
  return threadIdx.x == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ x, const T* __restrict__ y, Span s, T h1,
           T h2, double* partials, int* ticket, T* __restrict__ out) {
  using V = typename Vec<T>::type;
  const uint64_t policy = evict_first_policy();
  const int64_t tid = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t nth = (int64_t)gridDim.x * kThreads;
  const V* xv = reinterpret_cast<const V*>(x + s.head);
  const V* yv = reinterpret_cast<const V*>(y + s.head);
  double acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = 0.0;
  for (int64_t i0 = tid; i0 < s.nv; i0 += kUnroll * nth) {
    V xr[kUnroll], yr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * nth;
      if (i < s.nv) {
        xr[u] = ld_stream(xv + i, policy);
        yr[u] = ld_stream(yv + i, policy);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * nth < s.nv) acc[u] = dot_into(acc[u], xr[u], yr[u]);
    }
  }
  for (int64_t k = tid; k < s.scalars; k += nth) {
    const int64_t i = scalar_node(s, k);
    acc[0] += (double)x[i] * (double)y[i];
  }
  double mine = acc[0];
#pragma unroll
  for (int u = 1; u < kUnroll; ++u) mine += acc[u];
  double total;
  if (finish_sum(mine, partials, ticket, &total)) {
    const T sum = (T)total;
    *out = sum * h1 * h2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_w_r_kernel(const T* __restrict__ alpha, const T* __restrict__ w,
                  const T* __restrict__ r, const T* __restrict__ p,
                  const T* __restrict__ ap, T* __restrict__ w_new,
                  T* __restrict__ r_new, int64_t n, double* partials,
                  int* ticket, T* __restrict__ dw2) {
  const T a = *alpha;
  double acc = 0.0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += stride) {
    const T w_old = w[i];
    const T wn = w_old + a * p[i];
    w_new[i] = wn;
    r_new[i] = r[i] - a * ap[i];
    const T dw = wn - w_old;
    acc += (double)dw * (double)dw;
  }
  double total;
  if (finish_sum(acc, partials, ticket, &total)) *dw2 = (T)total;
}

int elementwise_blocks(int64_t n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

int reduce_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxReduceBlocks ? (b < 1 ? 1 : b)
                                               : kMaxReduceBlocks);
}

// The blocks of `kernel` (kThreads threads, no dynamic shared memory) the
// current device holds at once, SMs x occupancy, asked once a device and
// kept in `cache` (one a kernel; a repeated first query writes the same
// value).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* cache, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    cache[dev] = sms * (per_sm < 1 ? 1 : per_sm);
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// dot's grid: enough blocks for one vector (or, on the scalar loop, one
// node) a thread, at most the blocks the card holds.
int streaming_blocks(const Span& s, int resident) {
  const int64_t units = s.nv > s.scalars ? s.nv : s.scalars;
  const int64_t b = (units + kThreads - 1) / kThreads;
  return static_cast<int>(b < resident ? (b < 1 ? 1 : b) : resident);
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

template <typename T>
int dinv(const T* r, const T* d, T* z, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  dinv_kernel<T><<<elementwise_blocks(n), kThreads, 0, as_stream(stream)>>>(
      r, d, z, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dot(const T* x, const T* y, int64_t n, T h1, T h2, double* partials,
        int* ticket, T* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  static int cache[kMaxDevices];
  int resident = 0;
  const cudaError_t err = resident_blocks(dot_kernel<T>, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* ptrs[] = {x, y};
  const Span s = span_of<T>(n, ptrs, 2);
  dot_kernel<T><<<streaming_blocks(s, resident), kThreads, 0,
                  as_stream(stream)>>>(x, y, s, h1, h2, partials, ticket,
                                       out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_w_r(const T* alpha, const T* w, const T* r, const T* p,
               const T* ap, T* w_new, T* r_new, int64_t n, double* partials,
               int* ticket, T* dw2, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  update_w_r_kernel<T><<<reduce_blocks(n), kThreads, 0,
                         as_stream(stream)>>>(
      alpha, w, r, p, ap, w_new, r_new, n, partials, ticket, dw2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update_p(const T* beta, const T* z, const T* p, T* out, int64_t n,
             void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {z, p, out};
  const Span s = span_of<T>(n, ptrs, 3);
  const int64_t units = s.nv > s.scalars ? s.nv : s.scalars;
  update_p_kernel<T><<<elementwise_blocks(units), kThreads, 0,
                       as_stream(stream)>>>(beta, z, p, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The doubles of partials scratch that dot and update_w_r need on
// `device` at any node count: at least every block of the largest grid
// either launches (SMs x the most 256-thread blocks an SM holds, and
// update_w_r's 1024). ticket: one int, 0 before the first launch; each
// launch leaves it 0. A negative value is a CUDA error code, negated.
int pe_stage4_scratch_len(int device) {
  int sms = 0, threads = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &threads, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int len = sms * (threads / kThreads);
  return len > kMaxReduceBlocks ? len : kMaxReduceBlocks;
}

// Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for an empty array. n is the node count g1*g2;
// every array is contiguous.
int pe_dinv_f32(const float* r, const float* d, float* z, int64_t n,
                void* stream) {
  return dinv(r, d, z, n, stream);
}

int pe_dinv_f64(const double* r, const double* d, double* z, int64_t n,
                void* stream) {
  return dinv(r, d, z, n, stream);
}

int pe_dot_f32(const float* x, const float* y, int64_t n, float h1,
               float h2, double* partials, int* ticket, float* out,
               void* stream) {
  return dot(x, y, n, h1, h2, partials, ticket, out, stream);
}

int pe_dot_f64(const double* x, const double* y, int64_t n, double h1,
               double h2, double* partials, int* ticket, double* out,
               void* stream) {
  return dot(x, y, n, h1, h2, partials, ticket, out, stream);
}

int pe_update_w_r_f32(const float* alpha, const float* w, const float* r,
                      const float* p, const float* ap, float* w_new,
                      float* r_new, int64_t n, double* partials, int* ticket,
                      float* dw2, void* stream) {
  return update_w_r(alpha, w, r, p, ap, w_new, r_new, n, partials, ticket,
                    dw2, stream);
}

int pe_update_w_r_f64(const double* alpha, const double* w, const double* r,
                      const double* p, const double* ap, double* w_new,
                      double* r_new, int64_t n, double* partials,
                      int* ticket, double* dw2, void* stream) {
  return update_w_r(alpha, w, r, p, ap, w_new, r_new, n, partials, ticket,
                    dw2, stream);
}

int pe_update_p_f32(const float* beta, const float* z, const float* p,
                    float* out, int64_t n, void* stream) {
  return update_p(beta, z, p, out, n, stream);
}

int pe_update_p_f64(const double* beta, const double* z, const double* p,
                    double* out, int64_t n, void* stream) {
  return update_p(beta, z, p, out, n, stream);
}

const char* pe_stage4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
