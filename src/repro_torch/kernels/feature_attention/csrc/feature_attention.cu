// ASO-Fed Eq. (5)-(6) server feature pass, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/feature_attention/kernel.py::feature_attention_kernel
//   (body _feature_attention_kernel).
//
// Computes, for each row of a row-major (rows, cols) matrix, in fp32:
//   out = softmax(|w|) * w
// and with normalize != 0 rescales the row to its input L2 norm:
//   out *= ||w|| / max(||out||, 1e-12)
// then stores in the input dtype (fp32 or bf16, rounded to nearest even).
//
// Bound: bytes.  Each element is read once and written once (2 * rows *
// cols * sizeof(T) bytes) for about a dozen fp32 operations, far below the
// card's operations-per-byte balance: Qwen2-0.5B's (151936, 896) fp32
// embedding moves 1.089 GB, 0.325 ms at 3.35 TB/s.  The oracle path's
// (8, 256) moves 16 KB: there a launch costs more than its bytes.
//
// Design: every byte crosses device memory once.  A row stays on chip, in
// registers, from its load to its store; nothing is read twice.
//  * A warp a row while a lane holds at most 32 values (1024 columns on
//    the vector route), else a group of 2, 4 or 8 warps of one block a row
//    (up to 8192 columns), each lane holding NV vectors of V elements;
//    lane l of the group's warp g holds vectors (j * group + g) * 32 + l,
//    so each load and store instruction of a warp covers 32 * V contiguous
//    elements.  DeepSeek-V2-Lite's 2048 fp32 columns take 2 warps,
//    Falcon-Mamba's 4096 take 4: the same registers a lane as a warp a
//    row, two shared-memory exchanges a row more, and the same share of
//    the bound as the one-warp rows.  The other form tried for wide rows,
//    a warp a row fed by TMA bulk copies into a shared-memory ring, was
//    about as fast at its best ring (one stage a warp) and slower with
//    deeper ones; this form needs no mbarriers, proxy fences or shared-
//    memory budget per width, and one code path serves every route.
//  * Routes.  Vector: 16-byte loads and stores (V = 4 fp32, 8 bf16) when a
//    row is a whole number of 16 bytes and both pointers are 16-byte
//    aligned, checked at launch (a contiguous view with a storage offset
//    need not be); the masks compile away when a row is a whole number of
//    the group's 512-byte pieces (Qwen2-0.5B's 896 fp32 columns: 7 float4
//    a lane, one warp).  Scalar: any other row (ragged cols, odd bf16
//    cols, an offset pointer), V = 1 with masked 4- or 2-byte accesses, at
//    most 16 values a lane (each access takes its own address and
//    predicate: at 32 they spill), the same pass.  Wide: rows no group
//    holds (above 8192 columns on the vector route, 4096 on the scalar)
//    take a block a row that reads its row three times (the max; the
//    sums; the scaled write), the one route that re-reads; no model of the
//    repo has such a row (the widest is Falcon-Mamba's 4096, vector).
//  * The plain version's arithmetic, element by element: e = exp(|w| -
//    max), out = (e / sum e) w, then out * (||w|| / max(||out||, 1e-12)),
//    each product and quotient rounded as PyTorch rounds it; only its three
//    sums (sum e, sum w^2, sum out^2) are formed otherwise, their fp32
//    terms added in fp64 and rounded once.  Three reduction rounds a row:
//    the exact max of |w| as one redux.sync on its bits (non-negative
//    floats order as their bit patterns); one fp64 butterfly of sum e and
//    sum w^2; one of sum out^2 (normalize = 0 stops at (e / sum e) w).  A
//    group crosses warps through shared memory after each round (three
//    named barriers a row).  Why not fewer roundings: out = e w ||w|| /
//    max(||e w||, 1e-12 sum e), the 1 / sum e cancelled as
//    feature_fold_tick takes it, with fp32 sums in this layout's order,
//    left each pass an ulp or two from the plain version, and the
//    sequential fold's chain of passes magnifies that where two entries of
//    a row compete for its softmax: chip_smoke.py's fold_vs_plain
//    (`multilabel`, K1 once an arrival) failed its n_real x 1e-6 gate.
//    With its sums rounded once the pass meets the plain version bit for
//    bit wherever PyTorch's fp32 sums round to the same values; e is
//    computed twice (the registers hold one value an element).
//  * Bytes in flight: a persistent grid (SMs x resident blocks) strides
//    over rows, each warp loading its next row as soon as it has stored
//    the last.  At a lane's full share (28-32 values) an instance takes
//    123-124 registers, no spill: 2 blocks, 16 warps an SM, 56-64 KB of
//    loads in flight an SM against the ~25 KB that 3.35 TB/s times ~1 us
//    of latency asks for.  Capped at 64 or 80 registers (32 or 24 warps)
//    it spilled and was slower.  Loading the next row before this row's
//    reductions and cache-streaming hints did not pay; both are out.
// expf (not __expf) and no fast-math flags keep fp32 within 1e-6 of the
// plain PyTorch version.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// values a lane holds of its row, in registers: 32 on the vector route;
// 16 on the scalar route, whose masked element accesses each take an
// address and a predicate (at 32 they spill)
constexpr int lane_values(int vec) { return vec == 1 ? 16 : 32; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide sum; every thread gets the result.  `sh` holds one slot per
// warp and is reused, hence the trailing barrier.
__device__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kWarps) ? sh[threadIdx.x] : 0.0f;
  if (warp == 0) v = warp_sum(v);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  v = sh[0];
  __syncthreads();
  return v;
}

// V elements at p as fp32, and back (bf16 rounded to nearest even, as
// torch's cast).
template <typename T, int V>
struct Io;

// One element as fp32, and back
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T>
struct Io<T, 1> {
  static __device__ __forceinline__ void load(float* v, const T* p) {
    v[0] = to_float(__ldg(p));
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *p = from_float<T>(v[0]);
  }
};

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(float* v, const float* p) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(float* v,
                                              const __nv_bfloat16* p) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// A lane's share of a row: its vector j is first + j * step; vectors past
// the row (nvec) read as 0.
template <typename T, int V, int NV, bool kAll>
__device__ __forceinline__ void load_lane(float (&v)[NV][V], const T* row,
                                          int first, int step, int nvec) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = first + j * step;
    if (kAll || k < nvec) {
      Io<T, V>::load(v[j], row + static_cast<size_t>(k) * V);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) v[j][c] = 0.0f;
    }
  }
}

// Blocks an SM the registers must leave room for: at a lane's full share
// of a row (e computed twice, fp64 sums) ~124 registers a thread, 2 blocks
// (16 warps) an SM; at half of it or less 64, 4 blocks.  A lower cap
// spills, and the spills cost more than the warps gain.
constexpr int row_min_blocks(int share) { return share <= 16 ? 4 : 2; }

// Named barrier `id` over the `n` threads of one row's warps.
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A warp's sum, every lane ending with the same value (a butterfly: the
// partners add the same two values).
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) v += __shfl_xor_sync(kFull, v, k);
  return v;
}

// A lane's terms of one sum: fp32 terms, formed as the plain version forms
// them, added in fp64, so that the row's sum rounds once, to the fp32 sum
// of the exact terms (see the note at the top).
template <typename T, int V, int NV, bool kAll, typename F>
__device__ __forceinline__ double lane_sum(const float (&v)[NV][V],
                                           int first, int step, int nvec,
                                           F term) {
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool in = kAll || first + j * step < nvec;
#pragma unroll
    for (int c = 0; c < V; ++c)
      if (in) s += static_cast<double>(term(v[j][c]));
  }
  return s;
}

// The sums of a row's group of warps: each warp's in the warp's slot, then
// every warp adds the group's slots in order (the same sums in each).
template <int K>
__device__ __forceinline__ void group_sums(double (&s)[K],
                                           double (*red)[kWarps], int lane,
                                           int warp, int base, int grp,
                                           int group) {
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = warp_sum(s[k]);
  if (group > 1) {
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < K; ++k) red[k][warp] = s[k];
    group_sync(1 + grp, 32 * group);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = 0.0;
      for (int g = 0; g < group; ++g) s[k] += red[k][base + g];
    }
  }
}

template <typename T, int V, int NV, bool kAll>
__global__ void __launch_bounds__(
    kThreads, row_min_blocks(NV * V * 32 / lane_values(V)))
feature_attention_rows(const T* __restrict__ w, T* __restrict__ out,
                       int rows, int cols, int group, int normalize) {
  // a group's partials, one slot a warp: the max (as bits), then the three
  // sums, each in its own slots (a warp may write a row's next partial
  // while the group's last warp still reads the one before)
  __shared__ unsigned red_max[kWarps];
  __shared__ double red_sum[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_block = kWarps / group;  // rows a block holds at once
  const int grp = warp / group, gw = warp % group;
  const int base = grp * group;  // the group's first warp
  const int nvec = cols / V;
  const int first = gw * 32 + lane, step = group * 32;
  const long long stride = static_cast<long long>(gridDim.x) * per_block;
  for (long long row = static_cast<long long>(blockIdx.x) * per_block + grp;
       row < rows; row += stride) {
    float v[NV][V];
    load_lane<T, V, NV, kAll>(v, w + row * cols, first, step, nvec);
    // round 1: the exact max of |w| (|w| >= 0: 0 is its identity)
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < V; ++c) m = fmaxf(m, fabsf(v[j][c]));
    unsigned mb = __reduce_max_sync(kFull, __float_as_uint(m));
    if (group > 1) {
      if (lane == 0) red_max[warp] = mb;
      group_sync(1 + grp, 32 * group);
      mb = 0u;
      for (int k = 0; k < group; ++k) mb = max(mb, red_max[base + k]);
    }
    m = __uint_as_float(mb);
    // e = exp(|w| - max), bit for bit the plain version's
    const auto ex = [m](float x) { return expf(fabsf(x) - m); };
    // round 2: sum e and sum w^2
    double s[2] = {
        lane_sum<T, V, NV, kAll>(v, first, step, nvec, ex),
        lane_sum<T, V, NV, kAll>(v, first, step, nvec,
                                 [](float x) { return __fmul_rn(x, x); })};
    group_sums(s, red_sum, lane, warp, base, grp, group);
    const float se = static_cast<float>(s[0]);
    // the row becomes (e / sum e) w, the plain version's sequence (e again
    // from w: the registers hold one value an element)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < V; ++c)
        v[j][c] = __fmul_rn(ex(v[j][c]) / se, v[j][c]);
    float scale = 1.0f;
    if (normalize) {  // round 3: sum out^2; out * ||w|| / max(||out||, 1e-12)
      double so[1] = {lane_sum<T, V, NV, kAll>(
          v, first, step, nvec, [](float o) { return __fmul_rn(o, o); })};
      group_sums(so, red_sum + 2, lane, warp, base, grp, group);
      scale = sqrtf(static_cast<float>(s[1])) /
              fmaxf(sqrtf(static_cast<float>(so[0])), 1e-12f);
    }
    T* dst = out + row * cols;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k = first + j * step;
      if (kAll || k < nvec) {
        if (normalize)
#pragma unroll
          for (int c = 0; c < V; ++c) v[j][c] = __fmul_rn(v[j][c], scale);
        Io<T, V>::store(dst + static_cast<size_t>(k) * V, v[j]);
      }
    }
  }
}

// Rows wider than kWarps warps can hold: a block a row, four reads of it
// (the max; sum e and sum w^2; sum out^2; the write), the same arithmetic.
template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_attention_rows_wide(const T* __restrict__ w, T* __restrict__ out,
                            int cols, int normalize) {
  __shared__ unsigned red_max[kWarps];
  __shared__ double red_sum[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const T* src = w + off;
  T* dst = out + off;
  float m = 0.0f;
  for (int j = threadIdx.x; j < cols; j += kThreads)
    m = fmaxf(m, fabsf(to_float(src[j])));
  const unsigned mw = __reduce_max_sync(kFull, __float_as_uint(m));
  if (lane == 0) red_max[warp] = mw;
  __syncthreads();
  unsigned mb = 0u;
  for (int k = 0; k < kWarps; ++k) mb = max(mb, red_max[k]);
  m = __uint_as_float(mb);
  double s[2] = {0.0, 0.0};
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float x = to_float(src[j]);
    s[0] += static_cast<double>(expf(fabsf(x) - m));
    s[1] += static_cast<double>(__fmul_rn(x, x));
  }
  group_sums(s, red_sum, lane, warp, 0, -1, kWarps);  // bar.sync 0
  const float se = static_cast<float>(s[0]);
  float scale = 1.0f;
  if (normalize) {
    double so[1] = {0.0};
    for (int j = threadIdx.x; j < cols; j += kThreads) {
      const float x = to_float(src[j]);
      const float o = __fmul_rn(expf(fabsf(x) - m) / se, x);
      so[0] += static_cast<double>(__fmul_rn(o, o));
    }
    group_sums(so, red_sum + 2, lane, warp, 0, -1, kWarps);
    scale = sqrtf(static_cast<float>(s[1])) /
            fmaxf(sqrtf(static_cast<float>(so[0])), 1e-12f);
  }
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float x = to_float(src[j]);
    const float o = __fmul_rn(expf(fabsf(x) - m) / se, x);
    dst[j] = from_float<T>(normalize ? __fmul_rn(o, scale) : o);
  }
}

enum Route { kVector = 0, kScalar = 1, kWide = 2 };

// How a launch lays a row out (see the note at the top).
struct RowPlan {
  int route;
  int vec;    // elements a vector (V)
  int nv;     // vectors a lane (NV)
  int group;  // warps a row
  bool all;   // every lane's vectors lie in the row: no masks
};

RowPlan plan_rows(const void* w, const void* out, int cols, int itemsize) {
  RowPlan p{};
  const bool aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       static_cast<long long>(cols) * itemsize % 16 == 0;
  p.route = aligned ? kVector : kScalar;
  p.vec = aligned ? 16 / itemsize : 1;
  const int nvec = cols / p.vec;
  const int lane_max = lane_values(p.vec) / p.vec;  // vectors a lane
  if (nvec > kWarps * 32 * lane_max) {
    p.route = kWide;
    p.vec = 1;
    p.nv = 0;
    p.group = kWarps;
    return p;
  }
  p.group = 1;  // the fewest warps that hold the row
  while (p.group * 32 * lane_max < nvec) p.group *= 2;
  const int per = 32 * p.group;
  p.nv = (nvec + per - 1) / per;
  if (p.vec == 1)  // the scalar route's instances: powers of two
    while (p.nv & (p.nv - 1)) ++p.nv;
  p.all = nvec == per * p.nv;
  return p;
}

template <typename T>
using RowFn = void (*)(const T*, T*, int, int, int, int);

// A row kernel's instance and its resident blocks an SM (asked once).
template <typename T>
struct RowKernel {
  RowFn<T> fn;
  int (*blocks)();
};

template <typename T, int V, int NV, bool kAll>
int resident_blocks() {
  static std::atomic<int> n{0};
  int b = n.load(std::memory_order_relaxed);
  if (b == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, feature_attention_rows<T, V, NV, kAll>, kThreads, 0) !=
        cudaSuccess)
      return 0;
    n.store(b, std::memory_order_relaxed);
  }
  return b;
}

// The instance for nv vectors a lane: NV = 1 .. 32 / V, powers of two to
// 16 at V = 1.
template <typename T, int V, int NV>
RowKernel<T> row_kernel(int nv, bool all) {
  if constexpr (NV * V > lane_values(V)) {
    return RowKernel<T>{nullptr, nullptr};
  } else {
    if (nv == NV)
      return all ? RowKernel<T>{feature_attention_rows<T, V, NV, true>,
                                resident_blocks<T, V, NV, true>}
                 : RowKernel<T>{feature_attention_rows<T, V, NV, false>,
                                resident_blocks<T, V, NV, false>};
    return row_kernel<T, V, V == 1 ? 2 * NV : NV + 1>(nv, all);
  }
}

template <typename T>
RowKernel<T> row_kernel_for(const RowPlan& p) {
  constexpr int kVec = 16 / sizeof(T);
  return p.vec == 1 ? row_kernel<T, 1, 1>(p.nv, p.all)
                    : row_kernel<T, kVec, 1>(p.nv, p.all);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The persistent grid: no more blocks than the rows need, nor than the
// card holds at once.
long long row_grid(const RowPlan& p, int rows, int blocks_per_sm) {
  const int per_block = kWarps / p.group;
  const long long need = (rows + per_block - 1LL) / per_block;
  const long long fit = static_cast<long long>(sm_count()) * blocks_per_sm;
  return fit > 0 && fit < need ? fit : need;
}

template <typename T>
int launch_rows(const void* w, void* out, int rows, int cols, int normalize,
                cudaStream_t s) {
  const RowPlan p = plan_rows(w, out, cols, sizeof(T));
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (p.route == kWide) {
    feature_attention_rows_wide<T><<<static_cast<unsigned>(rows), kThreads,
                                     0, s>>>(wt, ot, cols, normalize);
    return static_cast<int>(cudaGetLastError());
  }
  const RowKernel<T> k = row_kernel_for<T>(p);
  if (k.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = row_grid(p, rows, k.blocks());
  k.fn<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(wt, ot, rows, cols,
                                                         p.group, normalize);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int plan_info(const void* w, const void* out, int rows, int cols, int* info) {
  const RowPlan p = plan_rows(w, out, cols, sizeof(T));
  cudaFuncAttributes attr{};
  cudaError_t err;
  int blocks = 0;
  long long grid = rows;
  if (p.route == kWide) {
    err = cudaFuncGetAttributes(&attr, feature_attention_rows_wide<T>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, feature_attention_rows_wide<T>, kThreads, 0);
  } else {
    const RowKernel<T> k = row_kernel_for<T>(p);
    if (k.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncGetAttributes(&attr, k.fn);
    blocks = k.blocks();
    grid = row_grid(p, rows, blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = p.route;
  info[1] = p.vec;
  info[2] = p.nv;
  info[3] = p.group;
  info[4] = p.all ? 1 : 0;
  info[5] = kThreads;
  info[6] = static_cast<int>(grid);
  info[7] = blocks;
  info[8] = attr.numRegs;
  info[9] = static_cast<int>(attr.localSizeBytes);
  info[10] = sm_count();
  return 0;
}

}  // namespace

// C entry for ctypes.  dtype: 0 = fp32, 1 = bf16.  Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch surfaces in the caller.
extern "C" int feature_attention_launch(const void* w, void* out, int rows,
                                        int cols, int dtype, int normalize,
                                        void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rows<float>(w, out, rows, cols, normalize, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(w, out, rows, cols, normalize, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How feature_attention_launch would run these arguments, for the record:
// info[0..10] = route (0 vector, 1 scalar, 2 wide), elements a vector,
// vectors a lane, warps a row, masks compiled away (0 / 1), threads a
// block, grid, resident blocks an SM, registers a thread, local (spill)
// bytes a thread, SMs.  Launches nothing.
extern "C" int feature_attention_plan(const void* w, const void* out,
                                      int rows, int cols, int dtype,
                                      int* info) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return plan_info<float>(w, out, rows, cols, info);
  if (dtype == 1) return plan_info<__nv_bfloat16>(w, out, rows, cols, info);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// feature_fold: ASO-Fed's whole sequential server fold for one tick, in one
// launch.
//
// Replaces, on the engine's main path, the per-arrival chain that reached
// the Pallas TPU kernel
//   src/repro/kernels/feature_attention/kernel.py::feature_attention_kernel
// once per fold, inside the sequential lax.scan of src/repro/sim/compile.py
// over src/repro/core/algorithms/asofed.py::build_fold.  For each real
// arrival s = 0 .. n_real-1, in order:
//   n[idx_s] = n_vis_s;  weight_s = n_vis_s / max(sum(n), 1e-9)  (n'_k / N')
//   w <- (-weight_s) * delta_s + w on every leaf                      (Eq. 4)
//   first layer <- softmax(|w|) * w per row, row norm restored     (Eq. 5-6)
//   received[s] <- w
// Slots n_real .. S-1 of received take a copy of slot n_real-1; w_out and
// n_out (a separate buffer: n is read by every block) get the post-tick
// server.
//
// With a fold count reps (an (S,) int32 array in device memory; null means
// 1 for every slot), slot s folds reps[s] times: 0 leaves the server and n
// untouched and received[s] is the model as it stands (an arrival the
// chaos layer's admission guards rejected), 2 folds the same delta twice
// in a row, each fold the Eq. (4) axpy and the Eq. (5)-(6) pass, with the
// same weight both times (the count is replaced twice by the same n_vis),
// and received[s] is the model after the second (a duplicated delivery).
// That is the JAX tick's sequential scan with tree_where(admit & dup, ...)
// (src/repro/sim/compile.py:339-352).  The count is read on the card, so
// the host never waits on the admission decision.  A null reps launches
// the instantiation with kReps = false, whose count is the constant 1:
// the code the fold ran before counts existed.
//
// Bound: bytes.  At the main path's tick (paper LSTM, hidden 64: 18,753
// fp32 a model, S = 64, n_real ~ 51) the launch reads ~3.8 MB of deltas
// and writes 4.8 MB of received models: ~2.6 us at 3.35 TB/s.  What holds
// it back is latency: each first-layer row is a chain of n_real dependent
// feature passes, each with two warp reductions.
//
// Design:
//  * The weight stream is computed by every block into shared memory, with
//    no host op per arrival.  N'_0 = sum(n): the blocks of a thread-block
//    cluster (8) each sum an eighth of n and read the others' partial sums
//    through distributed shared memory, so a block reads n_len / 8 counts,
//    not all of them; the cluster barrier is split in arrive and wait so
//    the per-slot work runs in between.  Per slot, the count it replaces
//    (the latest earlier write of the same client in this tick, else
//    n[idx]: a branch-free pass over the tick's clients staged in shared
//    memory, O(n_real) a slot; a slot that does not fold adds nothing and
//    is no earlier write) and one prefix sum give N'_s.  Counts are
//    whole numbers: while sum(n) stays below 2^24 every partial sum is
//    exact, so the weights equal the plain version's bit for bit, whatever
//    the order of the sums.
//  * First layer: one row a block, on its warp 0, so that no SM carries
//    more than one row's loads and stores; the row stays in registers
//    (cols <= 1024, VPL values a lane, no masks when cols = 32 VPL) or,
//    wider, in shared memory, for the whole tick.  The reductions are warp
//    level only (redux.sync for the max, shuffles for the sums), and the
//    next slot's delta row is loaded ahead of the dependent math.  The
//    feature pass takes the exact row max, then one reduction round of
//    sum e, sum w^2 and sum (e w)^2, with e = exp(|w| - max): out = e w
//    ||w|| / max(||e w||, 1e-12 sum e), the plain version's (e / sum e) w
//    rescaled to ||w|| with the 1 / sum e cancelled (normalize = 0: out =
//    e w / sum e).  Two rounds a step instead of K1's three; the first
//    layer differs from the plain version by the summation order, a few
//    ulps an arrival.
//  * Every other leaf: one thread per element looping over the slots, its
//    delta loads kBatch slots ahead, coalesced received stores.  The axpy
//    is __fadd_rn(__fmul_rn(-weight, d), w): no FMA contraction, so these
//    leaves (and n_out) are bitwise equal to PyTorch's multiply then add.

namespace {

constexpr int kCluster = 8;         // blocks a cluster sharing sum(n)
constexpr int kMaxLeaves = 16;
constexpr int kBatch = 8;           // delta loads in flight a thread

// Passed by value: the leaves' pointers and sizes, the tick's arrays.
struct FoldParams {
  const float* w[kMaxLeaves];   // server leaves, numel each
  const float* d[kMaxLeaves];   // uploads (S, numel)
  float* w_out[kMaxLeaves];     // post-tick leaves
  float* rec[kMaxLeaves];       // received models (S, numel)
  int numel[kMaxLeaves];
  // elementwise blocks: leaf L owns [block_end[L-1], block_end[L])
  // (rows blocks before leaf 0); the first layer owns none
  int block_end[kMaxLeaves];
  // the first layer's four arrays again, read without an index: an
  // indexed parameter is a dependent constant-bank load in the row loop
  const float* w1;
  const float* d1;
  float* w1_out;
  float* rec1;
  const float* n;               // counts n'_k, n_len
  float* n_out;
  const long long* idx;         // (S,) client of each slot
  const float* n_vis;           // (S,) its new count
  const int* reps;              // (S,) its fold count (0-2), or null: 1
  int n_leaves, rows, cols, n_len, S, n_real, normalize;
};

// A warp's first-layer row: VPL values a lane in registers, lane l holding
// columns l, l + 32, ...; VPL = 0 keeps it in shared memory (wide rows).
template <int VPL>
struct Row {
  float v[VPL];
  __device__ __forceinline__ float& operator[](int i) { return v[i]; }
};
template <>
struct Row<0> {
  float* v;  // this lane's first column in the block's shared row
  __device__ __forceinline__ float& operator[](int i) { return v[32 * i]; }
};

// Whether the lane's i-th value is a column of the row.  kAll: cols is
// 32 * VPL, every value is (the main path's 256 columns), and the masks
// compile away.
template <bool kAll>
__device__ __forceinline__ bool in_row(int lane, int i, int cols) {
  return kAll || lane + 32 * i < cols;
}

// The Eq. (5)-(6) pass on a warp's row (columns past `cols` hold 0).
// Branch-free over the lane's values, so their exps overlap: a column
// past `cols` computes exp(-max) and adds 0.
template <int VPL, bool kAll>
__device__ __forceinline__ void feature_pass_row(Row<VPL>& w, int nv,
                                                 int lane, int cols,
                                                 int normalize) {
  float m = 0.0f;  // |w| >= 0
#pragma unroll
  for (int i = 0; i < nv; ++i) m = fmaxf(m, fabsf(w[i]));
  // non-negative floats order as their bit patterns: one redux.sync
  m = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(m)));
  float se = 0.0f, sw = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < nv; ++i) {
    const float v = w[i];
    const float ev = expf(fabsf(v) - m);
    const float e = in_row<kAll>(lane, i, cols) ? ev : 0.0f;
    const float o = e * v;
    se += e;
    sw += v * v;
    s2 += o * o;
    w[i] = o;
  }
  // a butterfly: every lane ends with the same three sums
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    se += __shfl_xor_sync(kFull, se, k);
    sw += __shfl_xor_sync(kFull, sw, k);
    s2 += __shfl_xor_sync(kFull, s2, k);
  }
  if (normalize) {
    const float scale = sqrtf(sw) / fmaxf(sqrtf(s2), 1e-12f * se);
#pragma unroll
    for (int i = 0; i < nv; ++i) w[i] = w[i] * scale;
  } else {
#pragma unroll
    for (int i = 0; i < nv; ++i) w[i] = w[i] / se;
  }
}

// A lane's VPL values of a first-layer row from global memory (columns
// past `cols` read as 0).
template <int VPL, bool kAll>
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int lane, int cols) {
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    dst[i] = in_row<kAll>(lane, i, cols) ? __ldg(src + 32 * i) : 0.0f;
}

// One first-layer row through the whole tick (warp 0 of its block).
template <int VPL, bool kAll, bool kReps>
__device__ void fold_row(const FoldParams& p, const float* wt, const int* rp,
                         int row, int lane, float* shared_row) {
  const int cols = p.cols;
  const int nv = VPL ? VPL : (cols + 31) / 32;
  const size_t plane = static_cast<size_t>(p.rows) * cols;  // one slot
  const size_t off = static_cast<size_t>(row) * cols + lane;
  const float* d = p.d1 + off;
  float* rec = p.rec1 + off;
  Row<VPL> w;
  if constexpr (VPL == 0) w.v = shared_row + lane;
  float dn[VPL ? VPL : 1];  // the next slot's delta row (registers only)
#pragma unroll
  for (int i = 0; i < nv; ++i) {
    const bool ok = in_row<kAll>(lane, i, cols);
    w[i] = ok ? p.w1[off + 32 * i] : 0.0f;
    if constexpr (VPL > 0) dn[i] = ok ? __ldg(d + 32 * i) : 0.0f;
  }
  for (int s = 0; s < p.n_real; ++s) {
    const float nw = -wt[s];
    const float* ds = d + s * plane;
    const int r = kReps ? rp[s] : 1;
    // the next slot's delta row goes to dn once this slot's last axpy has
    // read it
    const bool next = VPL > 0 && s + 1 < p.n_real;
    if (r == 0 && next) load_row<VPL, kAll>(dn, ds + plane, lane, cols);
    for (int k = 0; k < r; ++k) {
#pragma unroll
      for (int i = 0; i < nv; ++i) {  // Eq. (4) on this row
        const bool ok = in_row<kAll>(lane, i, cols);
        float dv;
        if constexpr (VPL > 0) {
          dv = dn[i];
        } else {
          dv = ok ? __ldg(ds + 32 * i) : 0.0f;
        }
        w[i] = ok ? __fadd_rn(__fmul_rn(nw, dv), w[i]) : 0.0f;
      }
      if (k + 1 == r && next) load_row<VPL, kAll>(dn, ds + plane, lane, cols);
      feature_pass_row<VPL, kAll>(w, nv, lane, cols, p.normalize);
    }
    float* rs = rec + s * plane;
#pragma unroll
    for (int i = 0; i < nv; ++i)
      if (in_row<kAll>(lane, i, cols)) rs[32 * i] = w[i];
  }
  for (int s = p.n_real; s < p.S; ++s) {
    float* rs = rec + s * plane;
#pragma unroll
    for (int i = 0; i < nv; ++i)
      if (in_row<kAll>(lane, i, cols)) rs[32 * i] = w[i];
  }
#pragma unroll
  for (int i = 0; i < nv; ++i)
    if (in_row<kAll>(lane, i, cols)) p.w1_out[off + 32 * i] = w[i];
}

// One element of a leaf other than the first layer through the whole tick.
template <bool kReps>
__device__ void fold_elem(const FoldParams& p, const float* wt,
                          const int* rp, int L, size_t e) {
  const size_t stride = static_cast<size_t>(p.numel[L]);
  const float* dp = p.d[L] + e;
  float* out = p.rec[L] + e;
  float w = p.w[L][e];
  for (int s0 = 0; s0 < p.n_real; s0 += kBatch) {
    float dv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      dv[u] = s0 + u < p.n_real ? __ldg(dp + (s0 + u) * stride) : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s0 + u < p.n_real) {
        const int r = kReps ? rp[s0 + u] : 1;
        for (int k = 0; k < r; ++k)
          w = __fadd_rn(__fmul_rn(-wt[s0 + u], dv[u]), w);
        out[(s0 + u) * stride] = w;
      }
    }
  }
  for (int s = p.n_real; s < p.S; ++s) out[s * stride] = w;
  p.w_out[L][e] = w;
}

// The two phases of the cluster barrier, split so that work runs between
// a block's arrival and its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <int VPL, bool kAll, bool kReps>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
feature_fold_tick(const FoldParams p) {
  // [S] the weight stream, [S] the slots' clients, [S] their new counts,
  // [S] their fold counts; then, for VPL = 0, the row
  extern __shared__ float dyn[];
  __shared__ float sh[kWarps];
  __shared__ float part, total;
  float* wt = dyn;
  int* ix = reinterpret_cast<int*>(dyn + p.S);
  float* nv = dyn + 2 * p.S;
  int* rp = reinterpret_cast<int*>(dyn + 3 * p.S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. this block's eighth of N'_0 = sum(n), published to the cluster
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int chunk = (p.n_len + kCluster - 1) / kCluster;
  const int lo = static_cast<int>(cluster.block_rank()) * chunk;
  const int hi = min(p.n_len, lo + chunk);
  float acc = 0.0f;
  for (int k = lo + tid; k < hi; k += kThreads) acc += p.n[k];
  acc = block_sum(acc, sh);
  if (tid == 0) part = acc;
  cluster_arrive();

  // 2. this block's slice of the post-tick counts starts as n; the slots'
  //    clients, new counts and fold counts go to shared memory
  const int chunk2 = (p.n_len + gridDim.x - 1) / gridDim.x;
  const int lo2 = blockIdx.x * chunk2, hi2 = min(p.n_len, lo2 + chunk2);
  for (int k = lo2 + tid; k < hi2; k += kThreads) p.n_out[k] = p.n[k];
  for (int s = tid; s < p.n_real; s += kThreads) {
    const long long k = p.idx[s];
    if (k < 0 || k >= p.n_len) __trap();  // as index_copy's bounds check
    ix[s] = static_cast<int>(k);
    nv[s] = p.n_vis[s];
    if constexpr (kReps) {
      const int r = p.reps[s];
      if (r < 0 || r > 2) __trap();  // a fold count is 0, 1 or 2
      rp[s] = r;
    }
  }
  __syncthreads();

  // 3. per slot, the increment of N' (n_vis_s minus the count it replaces:
  //    the latest earlier folding write of its client in this tick, else
  //    n[k]; 0 for a slot that does not fold, and a second fold of the
  //    same slot replaces n_vis_s by itself); the last folding write of
  //    each client lands in its block's slice of n_out
  for (int s = tid; s < p.n_real; s += kThreads) {
    const int k = ix[s];
    const bool folds = !kReps || rp[s] > 0;
    int prev = -1;
    bool last = true;
    for (int j = 0; j < p.n_real; ++j) {
      const bool same = ix[j] == k && (!kReps || rp[j] > 0);
      prev = j < s && same ? j : prev;
      last = last && !(j > s && same);
    }
    wt[s] = folds ? nv[s] - (prev >= 0 ? nv[prev] : p.n[k]) : 0.0f;
    if (folds && last && k >= lo2 && k < hi2) p.n_out[k] = nv[s];
  }

  // 4. the cluster's partial sums, in rank order, through distributed
  //    shared memory; then N'_s = N'_0 + the inclusive prefix sum of the
  //    increments (warp 0, a contiguous chunk a lane) and
  //    weight_s = n_vis_s / max(N'_s, 1e-9)
  cluster_wait();
  if (tid == 0) {
    float t = 0.0f;
    for (int r = 0; r < kCluster; ++r) t += *cluster.map_shared_rank(&part, r);
    total = t;
  }
  cluster_arrive();  // this block is done reading the others' parts
  __syncthreads();
  if (warp == 0) {
    const int c = (p.n_real + 31) / 32;
    const int a = min(p.n_real, lane * c), b = min(p.n_real, a + c);
    float run = 0.0f;
    for (int s = a; s < b; ++s) run += wt[s];
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const float excl = __shfl_up_sync(kFull, incl, 1);
    float N = total + (lane == 0 ? 0.0f : excl);
    for (int s = a; s < b; ++s) {
      N += wt[s];
      wt[s] = __fdiv_rn(nv[s], fmaxf(N, 1e-9f));
    }
  }
  __syncthreads();

  if (static_cast<int>(blockIdx.x) < p.rows) {
    // one row a block, so that no SM carries more than one row's loads
    // and stores; the block's other warps have nothing left to do
    if (warp == 0)
      fold_row<VPL, kAll, kReps>(p, wt, rp, blockIdx.x, lane,
                                 dyn + 4 * p.S);
  } else {
    int L = 0;
    while (L < p.n_leaves && static_cast<int>(blockIdx.x) >= p.block_end[L])
      ++L;
    // L == n_leaves: a block that pads the grid to whole clusters
    const int b0 = L == 0 ? p.rows : p.block_end[L - 1];
    const size_t e = static_cast<size_t>(blockIdx.x - b0) * kThreads + tid;
    if (L < p.n_leaves && e < static_cast<size_t>(p.numel[L]))
      fold_elem<kReps>(p, wt, rp, L, e);
  }
  // no block leaves while another may still read its part
  cluster_wait();
}

template <int VPL>
int launch_fold(const FoldParams& p, int grid, size_t smem,
                cudaStream_t stream) {
  // every lane's VPL values are columns: no masks
  const bool all = VPL > 0 && p.cols == 32 * VPL;
  auto kernel = p.reps ? (all ? feature_fold_tick<VPL, true, true>
                              : feature_fold_tick<VPL, false, true>)
                       : (all ? feature_fold_tick<VPL, true, false>
                              : feature_fold_tick<VPL, false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  The leaf arrays are host arrays of n_leaves
// entries; every tensor is contiguous fp32 on the current device but idx
// (int64) and reps (int32, or null: every real slot folds once).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it refuses).
extern "C" int feature_fold_launch(
    int n_leaves, const void* const* w, const void* const* d,
    void* const* w_out, void* const* rec, const int* numel, int first,
    int rows, int cols, const void* n, void* n_out, int n_len,
    const void* idx, const void* n_vis, const void* reps, int S, int n_real,
    int normalize, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || first < 0 ||
      first >= n_leaves || rows < 1 || cols < 1 || n_len < 1 ||
      n_real < 1 || n_real > S || numel[first] != rows * cols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vpl = cols <= 32    ? 1
                  : cols <= 64  ? 2
                  : cols <= 128 ? 4
                  : cols <= 256 ? 8
                  : cols <= 512 ? 16
                  : cols <= 1024 ? 32
                                 : 0;
  FoldParams p{};
  p.n_leaves = n_leaves;
  p.rows = rows;
  p.cols = cols;
  p.n_len = n_len;
  p.S = S;
  p.n_real = n_real;
  p.normalize = normalize;
  p.n = static_cast<const float*>(n);
  p.n_out = static_cast<float*>(n_out);
  p.idx = static_cast<const long long*>(idx);
  p.n_vis = static_cast<const float*>(n_vis);
  p.reps = static_cast<const int*>(reps);
  p.w1 = static_cast<const float*>(w[first]);
  p.d1 = static_cast<const float*>(d[first]);
  p.w1_out = static_cast<float*>(w_out[first]);
  p.rec1 = static_cast<float*>(rec[first]);
  long long blocks = rows;  // one block a first-layer row
  for (int L = 0; L < n_leaves; ++L) {
    p.w[L] = static_cast<const float*>(w[L]);
    p.d[L] = static_cast<const float*>(d[L]);
    p.w_out[L] = static_cast<float*>(w_out[L]);
    p.rec[L] = static_cast<float*>(rec[L]);
    p.numel[L] = numel[L];
    if (numel[L] < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (L != first) blocks += (numel[L] + kThreads - 1) / kThreads;
    p.block_end[L] = static_cast<int>(blocks);
  }
  const long long grid = (blocks + kCluster - 1) / kCluster * kCluster;
  // four (S,) arrays, and a wide row padded to whole warps' columns
  const size_t smem = sizeof(float) *
      (4ULL * S + (vpl ? 0 : (cols + 31) / 32 * 32ULL));
  if (grid >= (1LL << 31) || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(grid);
  switch (vpl) {
    case 1: return launch_fold<1>(p, g, smem, s);
    case 2: return launch_fold<2>(p, g, smem, s);
    case 4: return launch_fold<4>(p, g, smem, s);
    case 8: return launch_fold<8>(p, g, smem, s);
    case 16: return launch_fold<16>(p, g, smem, s);
    case 32: return launch_fold<32>(p, g, smem, s);
    default: return launch_fold<0>(p, g, smem, s);
  }
}
