// Linear recurrence h_t = a_t * h_{t-1} + b_t, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/linear_scan/kernel.py::linear_scan_kernel
//   (body _scan_kernel).
//
// Computes, for (B, S, C) row-major inputs, from a zero carry and in fp32:
//   h[b, s, c] = a[b, s, c * a_cstride] * h[b, s - 1, c] + b[b, s, c]
//   h_last[b, c] = h[b, S - 1, c]
// and stores both in the input dtype (fp32 or bf16).  a_cstride is 1 for
// a full (B, S, C) coefficient tensor and 0 for (B, S, 1) coefficients
// broadcast over the channels: the engine's server fold passes its (S,)
// per-arrival coefficients that way, without building a (1, S, C) copy.
//
// Bound: bytes.  Each element of b is read once and each of h written
// once, with one multiply and one add between them, far below the card's
// operations-per-byte balance.  On the engine's fold the leaves are small
// (the LSTM's w_h at hidden 64 is 64 x 16384 fp32, 8.4 MB) and a launch
// costs about as much as its bytes.
//
// Design: one thread per (b, c) channel, a sequential fp32 loop over S,
// neighbouring threads on neighbouring channels so every load and store
// of a step is coalesced.  The loop loads kUnroll steps of a and b into
// registers before it computes them, so a thread keeps that many loads in
// flight instead of waiting out one memory latency per step.  The TPU
// kernel's chunked Hillis-Steele doubling scan is a VMEM tiling idiom and
// is not carried over: it would trade this loop's S dependent steps for
// log S passes of extra work, which pays only when S is long and C too
// narrow to fill the card (later work).
//
// The multiply and the add are rounded separately (__fmul_rn, __fadd_rn:
// no fused multiply-add), as PyTorch's elementwise a * h + b rounds them,
// so in fp32 the kernel reproduces the plain version bit for bit.
//
// The backward entry (linear_scan_backward_launch) replaces no TPU kernel:
// the JAX package's Pallas scan has no VJP and it trains on XLA's scans.
// The port trains along its one scan route, so the recurrence gets its
// reverse here.  For fp32 (B, S, C) a, the forward's h and the gradients
// dh (B, S, C) and dh_last (B, C) (null: zero), from the zero carry:
//   g[S-1] = dh[S-1] + dh_last,  g[t] = dh[t] + a[t+1] * g[t+1]
//   db[t] = g[t],  da[t] = g[t] * h[t-1]  (h[-1] = 0)
// It is the same recurrence walked down S, with the same design: one
// thread per channel, neighbouring threads on neighbouring channels,
// kUnroll steps of a, h[t-1] and dh loaded before they are computed.
// Bound: bytes, 3 tensors read and 2 written with 3 operations an
// element.  Each product and sum is rounded on its own, as autograd of
// the plain loop rounds them, so it is bit for bit the plain reverse loop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_channels(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ h, T* __restrict__ h_last, int S,
                     int C, int a_cstride) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t bi = blockIdx.y;
  const size_t a_step = a_cstride ? static_cast<size_t>(C) : 1;
  const T* ap = a + bi * static_cast<size_t>(S) * a_step +
                static_cast<size_t>(c) * a_cstride;
  const size_t base = bi * static_cast<size_t>(S) * C + c;
  const T* bp = b + base;
  T* hp = h + base;

  float carry = 0.0f;
  for (int s0 = 0; s0 < S; s0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u < S) {
        av[u] = load_f32(ap + static_cast<size_t>(s0 + u) * a_step);
        bv[u] = load_f32(bp + static_cast<size_t>(s0 + u) * C);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u < S) {
        carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
        store(hp + static_cast<size_t>(s0 + u) * C, carry);
      }
    }
  }
  store(h_last + bi * C + c, carry);
}

template <typename T>
int launch(const void* a, const void* b, void* h, void* h_last, int B, int S,
           int C, int a_cstride, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  linear_scan_channels<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<T*>(h_last), S, C, a_cstride);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
linear_scan_backward_channels(const float* __restrict__ a,
                              const float* __restrict__ h,
                              const float* __restrict__ dh,
                              const float* __restrict__ dh_last,
                              float* __restrict__ da, float* __restrict__ db,
                              int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t bi = blockIdx.y;
  const size_t base = bi * static_cast<size_t>(S) * C + c;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* dp = dh + base;
  float* dap = da + base;
  float* dbp = db + base;

  // g carries g[t + 1], a_next a[t + 1]; at t = S - 1 the carry is dh_last
  float g = 0.0f, a_next = 0.0f;
  const bool seeded = dh_last != nullptr;
  const float g_last = seeded ? dh_last[bi * C + c] : 0.0f;
  for (int hi = S - 1; hi >= 0; hi -= kUnroll) {
    float av[kUnroll], hv[kUnroll], dv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = hi - u;
      if (t >= 0) {
        av[u] = ap[static_cast<size_t>(t) * C];
        dv[u] = dp[static_cast<size_t>(t) * C];
        hv[u] = t > 0 ? hp[static_cast<size_t>(t - 1) * C] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = hi - u;
      if (t >= 0) {
        if (t == S - 1)
          g = seeded ? __fadd_rn(dv[u], g_last) : dv[u];
        else
          g = __fadd_rn(dv[u], __fmul_rn(g, a_next));
        dbp[static_cast<size_t>(t) * C] = g;
        dap[static_cast<size_t>(t) * C] = __fmul_rn(g, hv[u]);
        a_next = av[u];
      }
    }
  }
}

}  // namespace

// C entry for ctypes.  dtype: 0 = fp32, 1 = bf16 (a, b, h and h_last all
// of it).  a_cstride: 1 (a is (B, S, C)) or 0 (a is (B, S, 1)).  Launches
// on `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() so a refused launch surfaces in the caller.
extern "C" int linear_scan_launch(const void* a, const void* b, void* h,
                                  void* h_last, int B, int S, int C,
                                  int a_cstride, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return 0;
  if (B > 65535 || (a_cstride != 0 && a_cstride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, h_last, B, S, C, a_cstride, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h, h_last, B, S, C, a_cstride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry for ctypes: the backward, fp32 only, a full (B, S, C) a.
// dh_last may be null (a zero gradient of h_last).  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int linear_scan_backward_launch(const void* a, const void* h,
                                           const void* dh,
                                           const void* dh_last, void* da,
                                           void* db, int B, int S, int C,
                                           void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  linear_scan_backward_channels<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<const float*>(dh_last),
      static_cast<float*>(da), static_cast<float*>(db), S, C);
  return static_cast<int>(cudaGetLastError());
}
