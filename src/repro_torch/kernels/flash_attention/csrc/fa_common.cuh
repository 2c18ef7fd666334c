// Shared pieces of the two flash-attention kernels (fa_f32.cuh,
// fa_bf16.cuh): the launch arguments, the TPU kernel's tile-skip test,
// and cp.async.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace fa {

constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBK = 64;  // keys per KV tile, both kernels

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  void* out;
  int H, KV, Sq, Skv;
  float scale;
  int causal, window, contiguous;
};

// The KV tiles a block of query rows [q0, q_hi] visits: all of them,
// or with `contiguous` (positions == arange) those the TPU kernel's test
// keeps (kernel.py:68-84): causal needs k0 <= q_hi, a window needs
// k_hi > q0 - window.  Both tests are monotone in the tile index, so the
// kept tiles are one range [lo, hi] (empty when lo > hi).
struct TileRange {
  int lo, hi;
};

__device__ __forceinline__ TileRange tile_range(const Args& a, int q0,
                                                int q_hi) {
  const int n_kt = (a.Skv + kBK - 1) / kBK;
  TileRange r{0, n_kt - 1};
  if (!a.contiguous) return r;
  if (a.causal) r.hi = min(r.hi, q_hi / kBK);
  if (a.window > 0) {
    while (r.lo <= r.hi) {
      const int k_hi = min((r.lo + 1) * kBK, a.Skv) - 1;
      if (static_cast<long long>(k_hi) >
          static_cast<long long>(q0) - a.window)
        break;
      ++r.lo;
    }
  }
  return r;
}

// Per warp, for its live query rows [w_lo, w_hi] (w_hi >= w_lo) and the
// tile at k0.  `skip`: with contiguous causal positions every key of the
// tile lies above the diagonal of every row, so each score is -1e30 and
// adds exactly 0 (each row has already seen its own key, an earlier and
// finite maximum).  `full`: no score of the tile is masked and no key
// lies past Skv, so the mask test is left out.
__device__ __forceinline__ bool warp_skips(const Args& a, int k0, int w_hi) {
  return a.contiguous && a.causal && k0 > w_hi;
}
__device__ __forceinline__ bool tile_full(const Args& a, int k0, int w_lo,
                                          int w_hi) {
  if (!a.contiguous || k0 + kBK > a.Skv) return false;
  if (a.causal && k0 + kBK - 1 > w_lo) return false;
  if (a.window > 0 && static_cast<long long>(w_hi) - k0 >= a.window)
    return false;
  return true;
}

// 1 when the key at position kp is visible from the query at qp.
__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  bool ok = true;
  if (a.causal) ok = kp <= qp;
  if (a.window > 0)
    ok = ok && static_cast<long long>(qp) - kp < a.window;
  return ok;
}

// 2^x in one MUFU op (ex2.approx, about 2 ulp); results below 2^-126
// flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fa
