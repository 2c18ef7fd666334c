// Forward flash attention (online softmax; causal / sliding-window masks
// from absolute positions; GQA), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:95 flash_attention_kernel
//   (body _fa_kernel, kernel.py:30).
//
// Layout: the model's own, so no transpose copies are made around it:
//   q, out (B, Sq, H, hd)   with head h = kv * G + g  (H = KV * G)
//   k, v   (B, Skv, KV, hd)  head h reads KV head h / G by index
//   q_pos (B, Sq), k_pos (B, Skv) int32 absolute positions.
// Rows of hd elements are contiguous; fp32 or bf16 in, fp32 math,
// output in the input dtype.
//
// Semantics, as the TPU kernel's:
//   s = (q . k) * scale;  masked (causal: k_pos > q_pos; window > 0:
//   q_pos - k_pos >= window) scores are exactly -1e30, not -inf;
//   running max m (from -1e30), sum l (from 0) and accumulator in fp32;
//   out = acc / max(l, 1e-30).
// With `contiguous` (positions == arange, the prefill path) a KV tile
// that lies wholly above the diagonal or wholly outside the window is
// skipped, with the TPU kernel's tile test (kernel.py:68-84).  Keys past
// Skv in the ragged last tile get -inf, so they add exactly 0 (masked
// keys inside Skv add exp(-1e30 - m), also 0 once a row has seen one
// unmasked key).  A row whose keys are ALL masked therefore returns the
// mean of v over the in-range keys of the tiles it visited (all of them
// unless `contiguous` skipped some), as the TPU kernel does; the dense
// plain version returns the mean over all keys.  That row cannot occur
// on the prefill path: each query sees at least its own key.
//
// Bound at the main-path shape (TinyLlama-1.1B prefill: B=8, H=32, KV=4,
// Sq=Skv=2016, hd=64, causal, fp32): 8*32*2016*2017/2 = 5.205e8 unmasked
// (query, key) pairs at 4*hd = 256 FLOPs each = 1.33e11 FLOPs, 1.99 ms
// at the 67 TFLOP/s fp32 rate outside the tensor cores; the bytes (q and
// out 132 MB each, k and v 16.5 MB each, ~297 MB) take 0.089 ms at
// 3.35 TB/s.  So fp32 is bound by operations.  In bf16, against the
// 989 TFLOP/s of the tensor cores, the bound would be 0.135 ms.
//
// Design (first, simple and exact): one block of 256 threads per
// (q tile of 64 rows, head, batch); the KV axis, the TPU grid's
// sequential axis, is a loop inside the block.  Per 64-key tile: K, V
// and the key positions are staged in shared memory (converted to fp32),
// each thread computes a 4 x 4 block of scores with fp32 FMAs on the CUDA
// cores (rows ty + 16 i, keys tx + 16 j; 16-byte shared loads along hd),
// the row max and sum are reduced across the 16 threads of a row with
// warp shuffles, P goes through shared memory, and each thread
// accumulates 4 rows x hd/16 output columns.  No TF32: it would drift
// from the plain version.  Blocks run the heaviest causal q tiles first,
// and the G heads that share a KV head are neighbours in the grid, so
// their K/V tiles are read from L2.
//
// Left for later: mma.sync / wgmma tensor-core tiles for bf16 (and TF32
// where a caller accepts it), TMA-fed double-buffered K/V tiles with
// mbarriers, Q kept in registers, a split-KV variant for one-token
// decode, and hd other than 32 / 64 / 128 (kimi's 112, recurrentgemma's
// 256).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 (ty: row group) x 16 (tx: column group)
constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
static_assert(kBQ == kBK, "stage_tile stages 64-row tiles of Q, K and V");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  // round to nearest even, as torch's cast
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Output column of a thread's e-th value (e < HD / 16).  hd >= 64: runs
// of 4 at 4 * tx + 64 * (e / 4), so a warp's 16-byte shared loads of a V
// row are contiguous; hd = 32: pairs at 2 * tx.
template <int HD>
__device__ __forceinline__ int out_col(int tx, int e) {
  if constexpr (HD >= 64) return 64 * (e / 4) + 4 * tx + (e % 4);
  return 2 * tx + e;
}

// Stage rows [row0, row0 + 64) of a (rows, stride) matrix into shared
// memory as fp32 with row stride `dst_stride`; rows past `n_rows` are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, int dst_stride,
                                           const T* src, size_t src_stride,
                                           int row0, int n_rows) {
  constexpr int kChunks = HD / 4;  // 4-element chunks per row
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = load4(src + static_cast<size_t>(row0 + r) * src_stride + c);
    *reinterpret_cast<float4*>(dst + r * dst_stride + c) = val;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (HD + 4) + kBK * HD + kBQ * (kBK + 4)) +
         sizeof(int) * kBK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos, T* __restrict__ out,
                    int H, int KV, int Sq, int Skv, float scale, int causal,
                    int window, int contiguous) {
  constexpr int QS = HD + 4;   // padded row stride of Q and K tiles
  constexpr int PS = kBK + 4;  // padded row stride of the P tile
  constexpr int NV = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;  // row stride HD
  float* Ps = Vs + kBK * HD;
  int* Kp = reinterpret_cast<int*>(Ps + kBQ * PS);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.x;
  // the heaviest causal q tiles first
  const int q0 = static_cast<int>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  const int* qpb = q_pos + static_cast<size_t>(b) * Sq;
  const int* kpb = k_pos + static_cast<size_t>(b) * Skv;

  stage_tile<T, HD>(Qs, QS, qb, q_stride, q0, Sq);

  int qp[4];
  float m[4], l[4], acc[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    qp[i] = r < Sq ? qpb[r] : 0;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[i][e] = 0.f;
  }

  const int q_hi = min(q0 + kBQ, Sq) - 1;
  const int n_kt = (Skv + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (contiguous) {  // uniform over the block: positions == arange
      const int k_hi = min(k0 + kBK, Skv) - 1;
      bool needed = true;
      if (causal) needed = needed && k0 <= q_hi;
      if (window > 0)
        needed = needed && static_cast<long long>(k_hi) >
                               static_cast<long long>(q0) - window;
      if (!needed) continue;
    }
    __syncthreads();  // Q staged; the previous tile's K, V, P all read
    stage_tile<T, HD>(Ks, QS, kb, kv_stride, k0, Skv);
    stage_tile<T, HD>(Vs, HD, vb, kv_stride, k0, Skv);
    const int t = threadIdx.x;
    if (t < kBK) Kp[t] = k0 + t < Skv ? kpb[k0 + t] : 0;
    __syncthreads();

    // s = q . k over hd, in order, fp32 FMA
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, mask, online-softmax update; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float val;
        if (k0 + c >= Skv) {
          val = -CUDART_INF_F;  // past the sequence: adds exactly 0
        } else {
          const int kp = Kp[c];
          bool ok = true;
          if (causal) ok = kp <= qp[i];
          if (window > 0)
            ok = ok && static_cast<long long>(qp[i]) - kp < window;
          val = ok ? s[i][j] * scale : kMasked;
        }
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)  // the 16 lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // acc += P . V
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * HD;
        float vv[NV];
        if constexpr (HD >= 64) {
#pragma unroll
          for (int e = 0; e < NV; e += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + out_col<HD>(tx, e));
            vv[e] = t.x; vv[e + 1] = t.y; vv[e + 2] = t.z; vv[e + 3] = t.w;
          }
        } else {
          const float2 t =
              *reinterpret_cast<const float2*>(vrow + out_col<HD>(tx, 0));
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                        : cc == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int e = 0; e < NV; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + r) * H + h) * HD;
#pragma unroll
    for (int e = 0; e < NV; e += 2)
      store2(orow + out_col<HD>(tx, e), acc[i][e] / den, acc[i][e + 1] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* qp,
           const int* kp, void* out, int B, int H, int KV, int Sq, int Skv,
           float scale, int causal, int window, int contiguous,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_attention_fwd<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(H),
                  static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qp, kp, static_cast<T*>(out), H, KV, Sq, Skv,
      scale, causal, window, contiguous);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* qp, const int* kp, void* out, int B, int H, int KV,
              int Sq, int Skv, float scale, int causal, int window,
              int contiguous, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, qp, kp, out, B, H, KV, Sq, Skv, scale,
                           causal, window, contiguous, s);
    case 64:
      return launch<T, 64>(q, k, v, qp, kp, out, B, H, KV, Sq, Skv, scale,
                           causal, window, contiguous, s);
    case 128:
      return launch<T, 128>(q, k, v, qp, kp, out, B, H, KV, Sq, Skv, scale,
                            causal, window, contiguous, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry for ctypes.  dtype: 0 = fp32, 1 = bf16; hd in {32, 64, 128};
// H a multiple of KV; every pointer 16-byte aligned.  Launches on
// `stream` (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch surfaces in the caller.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* q_pos,
                                      const void* k_pos, void* out, int B,
                                      int H, int KV, int Sq, int Skv, int hd,
                                      float scale, int causal, int window,
                                      int contiguous, int dtype,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, qp, kp, out, B, H, KV, Sq, Skv,
                            scale, causal, window, contiguous, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, qp, kp, out, B, H, KV, Sq,
                                    Skv, scale, causal, window, contiguous,
                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}
