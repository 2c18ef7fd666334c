// Selective scan of a Mamba-1 layer, fused into one kernel, hand-written for
// Hopper (sm_90a).
//
// Replaces the JAX package's default Mamba scan,
//   src/repro/models/ssm.py::_fused_chunk_scan (scan_impl="xla"; XLA, it has
//   no Pallas kernel),
// and on the port's prefill the linear-recurrence kernel at the Mamba shape,
//   src/repro/kernels/linear_scan/kernel.py:56 (linear_scan_kernel),
// together with the (B, S, d_inner, N) coefficient passes around it
// (models/ssm.py::_ssm_coeffs) and the C-projection after it.
//
// Computes, from a zero state, for b < B, s < S, d < di and n < N (N = 16):
//   dA  = exp(dt[b,s,d] * A[d,n])
//   dBx = (dt[b,s,d] * B[b,s,n]) * x[b,s,d]
//   h   = dA * h + dBx                       (h[b,s,d,n])
//   y[b,s,d]      = sum_n h[b,s,d,n] * C[b,s,n]
//   h_last[b,d,n] = h[b,S-1,d,n]
// x (B, S, di) and bc (B, S, 2N) in the model's dtype (fp32 or bf16; B is
// bc's columns [0, N), C its columns [N, 2N)), dt (B, S, di) and A (di, N)
// fp32; y (B, S, di) and h_last (B, di, N) fp32.  Everything inside is fp32.
// No (B, S, di, N) tensor exists: dA, dBx and h live in registers.
//
// Rounding: expf (not __expf) of the rounded product, and every other
// product and sum rounded on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), as the plain version's separate PyTorch ops round them;
// y is summed over n in order, y = h_0 C_0, then y + h_n C_n, as the
// plain version sums it.  So y and h_last are bit for bit the plain
// version's.  (A chain of fused multiply-adds for y, one instruction an
// element fewer, left rows of y 1.5e-6 of their largest value from the
// plain version's einsum on an H100: its order is cuBLAS's.)
//
// Bound (Falcon-Mamba-7B's prefill, B 8, S 2016, di 8192, N 16: 2.114e9
// elements (b, s, d, n)), the larger of:
// * bytes: x 264 MB (bf16), dt 528 MB, y 528 MB, bc, A and h_last 6 MB:
//   1.33 GB, 0.40 ms at 3.35 TB/s;
// * the SFU: one MUFU.EX2 an element (inside expf) at 16 a clock an SM:
//   0.51 ms at 1.98 GHz on 132 SMs;
// * the fp32 pipe: the compiled step loop issues 13 FP32-pipe
//   instructions an element (expf's range reduction and scaling, 6, and
//   dt*A, dt*B, *x, dA*h, +dBx, h*C, +y), 128 a clock an SM: 0.82 ms.
//   chip_smoke.py reads the step loop's instructions from the SASS and
//   computes the bound from that count.
// So the operations bind, on the fp32 pipe, not the bytes.  Every
// instruction also takes an issue slot (one warp instruction a clock per
// scheduler, 4 an SM), which puts the loop's ~17 instructions an element
// (the fp32 ones, the MUFU, expf's integer shift as an IMAD, the
// shared-memory loads of B and C) at ~1.05 ms.
//
// Design: one thread per (b, d) channel holds its N = 16 states and its
// 16 values of A[d, :] in registers and walks S in order: B x di = 65,536
// channels at the prefill fill the card (3.9 blocks of 128 threads an SM),
// and the N independent exp/multiply chains of a step give each thread
// instruction-level parallelism, so no parallel scan along S is needed.
// All threads of a block share one b, so a step's 2N values of B and C are
// common to the block: a stage of kChunk steps of bc, and of the block's
// dt and x tiles (kChunk x 128 channels), is copied into shared memory
// with 16-byte cp.async, double-buffered (the next stage's copy runs while
// this one is computed), and B and C are converted to fp32 once a stage
// for the block; a step then reads them as broadcast 16-byte shared loads
// and the dependent chain never waits on device memory.  y is written
// each step, 128 threads x 4 B contiguous: coalesced.  h_last is written
// once, 64 B a thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kN = 16;         // state size (Mamba-1's)
constexpr int kThreads = 128;  // channels a block
constexpr int kChunk = 8;      // steps a shared-memory stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

template <typename T>
struct __align__(16) Stage {
  float dt[kChunk][kThreads];
  T x[kChunk][kThreads];
  T bc[kChunk][2 * kN];
};

// the copies of stage c (steps c * kChunk ...) into `st`, one commit group
template <typename T>
__device__ __forceinline__ void load_stage(Stage<T>& st, const T* x,
                                           const float* dt, const T* bc,
                                           size_t row0, int s0, int S,
                                           int d0, int di, int tid) {
  constexpr int kDtPer = 16 / sizeof(float);
  constexpr int kDtPieces = kThreads / kDtPer;  // 16-byte pieces a row
  for (int p = tid; p < kChunk * kDtPieces; p += kThreads) {
    const int r = p / kDtPieces, col = (p % kDtPieces) * kDtPer;
    const bool ok = s0 + r < S && d0 + col < di;
    cp_async16(&st.dt[r][col],
               ok ? dt + (row0 + s0 + r) * di + d0 + col : dt, ok);
  }
  constexpr int kXPer = 16 / sizeof(T);
  constexpr int kXPieces = kThreads / kXPer;
  for (int p = tid; p < kChunk * kXPieces; p += kThreads) {
    const int r = p / kXPieces, col = (p % kXPieces) * kXPer;
    const bool ok = s0 + r < S && d0 + col < di;
    cp_async16(&st.x[r][col], ok ? x + (row0 + s0 + r) * di + d0 + col : x,
               ok);
  }
  // the stage's bc rows are contiguous in device memory: 2N values a row
  constexpr int kBcPer = 16 / sizeof(T);
  constexpr int kBcPieces = kChunk * 2 * kN / kBcPer;
  for (int p = tid; p < kBcPieces; p += kThreads) {
    const bool ok = s0 + p * kBcPer / (2 * kN) < S;
    cp_async16(&st.bc[0][0] + p * kBcPer,
               ok ? bc + (row0 + s0) * (2 * kN) + p * kBcPer : bc, ok);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ bc,
                   float* __restrict__ y, float* __restrict__ h_last, int S,
                   int di) {
  __shared__ Stage<T> st[2];
  __shared__ __align__(16) float bcf[kChunk][2 * kN];

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const bool live = d < di;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * S;  // row (b, 0)

  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * kN + n] : 0.0f;
    h[n] = 0.0f;
  }

  const int n_stages = (S + kChunk - 1) / kChunk;
  load_stage(st[0], x, dt, bc, row0, 0, S, d0, di, tid);
  for (int c = 0; c < n_stages; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_stages) {
      load_stage(st[buf ^ 1], x, dt, bc, row0, (c + 1) * kChunk, S, d0, di,
                 tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int i = tid; i < kChunk * 2 * kN; i += kThreads)
      bcf[i / (2 * kN)][i % (2 * kN)] =
          to_f32(st[buf].bc[i / (2 * kN)][i % (2 * kN)]);
    __syncthreads();

    const int s0 = c * kChunk;
    const int steps = min(kChunk, S - s0);
    float* yp = y + (row0 + s0) * di + d;
    for (int t = 0; t < steps; ++t) {
      const float dtv = st[buf].dt[t][tid];
      const float xv = to_f32(st[buf].x[t][tid]);
      const float4* bq = reinterpret_cast<const float4*>(&bcf[t][0]);
      float Bv[kN], Cv[kN];
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 bb = bq[q], cc = bq[kN / 4 + q];
        Bv[4 * q] = bb.x; Bv[4 * q + 1] = bb.y;
        Bv[4 * q + 2] = bb.z; Bv[4 * q + 3] = bb.w;
        Cv[4 * q] = cc.x; Cv[4 * q + 1] = cc.y;
        Cv[4 * q + 2] = cc.z; Cv[4 * q + 3] = cc.w;
      }
      float yv = 0.0f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float dA = expf(__fmul_rn(dtv, a[n]));
        const float dBx = __fmul_rn(__fmul_rn(dtv, Bv[n]), xv);
        h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
        const float hc = __fmul_rn(h[n], Cv[n]);
        yv = n == 0 ? hc : __fadd_rn(yv, hc);
      }
      if (live) yp[static_cast<size_t>(t) * di] = yv;
    }
    __syncthreads();  // the next stage's copy overwrites this buffer
  }
  if (live) {
    float4* hp = reinterpret_cast<float4*>(
        h_last + (static_cast<size_t>(blockIdx.y) * di + d) * kN);
#pragma unroll
    for (int q = 0; q < kN / 4; ++q)
      hp[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* bc,
           void* y, void* h_last, int B, int S, int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  selective_scan_fwd<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bc),
      static_cast<float*>(y), static_cast<float*>(h_last), S, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  dtype (of x and bc): 0 = fp32, 1 = bf16; dt, A, y
// and h_last are fp32.  N must be 16 and di a multiple of 8, every
// pointer 16-byte aligned (the wrapper checks).  Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch surfaces in the caller.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* bc, void* y,
                                     void* h_last, int B, int S, int di,
                                     int N, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  if (N != kN || B > 65535 || di % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, bc, y, h_last, B, S, di, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, bc, y, h_last, B, S, di, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
