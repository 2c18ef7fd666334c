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
// once, 64 B a thread.  Under grad (h_chunks not null, a second instance
// of the kernel, so serving's code is unchanged) the state before each
// chunk of c = min(256, S) halved until it divides S steps is written
// too, 64 B a thread a chunk: what JAX's lax.scan keeps of its
// checkpointed chunk body.
//
// The backward (selective_scan_bwd) replaces what XLA's autodiff derives
// through that checkpointed body: from the gradients gy of y and gh_last
// of h_last, per (b, d) channel, chunks last to first and steps in
// reverse,
//   g_t   = gy_t C_t + dA_{t+1} g_{t+1}          (from gh_last)
//   dx_t  = sum_n g_t (dt_t B_t)
//   ddt_t = sum_n ((g_t h_{t-1}) dA_t) A + (g_t x_t) B_t
//   dA   += ((g_t h_{t-1}) dA_t) dt_t            (over b and t)
//   dB_t  = sum_d (g_t x_t) dt_t,  dC_t = sum_d gy_t h_t
// with every product and sum rounded alone, the sums over n in order and
// dA's over t in the walk's order, as the plain version (ref.py) rounds
// them: dx, ddt and dA are bit for bit its own; dB and dC are sums over
// channels in another order.
// Design: one thread a channel, as the forward.  A chunk's states are
// first recomputed from its carry exactly as the forward built them
// (the same instructions: bit for bit) into a scratch of one chunk (B, c,
// N, di) fp32 in device memory, state n of step j at (j N + n) di + d,
// so a warp's 16 stores a step are coalesced rows; then the reverse walk
// reads them back.  Both walks stage dt, x (and gy) and bc a kChunk-step
// stage at a time with cp.async, double-buffered across the two walks
// and the chunks.  dB and dC, 32 sums over the block's channels a step,
// are reduced in registers with a transposed butterfly (31 shuffles a
// warp for the 32 sums: lane l ends with sum l), the block's 4 warps'
// partials in order in shared memory, one partial a block written out;
// dA's are the thread's own sums over its steps, one partial a (b, d).
// The wrapper sums the partials over their block axis (torch.sum): a
// fixed order, no atomics, deterministic.
//
// Bound of the backward (train_step_mamba_long's scan, B 8, S 2048, di
// 8192, N 16: 2.147e9 elements; chip_smoke.py's bound_detail reads the
// counts from the SASS each run), the larger of:
// * bytes: x, dt, gy, dx, ddt 537 MB each, the carries 34 MB, bc, dbc, A
//   and dA 4 MB: 2.72 GB, 0.81 ms at 3.35 TB/s; the design's scratch
//   adds 2 x 8.59 GB (each state written once, read once): 5.94 ms;
// * the SFU: two MUFU.EX2 an element (the recompute's exp and the
//   reverse walk's): 1.03 ms;
// * the fp32 pipe: 40.7 FP32-pipe instructions an element over the two
//   loops (11.0 in the recompute, 29.7 in the reverse walk: its 12
//   products and sums, expf's 6, the butterfly's selects and adds): 2.61
//   ms.  The issue limit, 78 instructions an element, is 5.0 ms: the
//   instructions, and the scratch's bytes, bind this simple design.

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

// the N states of channel `row` (b, d): 64 contiguous bytes at row * N
__device__ __forceinline__ void store_state(float* out, size_t row,
                                            const float* h) {
  float4* p = reinterpret_cast<float4*>(out + row * kN);
#pragma unroll
  for (int q = 0; q < kN / 4; ++q)
    p[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
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

template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ bc,
                   float* __restrict__ y, float* __restrict__ h_last,
                   float* __restrict__ h_chunks, int S, int di, int chunk) {
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

  // kSave: the state before each `chunk` steps goes to h_chunks[b, k]
  int left = 0, k_chunk = 0;
  const int n_chunks = kSave ? S / chunk : 0;

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
      if constexpr (kSave) {
        if (left == 0) {
          if (live) store_state(h_chunks, (static_cast<size_t>(blockIdx.y) *
                                           n_chunks + k_chunk) * di + d, h);
          ++k_chunk;
          left = chunk;
        }
        --left;
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
  if (live) store_state(h_last, static_cast<size_t>(blockIdx.y) * di + d, h);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* bc,
           void* y, void* h_last, void* h_chunks, int B, int S, int di,
           int chunk, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  auto kernel = h_chunks ? selective_scan_fwd<T, true>
                         : selective_scan_fwd<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bc),
      static_cast<float*>(y), static_cast<float*>(h_last),
      static_cast<float*>(h_chunks), S, di, chunk);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The backward: the gradients of y and h_last -> those of x, dt, A and bc
// ---------------------------------------------------------------------------

template <int kRows>
struct __align__(16) BwdStage {
  float dt[kRows][kThreads];
  float x[kRows][kThreads];
  float gy[kRows][kThreads];
  float bc[kRows][2 * kN];
};

// the copies of steps [s0, s0 + n) of batch row `row0` into `st`, one
// commit group; gy only where `with_gy` (the reverse walk)
__device__ __forceinline__ void load_bwd_stage(
    BwdStage<kChunk>& st, const float* x, const float* dt, const float* gy,
    const float* bc, size_t row0, int s0, int n, int d0, int di, int tid,
    bool with_gy) {
  constexpr int kPer = 4;  // floats a 16-byte piece
  constexpr int kPieces = kThreads / kPer;
  for (int p = tid; p < kChunk * kPieces; p += kThreads) {
    const int r = p / kPieces, col = (p % kPieces) * kPer;
    const bool ok = r < n && d0 + col < di;
    const size_t off = ok ? (row0 + s0 + r) * di + d0 + col : 0;
    cp_async16(&st.dt[r][col], dt + off, ok);
    cp_async16(&st.x[r][col], x + off, ok);
    if (with_gy) cp_async16(&st.gy[r][col], gy + off, ok);
  }
  constexpr int kBcPieces = kChunk * 2 * kN / kPer;
  for (int p = tid; p < kBcPieces; p += kThreads) {
    const bool ok = p * kPer / (2 * kN) < n;
    cp_async16(&st.bc[0][0] + p * kPer,
               bc + (ok ? (row0 + s0) * (2 * kN) + p * kPer : 0), ok);
  }
  cp_async_commit();
}

// Stage i of a block's walk: chunks last to first, each first forward
// (recomputing its states into the scratch) in stages of kChunk steps,
// then in reverse
struct StageAt {
  int s0, n, j0, k;
  bool rev;
};
__device__ __forceinline__ StageAt stage_at(int i, int n_sub, int n_chunks,
                                            int chunk) {
  const int k = n_chunks - 1 - i / (2 * n_sub);
  const int w = i % (2 * n_sub);
  const bool rev = w >= n_sub;
  const int j0 = (rev ? 2 * n_sub - 1 - w : w) * kChunk;
  return {k * chunk + j0, min(kChunk, chunk - j0), j0, k, rev};
}

// v[i] of each lane -> in lane l, the sum over the warp's lanes of v[l]:
// five butterfly steps (kOff = 16, 8, 4, 2, 1), each halving the values a
// lane keeps, 31 shuffles for 32 sums, in a fixed order
template <int kOff>
__device__ __forceinline__ void transpose_sum_step(float (&v)[2 * kN],
                                                   int lane) {
  const bool upper = lane & kOff;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
  if constexpr (kOff > 1) transpose_sum_step<kOff / 2>(v, lane);
}

__global__ void __launch_bounds__(kThreads)
selective_scan_bwd(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ bc,
                   const float* __restrict__ h_chunks,
                   const float* __restrict__ gy,
                   const float* __restrict__ gh_last, float* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ dA_part,
                   float* __restrict__ dbc_part, float* __restrict__ scratch,
                   int B, int S, int di, int chunk) {
  constexpr int kWarps = kThreads / 32;
  __shared__ BwdStage<kChunk> st[2];
  __shared__ float red[kChunk][kWarps][2 * kN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const bool live = d < di;
  const int b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * S;  // row (b, 0)
  const int n_chunks = S / chunk;
  const int n_sub = (chunk + kChunk - 1) / kChunk;  // stages a chunk way
  const int n_stages = n_chunks * 2 * n_sub;
  // the chunk's states: state n before step j at scr[(j * N + n) * di]
  float* scr = scratch + static_cast<size_t>(b) * chunk * kN * di + d;

  // h: the state (the recompute's running one; in the reverse walk the
  // state after the step); r: dA_{t+1} g_{t+1}, the gradient reaching h_t
  // from the step after it (gh_last at the end); dAs: this channel's
  // gradient of A over its steps
  float a[kN], h[kN], r[kN], dAs[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = live ? A[static_cast<size_t>(d) * kN + n] : 0.0f;
    r[n] = live && gh_last
               ? gh_last[(static_cast<size_t>(b) * di + d) * kN + n]
               : 0.0f;
    h[n] = 0.0f;
    dAs[n] = 0.0f;
  }

  StageAt nxt = stage_at(0, n_sub, n_chunks, chunk);
  load_bwd_stage(st[0], x, dt, gy, bc, row0, nxt.s0, nxt.n, d0, di, tid,
                 nxt.rev);
  for (int i = 0; i < n_stages; ++i) {
    const int buf = i & 1;
    const StageAt sg = nxt;
    if (i + 1 < n_stages) {
      nxt = stage_at(i + 1, n_sub, n_chunks, chunk);
      load_bwd_stage(st[buf ^ 1], x, dt, gy, bc, row0, nxt.s0, nxt.n, d0, di,
                     tid, nxt.rev);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const BwdStage<kChunk>& cur = st[buf];
    if (!sg.rev) {
      // recompute the chunk's states from its carry, as the forward
      if (sg.j0 == 0) {
        const float4* hp = reinterpret_cast<const float4*>(
            h_chunks + ((static_cast<size_t>(b) * n_chunks + sg.k) * di + d) *
                           kN);
#pragma unroll
        for (int q = 0; q < kN / 4; ++q) {
          const float4 v = live ? hp[q] : make_float4(0.f, 0.f, 0.f, 0.f);
          h[4 * q] = v.x; h[4 * q + 1] = v.y;
          h[4 * q + 2] = v.z; h[4 * q + 3] = v.w;
        }
      }
      for (int t = 0; t < sg.n; ++t) {
        const float dtv = cur.dt[t][tid];
        const float xv = cur.x[t][tid];
        const float* Bv = &cur.bc[t][0];
        float* sp = scr + static_cast<size_t>(sg.j0 + t) * kN * di;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          if (live) sp[static_cast<size_t>(n) * di] = h[n];
          const float dA = expf(__fmul_rn(dtv, a[n]));
          const float dBx = __fmul_rn(__fmul_rn(dtv, Bv[n]), xv);
          h[n] = __fadd_rn(__fmul_rn(dA, h[n]), dBx);
        }
      }
    } else {
      for (int t = sg.n - 1; t >= 0; --t) {
        const float dtv = cur.dt[t][tid];
        const float xv = cur.x[t][tid];
        const float gyv = cur.gy[t][tid];
        const float* Bv = &cur.bc[t][0];
        const float* Cv = &cur.bc[t][kN];
        const float* sp = scr + static_cast<size_t>(sg.j0 + t) * kN * di;
        float hp[kN];  // the state before the step
#pragma unroll
        for (int n = 0; n < kN; ++n)
          hp[n] = live ? sp[static_cast<size_t>(n) * di] : 0.0f;
        float dxv = 0.0f, ddtv = 0.0f, v[2 * kN];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float dA = expf(__fmul_rn(dtv, a[n]));
          const float g = __fadd_rn(__fmul_rn(gyv, Cv[n]), r[n]);
          const float gu = __fmul_rn(g, __fmul_rn(dtv, Bv[n]));
          const float gx = __fmul_rn(g, xv);
          const float q = __fmul_rn(__fmul_rn(g, hp[n]), dA);
          const float term = __fadd_rn(__fmul_rn(q, a[n]),
                                       __fmul_rn(gx, Bv[n]));
          dxv = n == 0 ? gu : __fadd_rn(dxv, gu);
          ddtv = n == 0 ? term : __fadd_rn(ddtv, term);
          dAs[n] = __fadd_rn(dAs[n], __fmul_rn(q, dtv));
          v[n] = __fmul_rn(gx, dtv);           // this channel's dB
          v[kN + n] = __fmul_rn(gyv, h[n]);    // and dC
          r[n] = __fmul_rn(dA, g);
          h[n] = hp[n];
        }
        if (live) {
          const size_t o = (row0 + sg.s0 + t) * di + d;
          dx[o] = dxv;
          ddt[o] = ddtv;
        }
        transpose_sum_step<kN>(v, lane);
        red[t][warp][lane] = v[0];
      }
      __syncthreads();
      // the block's dB and dC of the stage's steps: its warps' partials in
      // order, one partial a block (the wrapper sums the blocks in order)
      float* out = dbc_part +
                   ((static_cast<size_t>(blockIdx.x) * B + b) * S + sg.s0) *
                       (2 * kN);
      for (int e = tid; e < sg.n * 2 * kN; e += kThreads) {
        const int t = e / (2 * kN), l = e % (2 * kN);
        float sum = red[t][0][l];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += red[t][w][l];
        out[e] = sum;
      }
    }
    __syncthreads();  // the next stage's copy overwrites this buffer
  }
  if (live) store_state(dA_part, static_cast<size_t>(b) * di + d, dAs);
}

}  // namespace

// C entry for ctypes.  dtype (of x and bc): 0 = fp32, 1 = bf16; dt, A, y,
// h_last and h_chunks are fp32.  h_chunks (B, S / chunk, di, N) gets the
// state before each `chunk` steps (the backward's carries); null skips
// it (serving), and the kernel is then the one without the store.  N
// must be 16, di a multiple of 8, chunk a divisor of S, every pointer
// 16-byte aligned (the wrapper checks).  Launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns cudaGetLastError()
// so a refused launch surfaces in the caller.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* A, const void* bc, void* y,
                                     void* h_last, void* h_chunks, int B,
                                     int S, int di, int N, int chunk,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  if (N != kN || B > 65535 || di % 8 != 0 ||
      (h_chunks && (chunk <= 0 || S % chunk != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, bc, y, h_last, h_chunks, B, S, di, chunk,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, bc, y, h_last, h_chunks, B, S, di,
                                 chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// C entry for ctypes of the backward, fp32 throughout: x, dt, A, bc and the
// forward's h_chunks (B, S / chunk, di, N), the gradient gy (B, S, di) of
// y and gh_last (B, di, N) of h_last (null: zero) -> dx and ddt (B, S,
// di), this block row's partials dA_part (B, di, N) and dbc_part
// (ceil(di / 128), B, S, 2N), which the caller sums over their first axis;
// scratch (B, chunk, N, di) holds one chunk's states.  N must be 16, di a
// multiple of 8, chunk a divisor of S, every pointer 16-byte aligned (the
// wrapper checks).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int selective_scan_backward_launch(
    const void* x, const void* dt, const void* A, const void* bc,
    const void* h_chunks, const void* gy, const void* gh_last, void* dx,
    void* ddt, void* dA_part, void* dbc_part, void* scratch, int B, int S,
    int di, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  if (N != kN || B > 65535 || di % 8 != 0 || chunk <= 0 || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  selective_scan_bwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bc),
      static_cast<const float*>(h_chunks), static_cast<const float*>(gy),
      static_cast<const float*>(gh_last), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA_part),
      static_cast<float*>(dbc_part), static_cast<float*>(scratch), B, S, di,
      chunk);
  return static_cast<int>(cudaGetLastError());
}
