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
// with every product and sum rounded alone, dA's sum over t in the
// walk's order and the sums over n in the kernel's lane order (below),
// as the plain version (ref.py) rounds them: dx, ddt and dA are bit for
// bit its own; dB and dC are sums over channels in another order.
//
// Bound of the backward (train_step_mamba_long's scan, B 8, S 2048, di
// 8192, N 16: 2.147e9 elements), the function's own work, whatever the
// design (chip_smoke.py's selective_backward_bound):
// * bytes: x, dt, gy, dx, ddt 537 MB each, the carries 34 MB, bc, dbc, A
//   and dA 4 MB: 2.72 GB, 0.81 ms at 3.35 TB/s;
// * operations: the chunk's states recomputed once and the reverse walk,
//   23 rounded products and sums an element (dt A, dt B, (dt B) x,
//   dA h, + dBx; gy C, + r, g (dt B), + over n, g x, (g h) dA, q A,
//   (g x) B, +, + over n, q dt, + over t, (g x) dt, + over d, gy h,
//   + over d, dA g) and one expf (6 FP32-pipe instructions and one
//   MUFU.EX2): 29 FP32-pipe instructions an element, 1.86 ms at 128 a
//   clock an SM (the SFU 0.51 ms).  The operations bind.
//
// Design: four threads a channel, each with 4 of its 16 states (A's, the
// gradient r reaching them and dA's sums in registers); 32 channels, 128
// threads, a block, all of one b.  The states go in reverse but the
// forward keeps only each chunk's carry, so the backward recomputes them
// on the SM, at two levels: a chunk is walked forward from its carry
// once, storing the state before every stage of kStage = 8 steps in
// shared memory (at c = 256, 31 stages' 2 KB a block); then the stages
// are taken last to first, each recomputed from its stored state into
// registers (its 8 states before each step and their dA = exp(dt A), the
// forward's instructions, so its bits) and walked in reverse, reading dA
// from there: exp once an element in each pass, no state in device
// memory.  The chunk's last stage is recorded on the first walk itself.
// Every stage runs its 8 steps unrolled, without a branch: the steps of a
// short last stage come zero-filled and leave every carried value as it
// was.  dt, x, gy and bc come a stage at a time by 16-byte cp.async,
// double-buffered; a step reads them as broadcast shared loads.  dx and
// ddt: each thread's sum over its 4 states in order, then over the 4
// lanes as (p0 + p2) + (p1 + p3) (two shuffles), left in the stage's own
// gy and x rows (read by then) and written out a 16-byte piece a thread
// after the stage.  dB and dC, 32 sums over the block's channels a step:
// a transposed butterfly over the warp's 8 channels (7 shuffles; lane l
// ends with one of the 32 sums), the block's 4 warps' partials in order
// in shared memory, one partial a block written out (dbc_part), which the
// wrapper sums over blocks (torch.sum): a fixed order, no atomics.  dA's
// partials are a thread's own sums over its steps, one a (b, d, n).
// At most 128 registers (4 blocks an SM); shared memory (the stages'
// states, two staging buffers, the warps' partials: 74 KB at c = 256, 42
// KB at c = 128) holds 3 blocks an SM at c = 256, 4 at c = 128.  At B 8,
// di 8192 its 2048 blocks are 5.2 and 3.9 waves: one wave would need all
// 65,536 channels' stage states on chip at once (1-2 KB a channel at c =
// 128-256, against 0.46 KB of shared memory a channel).  Its SASS holds
// about 70 instructions an element (two exp walks of 14, the reverse
// walk's 25 with its sums over lanes, then a stage's copies, bookkeeping
// and partials; chip_smoke.py's design record): the issue limit binds.

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

constexpr int kLanes = 4;                     // threads a channel
constexpr int kPer = kN / kLanes;             // states a thread
constexpr int kBwdCh = 32;                    // channels a block
constexpr int kBwdThreads = kBwdCh * kLanes;  // 128
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kStage = 8;                     // steps a stage
static_assert(kPer == 4, "a thread's states move as one float4");

struct __align__(16) BwdStage {
  float dt[kStage][kBwdCh];
  float x[kStage][kBwdCh];
  float gy[kStage][kBwdCh];
  float bc[kStage][2 * kN];
};

// A block's shared memory: two staging buffers and the warps' partial
// sums of dB and dC a step; after it, the state before each stage of the
// chunk but the last (bwd_stages(chunk) - 1 of them, a float4 a thread)
struct __align__(16) BwdShared {
  BwdStage st[2];
  float red[kStage][kBwdWarps][2 * kN];
};

__host__ __device__ constexpr int bwd_stages(int chunk) {
  return (chunk + kStage - 1) / kStage;
}

size_t bwd_smem_bytes(int chunk) {
  return sizeof(BwdShared) + static_cast<size_t>(bwd_stages(chunk) - 1) *
                                 kBwdThreads * sizeof(float4);
}

// One thread's 16-byte piece of each stage's copy: threads 0-63 copy a
// piece of a row of dt, of x and of gy (a row: the block's kBwdCh
// channels at one step), threads 64-127 one of bc's; `off` is the piece's
// offset at step 0, `row` its step in the stage
struct BwdPiece {
  size_t off;
  int row;
  bool live;
};

// The copies of steps [s0, s0 + n) into `st`, one commit group, steps
// past n zero-filled; gy only where `with_gy`
__device__ __forceinline__ void load_bwd_stage(
    BwdStage& st, const float* x, const float* dt, const float* gy,
    const float* bc, const BwdPiece& pc, int s0, int n, int di, int tid,
    bool with_gy) {
  constexpr int kPieces = kStage * kBwdCh / 4;
  static_assert(2 * kPieces == kBwdThreads &&
                    kStage * 2 * kN / 4 == kPieces,
                "one 16-byte piece of each array a thread");
  const bool ok = pc.live && pc.row < n;
  if (tid < kPieces) {
    const size_t off = ok ? pc.off + static_cast<size_t>(s0) * di : 0;
    float* dst = &st.dt[0][0] + 4 * tid;
    cp_async16(dst, dt + off, ok);
    cp_async16(dst + kStage * kBwdCh, x + off, ok);
    if (with_gy) cp_async16(dst + 2 * kStage * kBwdCh, gy + off, ok);
  } else {
    const size_t off = ok ? pc.off + static_cast<size_t>(s0) * (2 * kN) : 0;
    cp_async16(&st.bc[0][0] + 4 * (tid - kPieces), bc + off, ok);
  }
  cp_async_commit();
}

// Steps 0 .. kStage - 1 of the stage in `st` from the state h, which ends
// past them, with the forward's instructions (so the forward's bits);
// with kRecord also hs[t], the state before step t, and es[t], its dA.
// A stage's steps past the chunk come zero-filled: dA = exp(0) = 1 and
// dt B x = 0 leave h as it was
template <bool kRecord>
__device__ __forceinline__ void forward_stage(
    const BwdStage& st, int c, int j, const float (&a)[kPer],
    float (&h)[kPer], float (&hs)[kStage][kPer], float (&es)[kStage][kPer]) {
#pragma unroll
  for (int t = 0; t < kStage; ++t) {
    const float dtv = st.dt[t][c], xv = st.x[t][c];
    const float4 bq = *reinterpret_cast<const float4*>(&st.bc[t][kPer * j]);
    const float Bv[kPer] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const float dA = expf(__fmul_rn(dtv, a[m]));
      if constexpr (kRecord) {
        hs[t][m] = h[m];
        es[t][m] = dA;
      }
      h[m] = __fadd_rn(__fmul_rn(dA, h[m]),
                       __fmul_rn(__fmul_rn(dtv, Bv[m]), xv));
    }
  }
}

// One step of a transposed butterfly over the lanes: each keeps v[i] or
// v[i + kHalf] as bit kXor of its lane is clear or set, plus its
// partner's copy of the same value (one shuffle each)
template <int kHalf, int kXor>
__device__ __forceinline__ void transpose_sum_step(float (&v)[2 * kPer],
                                                   int lane) {
  const bool upper = lane & kXor;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, kXor));
  }
}

// Steps kStage - 1 .. 0 of the stage in `st` in reverse, from its record
// (hs, es): dx of step t left in st.gy[t][c] and ddt in st.x[t][c] (both
// read by then: the channel's lanes have met at the step's shuffles),
// dA's sums (dAs), the gradient r reaching the state before the step and
// that state's successor hn (on entry the state after the stage) carried,
// and the warp's dB and dC of step t left in red[t][warp].  A zero-filled
// step past the chunk (gy = dt = x = 0, dA = 1) leaves r, dAs and hn as
// they were
__device__ __forceinline__ void reverse_stage(
    BwdStage& st, int c, int j, int lane, int warp, const float (&a)[kPer],
    const float (&hs)[kStage][kPer], const float (&es)[kStage][kPer],
    float (&r)[kPer], float (&hn)[kPer], float (&dAs)[kPer],
    float (&red)[kStage][kBwdWarps][2 * kN]) {
  // the lane's sum after the butterfly: v[m], m = lane / 4, of its 4
  // states: dB (m < 4) or dC of state kPer j + m % 4
  const int m_sum = lane >> 2;
  const int col = (m_sum < kPer ? 0 : kN - kPer) + kPer * j + m_sum;
  const bool hi = j & 2;
  float* const out = hi ? &st.x[0][c] : &st.gy[0][c];
#pragma unroll
  for (int t = kStage - 1; t >= 0; --t) {
    const float dtv = st.dt[t][c], xv = st.x[t][c], gyv = st.gy[t][c];
    const float4 bq = *reinterpret_cast<const float4*>(&st.bc[t][kPer * j]);
    const float4 cq =
        *reinterpret_cast<const float4*>(&st.bc[t][kN + kPer * j]);
    const float Bv[kPer] = {bq.x, bq.y, bq.z, bq.w};
    const float Cv[kPer] = {cq.x, cq.y, cq.z, cq.w};
    float dxv = 0.0f, ddtv = 0.0f, v[2 * kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const float dA = es[t][m];
      const float g = __fadd_rn(__fmul_rn(gyv, Cv[m]), r[m]);
      const float gu = __fmul_rn(g, __fmul_rn(dtv, Bv[m]));
      const float gx = __fmul_rn(g, xv);
      const float q = __fmul_rn(__fmul_rn(g, hs[t][m]), dA);
      const float term = __fadd_rn(__fmul_rn(q, a[m]),
                                   __fmul_rn(gx, Bv[m]));
      dxv = m == 0 ? gu : __fadd_rn(dxv, gu);
      ddtv = m == 0 ? term : __fadd_rn(ddtv, term);
      dAs[m] = __fadd_rn(dAs[m], __fmul_rn(q, dtv));
      v[m] = __fmul_rn(gx, dtv);            // this channel's dB
      v[kPer + m] = __fmul_rn(gyv, hn[m]);  // and dC
      r[m] = __fmul_rn(dA, g);
      hn[m] = hs[t][m];
    }
    // over the channel's 4 lanes, (p0 + p2) + (p1 + p3): lanes 0 and 1
    // end with dx, lanes 2 and 3 with ddt
    float sum = __fadd_rn(hi ? ddtv : dxv,
                          __shfl_xor_sync(0xffffffffu, hi ? dxv : ddtv, 2));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
    out[t * kBwdCh] = sum;
    // dB and dC over the warp's 8 channels (lanes 4 c' + j)
    transpose_sum_step<4, 16>(v, lane);
    transpose_sum_step<2, 8>(v, lane);
    transpose_sum_step<1, 4>(v, lane);
    red[t][warp][col] = v[0];
  }
}

__global__ void __launch_bounds__(kBwdThreads, 4)
selective_scan_bwd(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ bc,
                   const float* __restrict__ h_chunks,
                   const float* __restrict__ gy,
                   const float* __restrict__ gh_last, float* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ dA_part,
                   float* __restrict__ dbc_part, int B, int S, int di,
                   int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdShared& sm = *reinterpret_cast<BwdShared*>(smem);
  float4* ck = reinterpret_cast<float4*>(smem + sizeof(BwdShared));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / kLanes, j = tid % kLanes;  // channel, its lane
  const int d0 = blockIdx.x * kBwdCh;
  const int d = d0 + c;
  const bool live = d < di;
  const int b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * S;  // row (b, 0)
  const int n_chunks = S / chunk, n_st = bwd_stages(chunk);
  // this thread's kPer states of channel (b, d) in a (B, di, N) tensor
  const size_t own = (static_cast<size_t>(b) * di + d) * kN + kPer * j;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // the thread's piece of each stage's copy (load_bwd_stage) and of the
  // stage's dx (threads 0-63) or ddt (64-127) rows written back
  const int prow = (tid % (kBwdThreads / 2)) / (kBwdCh / 4);
  const int pcol = 4 * (tid % (kBwdCh / 4));
  const BwdPiece pc =
      tid < kBwdThreads / 2
          ? BwdPiece{(row0 + prow) * di + d0 + pcol, prow, d0 + pcol < di}
          : BwdPiece{row0 * (2 * kN) + 4 * (tid - kBwdThreads / 2),
                     4 * (tid - kBwdThreads / 2) / (2 * kN), true};
  const bool wlive = d0 + pcol < di;
  float* const wout = (tid < kBwdThreads / 2 ? dx : ddt) +
                      (row0 + prow) * di + d0 + pcol;

  // a: A's row; r: dA_{t+1} g_{t+1}, the gradient reaching the state
  // from the step after it (gh_last at the end); dAs: the channel's
  // gradient of A over its steps; h: the walks' state; hn: the reverse
  // walk's state after the step; hs, es: a stage's record
  float a[kPer], r[kPer], dAs[kPer], h[kPer], hn[kPer];
  float hs[kStage][kPer], es[kStage][kPer];
  const float4 av = live ? *reinterpret_cast<const float4*>(
                               A + static_cast<size_t>(d) * kN + kPer * j)
                         : zero;
  const float4 rv = live && gh_last
                        ? *reinterpret_cast<const float4*>(gh_last + own)
                        : zero;
  a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
  r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
#pragma unroll
  for (int m = 0; m < kPer; ++m) dAs[m] = h[m] = hn[m] = 0.0f;

  // The items of the walk, one stage each: chunks k last to first, each
  // walked forward (w < n_st: stage s = w; its last stage recorded and
  // reversed on the spot), then its other stages last to first (s = per
  // - 1 - w: recorded, reversed)
  const int per = 2 * n_st - 1, n_items = n_chunks * per;
  int k = n_chunks - 1, w = 0;
  load_bwd_stage(sm.st[0], x, dt, gy, bc, pc, k * chunk,
                 min(kStage, chunk), di, tid, n_st == 1);
  for (int i = 0; i < n_items; ++i) {
    const bool fwd = w < n_st;
    const int s = fwd ? w : per - 1 - w;
    const int s0 = k * chunk + s * kStage;
    const int n = min(kStage, chunk - s * kStage);
    const int kc = k;
    if (++w == per) {
      w = 0;
      --k;
    }
    cp_async_wait<0>();
    // the stage is in, and every thread is done with the buffer the next
    // copy fills and with the warps' partials this item writes
    __syncthreads();
    if (i + 1 < n_items) {
      const int ns = w < n_st ? w : per - 1 - w;
      load_bwd_stage(sm.st[(i + 1) & 1], x, dt, gy, bc, pc,
                     k * chunk + ns * kStage,
                     min(kStage, chunk - ns * kStage), di, tid,
                     w >= n_st - 1);
    }
    BwdStage& cur = sm.st[i & 1];
    const bool last = s == n_st - 1;
    float4* ckp = ck + s * kBwdThreads + tid;
    if (fwd) {
      if (s == 0) {  // the chunk's carry
        const float4 v =
            live ? *reinterpret_cast<const float4*>(
                       h_chunks + ((static_cast<size_t>(b) * n_chunks + kc) *
                                       di + d) * kN + kPer * j)
                 : zero;
        h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
      }
      if (!last) {
        *ckp = make_float4(h[0], h[1], h[2], h[3]);
        forward_stage<false>(cur, c, j, a, h, hs, es);
        continue;
      }
    } else {
      const float4 v = *ckp;
      h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
    }
    forward_stage<true>(cur, c, j, a, h, hs, es);
    if (last) {  // the state after the chunk
#pragma unroll
      for (int m = 0; m < kPer; ++m) hn[m] = h[m];
    }
    reverse_stage(cur, c, j, lane, warp, a, hs, es, r, hn, dAs, sm.red);
    __syncthreads();
    // the stage's dx and ddt rows, a 16-byte piece a thread; the block's
    // dB and dC of its steps: its warps' partials in order, one partial a
    // block (the wrapper sums the blocks in order)
    if (wlive && prow < n)
      *reinterpret_cast<float4*>(wout + static_cast<size_t>(s0) * di) =
          *reinterpret_cast<const float4*>(
              tid < kBwdThreads / 2 ? &cur.gy[prow][pcol]
                                    : &cur.x[prow][pcol]);
    float* part = dbc_part +
                  ((static_cast<size_t>(blockIdx.x) * B + b) * S + s0) *
                      (2 * kN);
#pragma unroll
    for (int q = 0; q < kStage * 2 * kN / kBwdThreads; ++q) {
      const int e = tid + q * kBwdThreads, t = e / (2 * kN),
                l = e % (2 * kN);
      if (t < n) {
        float sum = sm.red[t][0][l];
#pragma unroll
        for (int v = 1; v < kBwdWarps; ++v)
          sum = __fadd_rn(sum, sm.red[t][v][l]);
        part[e] = sum;
      }
    }
  }
  if (live)
    *reinterpret_cast<float4*>(dA_part + own) =
        make_float4(dAs[0], dAs[1], dAs[2], dAs[3]);
}

// the backward's dynamic shared memory at this chunk, allowed above 48 KB
// and with the SM's shared memory carved out at its largest
cudaError_t bwd_configure(int chunk, size_t* smem) {
  *smem = bwd_smem_bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(selective_scan_bwd,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
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
// (ceil(di / 32), B, S, 2N), which the caller sums over their first axis.
// N must be 16, di a multiple of 8, chunk a divisor of S (its stages'
// states must fit shared memory: chunk <= 256 is what the wrapper
// passes), every pointer 16-byte aligned (the wrapper checks).  Launches
// on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int selective_scan_backward_launch(
    const void* x, const void* dt, const void* A, const void* bc,
    const void* h_chunks, const void* gy, const void* gh_last, void* dx,
    void* ddt, void* dA_part, void* dbc_part, int B, int S, int di, int N,
    int chunk, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  if (N != kN || B > 65535 || di % 8 != 0 || chunk <= 0 || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const cudaError_t err = bwd_configure(chunk, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((di + kBwdCh - 1) / kBwdCh, B);
  selective_scan_bwd<<<grid, kBwdThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bc),
      static_cast<const float*>(h_chunks), static_cast<const float*>(gy),
      static_cast<const float*>(gh_last), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA_part),
      static_cast<float*>(dbc_part), B, S, di, chunk);
  return static_cast<int>(cudaGetLastError());
}

// C entry for ctypes: the backward's launch shape at this chunk, its
// dynamic shared memory in bytes and the blocks an SM holds at once (the
// occupancy API, on the current device); returns the CUDA error.
extern "C" int selective_scan_backward_occupancy(int chunk, int* smem_bytes,
                                                 int* blocks_per_sm) {
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const cudaError_t err = bwd_configure(chunk, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, selective_scan_bwd, kBwdThreads, smem));
}
