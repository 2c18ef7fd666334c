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
// then stores in the input dtype (fp32 or bf16).
//
// Bound: bytes.  Each element is read once and written once (2 * rows *
// cols * sizeof(T) bytes) for about a dozen fp32 operations, far below
// the card's operations-per-byte balance.  On the engine's main path the
// matrix is tiny (LSTM w_x, 8 x 256 at hidden 64: 16 KB), so one launch
// costs more than its bytes: the kernel is launch-bound there.
//
// Design: one thread block per row, threads striding over the columns
// (neighbouring threads on neighbouring addresses).  Three block
// reductions (warp shuffles, then shared memory): max|w|; then
// sum exp(|w| - max) together with sum w^2; then sum out^2.  The row is
// re-read from global memory (L1/L2 resident) instead of being staged in
// shared memory, which keeps the kernel valid for any column count.
// expf (not __expf) and no fast-math flags keep fp32 within 1e-6 of the
// plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread gets the result.  `sh` holds one
// slot per warp and is reused, hence the trailing barrier.
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

__device__ float block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kWarps) ? sh[threadIdx.x] : 0.0f;
  if (warp == 0) v = warp_max(v);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  v = sh[0];
  __syncthreads();
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
feature_attention_rows(const T* __restrict__ w, T* __restrict__ out,
                       int cols, int normalize) {
  __shared__ float sh[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const T* wr = w + base;
  T* orow = out + base;

  // |w| >= 0, so 0 is a valid identity for the max
  float m = 0.0f;
  for (int j = threadIdx.x; j < cols; j += kThreads)
    m = fmaxf(m, fabsf(load_f32(wr + j)));
  m = block_max(m, sh);

  float se = 0.0f, sw = 0.0f;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float v = load_f32(wr + j);
    se += expf(fabsf(v) - m);
    sw += v * v;
  }
  se = block_sum(se, sh);

  float scale = 1.0f;
  if (normalize) {
    sw = block_sum(sw, sh);
    float so = 0.0f;
    for (int j = threadIdx.x; j < cols; j += kThreads) {
      const float v = load_f32(wr + j);
      const float o = expf(fabsf(v) - m) / se * v;
      so += o * o;
    }
    so = block_sum(so, sh);
    scale = sqrtf(sw) / fmaxf(sqrtf(so), 1e-12f);
  }

  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float v = load_f32(wr + j);
    float o = expf(fabsf(v) - m) / se * v;
    if (normalize) o = o * scale;
    store(orow + j, o);
  }
}

}  // namespace

// C entry for ctypes.  dtype: 0 = fp32, 1 = bf16.  Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so a refused launch surfaces in the caller.
extern "C" int feature_attention_launch(const void* w, void* out, int rows,
                                        int cols, int dtype, int normalize,
                                        void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    feature_attention_rows<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(w), static_cast<float*>(out), cols,
        normalize);
  } else if (dtype == 1) {
    feature_attention_rows<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), cols, normalize);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
constexpr unsigned kFull = 0xffffffffu;

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
