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
