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
// Rows of hd elements are contiguous; fp32 or bf16 in, fp32 softmax and
// accumulators, output in the input dtype.
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
// Sq=Skv=2016, hd=64, causal): 8*32*2016*2017/2 = 5.205e8 unmasked
// (query, key) pairs at 4*hd = 256 FLOPs each = 1.33e11 FLOPs: 1.99 ms
// at the 67 TFLOP/s fp32 rate outside the tensor cores, 0.135 ms at the
// 989 TFLOP/s bf16 rate of the tensor cores.  The bytes (fp32: q and out
// 132 MB each, k and v 16.5 MB each) take 0.089 ms at 3.35 TB/s, so both
// builds are bound by operations.
//
// Two designs, one per input type (the first design of this kernel
// staged both types as fp32 in shared memory and ran fp32 FMAs for both:
// 5.26 ms at the shape above in either type on an H100, PERF.md):
//
// * bf16 (fa_bf16.cuh): the tensor cores, through Hopper's wgmma with
//   both operands of S = Q K^T and V of O += P V read from shared memory
//   by descriptor in the canonical swizzled layouts, P kept in registers
//   as the A operand, cp.async K/V tiles in a ring of three stages, and
//   S of one tile in flight beside P V of the previous one.  TMA with
//   mbarriers and warp-specialised producer / consumer warpgroups are
//   left for later: the loads are not what bounds it (fa_bf16.cuh).
// * fp32 (fa_f32.cuh): exact fp32 FMAs on the CUDA cores (no TF32: at
//   the model's layer-0 scores, |s| up to ~800, TF32's 10-bit mantissa
//   moves a score by ~0.4), as the outer product of a fast SGEMM: Q and
//   K staged hd-major, an 8 x 4 score tile a thread from three 16-byte
//   loads per step of hd, P stored transposed for the same outer product
//   against V, the next K tile in registers and the next V tile by
//   cp.async while the current one is used.
//
// Both mask only the tiles that cross the diagonal, the window edge or
// Skv.  Head dims 32, 64, 112 (Kimi-K2's), 128 and 256 (RecurrentGemma's):
// at 256 the bf16 ring has two stages and the fp32 V one buffer, to fit
// shared memory; at 112 the bf16 tiles are zero-padded to 128 columns in
// shared memory (never in device memory) and the fp32 design maps its 7
// output columns a thread as 4 + 3 (fa_bf16.cuh, fa_f32.cuh).  Left for
// later: TMA and warp specialisation for bf16, a split-KV variant for
// one-token decode, and other head dims.

#include "fa_bf16.cuh"
#include "fa_common.cuh"
#include "fa_f32.cuh"

namespace {

template <typename Kernel>
int launch(Kernel kern, size_t smem, int BQ, int threads, int B,
           const fa::Args& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.H),
                  static_cast<unsigned>((a.Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(B));
  kern<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, int B, const fa::Args& a, cudaStream_t s) {
  if (dtype == 0) {
    using C = fa::F32Cfg<HD>;
    return launch(fa::fa_fwd_f32<HD>, C::kSmem, C::BQ, C::kThreads, B, a, s);
  }
  using C = fa::B16Cfg<HD>;
  return launch(fa::fa_fwd_bf16<HD>, C::kSmem, C::BQ, C::kThreads, B, a,
                s);
}

}  // namespace

// C entry for ctypes.  dtype: 0 = fp32, 1 = bf16; hd in {32, 64, 112,
// 128, 256}; H a multiple of KV; every pointer 16-byte aligned.  Launches on
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
  if (KV <= 0 || H % KV != 0 || Skv < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const fa::Args a{q, k, v, static_cast<const int*>(q_pos),
                   static_cast<const int*>(k_pos), out, H, KV, Sq, Skv,
                   scale, causal, window, contiguous};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, B, a, s);
    case 64: return launch_hd<64>(dtype, B, a, s);
    case 112: return launch_hd<112>(dtype, B, a, s);
    case 128: return launch_hd<128>(dtype, B, a, s);
    case 256: return launch_hd<256>(dtype, B, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
