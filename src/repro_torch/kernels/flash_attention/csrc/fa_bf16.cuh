// bf16 flash attention on the tensor cores: Hopper's warpgroup MMA
// (wgmma.mma_async, bf16 in, fp32 accumulate) for both products.
//
// One block of two warpgroups (256 threads) per (128 query rows, head,
// batch); warpgroup w owns rows 64 w .. 64 w + 63 of the block, and its
// warp v (0-3) the rows 16 v .. 16 v + 15 of those, as the wgmma
// accumulator lays them out.
//
// * Q (128 x hd) and each K and V tile (64 x hd) sit in shared memory in
//   wgmma's canonical swizzled layout: hd split into column blocks of one
//   swizzle atom (64 elements, 128-byte swizzle; 32 elements and 64-byte
//   swizzle at hd 32), rows of one atom each, 16-byte chunks XOR-ed by
//   the row.  A head dim that is not a whole number of atoms (Kimi-K2's
//   112) is padded in shared memory only, to HDP = 128: cp.async loads
//   the 112 real columns and zero-fills the rest (src-size 0, no global
//   read), S = Q K^T takes hd / 16 = 7 k-steps over the real columns, O
//   += P V runs over all 128 (the padded V columns are 0) and only the
//   real 112 are written back (the predicates compile only at such a
//   head dim).  The same bytes are Q and K as K-major operands and V as
//   the MN-major ("transposed") B operand of O += P V, so nothing is
//   transposed.  Q and the K/V tiles arrive by cp.async, K/V in a ring of
//   three stages, two tiles ahead.  Rows past Sq or Skv are zero-filled.
// * S = Q K^T: hd / 16 wgmma m64n64k16, both operands from shared memory
//   through descriptors.  The online softmax runs on the fp32 accumulator
//   registers (two rows' 16 scores a thread, tree reductions, the row max
//   over the 4 lanes of a quad, the row sum a per-thread partial until
//   the end).  P is packed to bf16 in registers, where the accumulator's
//   layout is exactly the A-fragment layout of the next product, and
//   O += P V is 4 wgmma m64n{64,32}k16 with A from registers: P never
//   touches shared memory.
// * Tile kt's S = Q K^T and tile kt - 1's O += P V are in flight
//   together, and the softmax of tile kt waits only for S (FlashAttention
//   3's intra-warpgroup overlap).  No wgmma sits under a branch the
//   compiler could think divergent (ptxas would serialize them all), so
//   the first tile is peeled and both warpgroups run every tile of the
//   block.
// * Scores are scaled by scale * log2(e), folded into the FFMA before
//   ex2; masked scores are -1e30 * log2(e), i.e. exactly -1e30 before the
//   change of base, and keys past Skv are -inf.  The mask is applied only
//   on tiles that cross the diagonal or the window edge or hold keys past
//   Skv.
// * What bounds it is latency: with 16 warps an SM (128 registers a
//   thread) none of the wgmma pipe, the exp unit (16 exps a clock an
//   SM: at hd 64 a score's exp takes as long as its 128 bf16 MACs) and
//   the issue slots is saturated (PERF.md, K3).
#pragma once

#include "fa_common.cuh"

namespace fa {

template <int HD>
struct B16Cfg {
  static_assert(HD % 16 == 0, "whole k-steps of Q K^T");
  static constexpr int BQ = 128;  // two warpgroups of 64 rows
  static constexpr int kThreads = 256;
  static constexpr int AW = HD == 32 ? 32 : 64;  // swizzle atom, elements
  static constexpr int HDP = (HD + AW - 1) / AW * AW;  // padded in smem
  // only a padded head dim compiles the padding's predicates: the
  // instances at whole atoms build as they did without them
  static constexpr bool kPad = HDP != HD;
  static constexpr int CPA = AW / 8;             // 16-byte chunks an atom row
  static constexpr int NCB = HDP / AW;           // column blocks
  static constexpr int kRowBytes = AW * 2;       // one atom row: 64 or 128
  static constexpr int kQ = BQ * HDP, kKV = kBK * HDP;  // bf16 elements
  // K/V stages: a ring of three, two tiles ahead; at hd 256 three
  // stages of 64 x 256 K and V (192 KB) beside Q (64 KB) exceed the
  // 227 KB a block may take, so two (194 KB in all), one tile ahead
  static constexpr int NS = HDP == 256 ? 2 : 3;
  // 1024 bytes of slack to align the atoms; Q, K and V (NS stages
  // each), then NS x 64 key positions
  static constexpr size_t kSmem =
      1024 + sizeof(__nv_bfloat16) * (kQ + 2 * NS * kKV) +
      sizeof(int) * NS * kBK;
};

// 16-byte chunk index of (row r, chunk c) in an R-row tile: column block
// c / CPA, then the row, then the chunk XOR-ed by the row as the 128-byte
// (64-byte) swizzle does.  The 8 rows an 8 x 16-byte core matrix spans
// land in 8 different bank groups.
template <int HD, int R>
__device__ __forceinline__ int wg_chunk(int r, int c) {
  using C = B16Cfg<HD>;
  const int sw = C::CPA == 8 ? (r & 7) : ((r >> 1) & 3);
  return ((c / C::CPA) * R + r) * C::CPA + ((c % C::CPA) ^ sw);
}

// wgmma shared-memory descriptor: start address, leading byte offset
// (K-major: unused by the swizzled layouts, 16; MN-major: between column
// blocks), stride byte offset 8 atom rows (between 8-row groups), swizzle
// mode.  The atoms are 1024-byte aligned, so the base offset is 0.
template <int HD>
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo) {
  using C = B16Cfg<HD>;
  constexpr uint64_t kMode = C::AW == 64 ? 1 : 2;  // 128B : 64B swizzle
  constexpr uint32_t kSbo = 8 * C::kRowBytes;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32) | (kMode << 62);
}

// Rows [row0, row0 + R) of a (rows, stride) bf16 matrix, HD wide -> the
// swizzled tile, HDP wide, by cp.async; rows past n_rows and the padding
// columns past HD are zero-filled.
template <int HD, int R, int T>
__device__ __forceinline__ void wg_load(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        size_t stride, int row0,
                                        int n_rows) {
  constexpr int CH = B16Cfg<HD>::HDP / 8;
  static_assert(R * CH % T == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < R * CH / T; ++i) {
    const int idx = i * T + static_cast<int>(threadIdx.x);
    const int r = idx / CH, c = idx % CH;
    bool ok = row0 + r < n_rows;
    if constexpr (B16Cfg<HD>::kPad) ok = ok && c < HD / 8;
    const __nv_bfloat16* g =
        ok ? src + static_cast<size_t>(row0 + r) * stride + 8 * c : src;
    cp_async16(dst + 8 * wg_chunk<HD, R>(r, c), g, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an asynchronous wgmma writes: keep the compiler from moving
// their reads or writes across the fence / wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The A registers of an asynchronous wgmma: live until its wait.
template <int N>
__device__ __forceinline__ void reg_fence_u(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, fp32) {=, +=} A (64 x 16, shared, K-major) * B (16 x 64,
// shared, K-major): one k-step of the warpgroup's S = Q K^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, shared,
// MN-major): one k-step of the warpgroup's O += P V
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, registers) * B (16 x 32, shared,
// MN-major): one k-step of the warpgroup's O += P V
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  // round to nearest even; the lower column in the low half
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

template <int HD>
__global__ void __launch_bounds__(256, B16Cfg<HD>::HDP >= 128 ? 1 : 2)
fa_fwd_bf16(const Args a) {
  using C = B16Cfg<HD>;
  constexpr int BQ = C::BQ, AW = C::AW, NCB = C::NCB, NS = C::NS;
  constexpr int T = C::kThreads, CH = C::HDP / 8;  // chunks a smem row
  constexpr int KQ = HD / 16;         // k-steps of Q K^T (real columns)
  constexpr int NL = kBK * CH / T;    // 16-byte chunks of a K tile a thread
  static_assert(kBK * CH % T == 0, "whole passes of the block");
  constexpr uint32_t kTileBytes = kBK * C::kRowBytes;  // one column block
  constexpr uint32_t kStageBytes = 2 * C::kKV;
  extern __shared__ float4 smem4[];
  char* raw = reinterpret_cast<char*>(smem4);
  raw += (1024 - (smem_addr(raw) & 1023)) & 1023;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(raw);
  __nv_bfloat16* Ks = Qs + C::kQ;         // [NS][tile]
  __nv_bfloat16* Vs = Ks + NS * C::kKV;   // [NS][tile]
  int* Kp = reinterpret_cast<int*>(Vs + NS * C::kKV);  // [NS][64]

  const int tid = static_cast<int>(threadIdx.x);
  // the warpgroup index through a shuffle, so the compiler sees it (and
  // every branch on it) uniform across the warp: a wgmma under a branch
  // it thinks divergent gets serialized
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x;
  const int q0 = static_cast<int>(gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int Sq = a.Sq, Skv = a.Skv;

  const size_t q_stride = static_cast<size_t>(a.H) * HD;
  const size_t kv_stride = static_cast<size_t>(a.KV) * HD;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            (static_cast<size_t>(b) * Sq * a.H + h) * HD;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            (static_cast<size_t>(b) * Skv * a.KV + kvh) * HD;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            (static_cast<size_t>(b) * Skv * a.KV + kvh) * HD;
  const int* qpb = a.q_pos + static_cast<size_t>(b) * Sq;
  const int* kpb = a.k_pos + static_cast<size_t>(b) * Skv;

  const TileRange tr = tile_range(a, q0, min(q0 + BQ, Sq) - 1);
  // this warpgroup's rows (none live when w_lo >= Sq: it computes on
  // zero rows and stores nothing).  Both warpgroups run every tile of the
  // block, so no wgmma sits under a branch: a tile that lies above all of
  // a warpgroup's rows scores -1e30 everywhere and adds exactly 0 (each
  // row has already seen its own key).
  const int w_lo = q0 + 64 * wg;
  const int w_hi = min(w_lo + 64, Sq) - 1;

  // this thread's chunks of a K (and V) tile: rows, shared offsets,
  // global offsets, and (padded head dims) whether the chunk is a real
  // column
  int ld_r[NL];
  uint32_t ld_dst[NL];
  size_t ld_src[NL];
  bool ld_real[NL];  // unused unless C::kPad
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int idx = i * T + tid, r = idx / CH, c = idx % CH;
    ld_r[i] = r;
    ld_dst[i] = 16 * wg_chunk<HD, kBK>(r, c);
    ld_src[i] = r * kv_stride + 8 * c;
    ld_real[i] = c < HD / 8;
  }
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * kBK;
    const size_t off = static_cast<size_t>(k0) * kv_stride;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      bool ok = k0 + ld_r[i] < Skv;
      if constexpr (C::kPad) ok = ok && ld_real[i];
      cp_async16_s(k_base + st * kStageBytes + ld_dst[i],
                   ok ? kb + off + ld_src[i] : kb, ok ? 16 : 0);
      cp_async16_s(v_base + st * kStageBytes + ld_dst[i],
                   ok ? vb + off + ld_src[i] : vb, ok ? 16 : 0);
    }
    if (tid < kBK) {
      const bool ok = k0 + tid < Skv;
      cp_async4(Kp + st * kBK + tid, ok ? kpb + k0 + tid : kpb, ok ? 4 : 0);
    }
  };

  // cp.async groups: Q with the first tile, then one a tile (maybe empty)
  wg_load<HD, BQ, T>(Qs, qb, q_stride, q0, Sq);
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (tr.lo + i <= tr.hi) load_kv(tr.lo + i, i);
    cp_async_commit();
  }

  // this thread's rows: g and g + 8 of its warp's 16
  const int r0 = w_lo + 16 * warp + g, r1 = r0 + 8;
  const int qp0 = r0 < Sq ? qpb[r0] : 0, qp1 = r1 < Sq ? qpb[r1] : 0;
  const float sl2 = a.scale * kLog2e;
  const float masked = kMasked * kLog2e;
  float o[NCB][AW / 2], m[2] = {masked, masked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NCB; ++n)
#pragma unroll
    for (int e = 0; e < AW / 2; ++e) o[n][e] = 0.f;
  uint32_t pc[4][4];  // P of the previous tile: A fragments of P V

  const uint32_t q_base = smem_addr(Qs) + 64 * wg * C::kRowBytes;
  // O += P V for the tile in stage st, A = pc
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NCB; ++n)
        wgmma_rs<AW>(o[n], pc[kk],
                     wg_desc<HD>(v_base + st * kStageBytes + n * kTileBytes +
                                     16 * kk * C::kRowBytes,
                                 kTileBytes));
    wg_commit();
  };
  auto pv_done = [&]() {
#pragma unroll
    for (int n = 0; n < NCB; ++n) reg_fence(o[n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence_u(pc[kk]);
  };

  // S = Q K^T for the tile in stage st (element 4 j + e: row g, +8 for
  // e >= 2; key 8 j + 2 tq + (e & 1)), issued and committed
  auto issue_s = [&](float (&s)[32], int st) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const uint32_t cb = (16 * kk) / AW, off = (16 * kk) % AW * 2;
      wgmma_ss_n64(
          s, wg_desc<HD>(q_base + cb * BQ * C::kRowBytes + off, 16),
          wg_desc<HD>(k_base + st * kStageBytes + cb * kTileBytes + off, 16),
          kk > 0);
    }
    wg_commit();
  };
  // The online softmax of tile kt (stage st) in log2 units: updates m and
  // l, turns s into P (fp32) and returns each row's correction for O.
  // A full tile keeps the raw scores and folds the scale into the
  // exponent's FFMA; an edge tile is scaled and masked first, and then
  // multiplied by 1.
  auto softmax = [&](float (&s)[32], int kt, int st, float (&corr)[2]) {
    const int k0 = kt * kBK;
    const int* kps = Kp + st * kBK;
    float mul = sl2;
    if (!tile_full(a, k0, w_lo, w_hi)) {
      mul = 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1);
          float t = s[4 * j + e] * sl2;
          if (k0 + c >= Skv)
            t = -CUDART_INF_F;  // past the sequence: adds exactly 0
          else if (!visible(a, e < 2 ? qp0 : qp1, kps[c]))
            t = masked;
          s[4 * j + e] = t;
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // row g, then row g + 8
      float r[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) r[j] = fmaxf(r[j], r[j + w]);
      float mx = fmaxf(m[hh], r[0] * mul);  // max commutes with mul > 0
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[hh] = ex2(m[hh] - mx);
      m[hh] = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float& p0 = s[4 * j + 2 * hh];
        float& p1 = s[4 * j + 2 * hh + 1];
        p0 = ex2(fmaf(p0, mul, -mx));
        p1 = ex2(fmaf(p1, mul, -mx));
        r[j] = p0 + p1;
      }
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) r[j] += r[j + w];
      l[hh] = fmaf(l[hh], corr[hh], r[0]);
    }
  };
  // P to bf16 A fragments, once no P V reads pc any more: k-step kk of
  // P V (keys 16 kk ..) is the score n-tiles 2 kk and 2 kk + 1
  auto pack_p = [&](const float (&s)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pc[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  // after each tile: the stage P V last read (prev) is refilled with the
  // tile NS - 1 ahead
  auto next_tile = [&](int kt, int prev) {
    __syncthreads();  // stage `prev` read by every warpgroup
    if (kt + NS - 1 <= tr.hi) load_kv(kt + NS - 1, prev);
    cp_async_commit();
  };
  auto tile_landed = [&]() {
    cp_async_wait<NS - 2>();  // Q and this tile have landed
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };

  if (tr.lo <= tr.hi) {
    // the first tile: S and its softmax; O is still 0
    tile_landed();
    {
      float s[32], corr[2];
      issue_s(s, 0);
      wg_wait<0>();
      reg_fence(s);
      softmax(s, tr.lo, 0, corr);
      pack_p(s);
    }
    next_tile(tr.lo, NS - 1);
    int stage = 1;  // of tile kt
    // then S of this tile and P V of the previous one in flight together,
    // the softmax waiting only for S
    for (int kt = tr.lo + 1; kt <= tr.hi; ++kt) {
      const int prev = stage == 0 ? NS - 1 : stage - 1;  // of tile kt - 1
      tile_landed();
      float s[32], corr[2];
      issue_s(s, stage);
      issue_pv(prev);
      wg_wait<1>();
      reg_fence(s);
      softmax(s, kt, stage, corr);
      wg_wait<0>();
      pv_done();
      // rescale O by this tile's max, unless no row of the warp moved
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NCB; ++n)
#pragma unroll
          for (int j = 0; j < AW / 8; ++j) {
            o[n][4 * j] *= corr[0];
            o[n][4 * j + 1] *= corr[0];
            o[n][4 * j + 2] *= corr[1];
            o[n][4 * j + 3] *= corr[1];
          }
      }
      pack_p(s);
      next_tile(kt, prev);
      stage = stage + 1 == NS ? 0 : stage + 1;
    }
    // the last tile's P V
    wg_fence();
    issue_pv(stage == 0 ? NS - 1 : stage - 1);
    wg_wait<0>();
    pv_done();
  }

  cp_async_wait<0>();  // nothing left in flight at exit
  if (w_lo >= Sq) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
    const int r = hh ? r1 : r0;
    if (r >= Sq) continue;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.out) +
                          ((static_cast<size_t>(b) * Sq + r) * a.H + h) * HD;
#pragma unroll
    for (int n = 0; n < NCB; ++n)
#pragma unroll
      for (int j = 0; j < AW / 8; ++j)
        if (!C::kPad || n * AW + 8 * j < HD)  // real columns only
          *reinterpret_cast<__nv_bfloat162*>(orow + n * AW + 8 * j +
                                             2 * tq) =
              __floats2bfloat162_rn(o[n][4 * j + 2 * hh] / den,
                                    o[n][4 * j + 2 * hh + 1] / den);
  }
}

}  // namespace fa
