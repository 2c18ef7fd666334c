// fp32 flash attention: exact fp32 FMAs on the CUDA cores, laid out as
// the outer product of a fast SGEMM so shared memory does not limit it.
//
// One block of 256 threads per (BQ query rows, head, batch); BQ = 128
// (64 at hd 112, 128 and 256, for shared memory).  Thread (ty, tx), ty = 2 warp +
// lane / 16 and tx = lane % 16, owns RM = BQ / 16 consecutive query rows
// ty RM + i and, per 64-key tile, the 4 keys 4 tx + j.
//
// * Q is staged once and each K tile per iteration *hd-major* (Qt[d][row],
//   Kt[d][key]), transposed on the way through registers.  A step along
//   hd then reads RM rows of Q and 4 keys of K as RM / 4 + 1 16-byte
//   loads for 4 RM FMAs (3 loads for 32 FMAs at BQ 128): the loads of
//   Q are broadcasts, those of K one contiguous 256-byte row per warp.
// * Scores are summed over hd in order, one fp32 FMA per step, as
//   cuBLAS sums a 64-deep product: at the model's layer-0 scores (|s| up
//   to ~800) any other order moves a score by ulps of 800.
// * P is stored transposed (Pt[key][row]), so O += P V is the same outer
//   product against V's contiguous rows: RM / 4 + HD / 64 loads per key
//   for RM HD / 16 FMAs.  A thread's HD / 16 output columns are runs of
//   4 at 4 tx + 64 j; a head dim that is not a multiple of 64 (Kimi-K2's
//   112 = 64 + 48) puts its last HD % 64 columns one a thread at
//   64 (HD / 64) + 16 i + tx, 3 of them at 112, read and written as
//   single floats, so a half-warp still touches 16 contiguous ones.
// * The next K tile is loaded into registers and the next V tile by
//   cp.async into the other half of a double buffer while the current
//   tile is in use; two __syncthreads a tile.  At hd 256 the double
//   buffer does not fit (272 KB with it, 208 KB without): V has one
//   buffer, refilled by cp.async once its P V is done, so the load
//   overlaps the next tile's Q K^T instead.
// * The mask is applied only on tiles that cross the causal diagonal or
//   the window edge or hold keys past Skv, and a warp skips a tile that
//   lies wholly above its rows' diagonal.
// * exp is ex2.approx of (s - m) log2(e): the difference is taken in
//   natural units, as the plain version's softmax takes it, and only
//   then is the base changed (folding log2(e) into the scale would round
//   scores of ~800 by ~1e-4).
// * Every shared array is XOR-swizzled in 16-byte chunks (no padding):
//   the transposed stores and the P stores meet no bank conflicts, and
//   two blocks fit an SM (115,200 bytes each at hd 64).
#pragma once

#include "fa_common.cuh"

namespace fa {

template <int HD>
struct F32Cfg {
  static_assert(HD % 16 == 0, "16 output columns a row of threads");
  static constexpr int BQ = HD > 64 ? 64 : 128;
  static constexpr int kThreads = 256;
  static constexpr int RM = BQ / 16;  // query rows per thread
  static constexpr int NC = HD / 16;  // output columns per thread
  // of which in runs of 4 (float4s): all of them unless HD % 64 != 0
  static constexpr int NV4 = HD >= 64 ? 4 * (HD / 64) : 0;
  static constexpr int KREG = HD / 16;  // float4s of K per thread per tile
  static constexpr int VB = HD == 256 ? 1 : 2;  // V tile buffers
  // shared floats: Qt, Kt, Vs (VB buffers), Pt; then BQ int positions
  static constexpr int kQt = HD * BQ, kKt = HD * kBK, kVs = VB * kBK * HD,
                       kPt = kBK * BQ;
  static constexpr size_t kSmem = sizeof(float) * (kQt + kKt + kVs + kPt) +
                                  sizeof(int) * BQ;
};

// hd-major tiles: element (d, n) of a [HD][N] array, its 4-element chunks
// along n XOR-ed by an even number that cycles every 16 rows of d.
__device__ __forceinline__ int hdm_sw(int d) { return (d >> 1) & 6; }
template <int N>
__device__ __forceinline__ int hdm_index(int d, int n) {
  return d * N + 4 * ((n >> 2) ^ hdm_sw(d)) + (n & 3);
}

// Output column of a thread's e-th value (e < HD / 16): runs of 4 at
// 4 tx + 64 (e / 4) for the first NV4 = 4 (HD / 64) values, then (hd
// 112) single columns at 64 (HD / 64) + 16 (e - NV4) + tx; pairs at 2 tx
// for hd 32.  A warp's loads of a V row and its stores of an output row
// are contiguous.
template <int HD>
__device__ __forceinline__ int f32_col(int tx, int e) {
  constexpr int NV4 = F32Cfg<HD>::NV4;
  if constexpr (HD < 64) return 2 * tx + e;
  if (e < NV4) return 64 * (e / 4) + 4 * tx + (e % 4);
  return 64 * (HD / 64) + 16 * (e - NV4) + tx;
}

// Rows [row0, row0 + NR) of a (rows, stride) fp32 matrix, HD wide, in
// units of 8 rows x 4 chunks of 4 (one warp each): lane -> (row = 8 rg +
// lane % 8, chunk = 4 cg + lane / 8), so a warp reads 64 contiguous bytes
// of 8 rows.  Rows past n_rows read as 0.
template <int HD, int NR>
struct F32Stage {
  static constexpr int kUnits = (NR / 8) * (HD / 16);
  static constexpr int kPerThread = kUnits / 8;  // 8 warps
  static_assert(kUnits % 8 == 0, "whole passes of 8 warps");

  __device__ __forceinline__ static void unit(int p, int& row, int& c) {
    const int u = p * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    row = (u % (NR / 8)) * 8 + (lane & 7);
    c = (u / (NR / 8)) * 4 + (lane >> 3);
  }
  __device__ __forceinline__ static void load(float4 (&r)[kPerThread],
                                              const float* src,
                                              size_t stride, int row0,
                                              int n_rows) {
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      int row, c;
      unit(p, row, c);
      r[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + row < n_rows)
        r[p] = __ldg(reinterpret_cast<const float4*>(
            src + static_cast<size_t>(row0 + row) * stride + 4 * c));
    }
  }
  // transposed into a [HD][NR] hd-major array
  __device__ __forceinline__ static void store(float* dst,
                                               const float4 (&r)[kPerThread]) {
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      int row, c;
      unit(p, row, c);
      dst[hdm_index<NR>(4 * c + 0, row)] = r[p].x;
      dst[hdm_index<NR>(4 * c + 1, row)] = r[p].y;
      dst[hdm_index<NR>(4 * c + 2, row)] = r[p].z;
      dst[hdm_index<NR>(4 * c + 3, row)] = r[p].w;
    }
  }
};

// V tile rows [k0, k0 + 64) -> Vs row-major by cp.async; rows past Skv
// are zero-filled, so 0 * v never meets garbage.
template <int HD>
__device__ __forceinline__ void f32_load_v(float* dst, const float* vb,
                                           size_t stride, int k0, int Skv) {
  constexpr int CH = HD / 4;
#pragma unroll
  for (int i = 0; i < kBK * CH / 256; ++i) {
    const int idx = i * 256 + threadIdx.x;
    const int r = idx / CH, c = idx % CH;
    const bool ok = k0 + r < Skv;
    const float* src =
        ok ? vb + static_cast<size_t>(k0 + r) * stride + 4 * c : vb;
    cp_async16(dst + r * HD + 4 * c, src, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(256, HD > 64 ? 1 : 2)
fa_fwd_f32(const Args a) {
  using C = F32Cfg<HD>;
  constexpr int BQ = C::BQ, RM = C::RM, NC = C::NC, VB = C::VB;
  constexpr int NV4 = C::NV4;
  using QStage = F32Stage<HD, BQ>;
  using KStage = F32Stage<HD, kBK>;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + C::kQt;
  float* Vs = Kt + C::kKt;
  float* Pt = Vs + C::kVs;
  int* Qp = reinterpret_cast<int*>(Pt + C::kPt);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = warp * 2 + (lane >> 4);
  const int h = blockIdx.x;
  const int q0 = static_cast<int>(gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int Sq = a.Sq, Skv = a.Skv;

  const size_t q_stride = static_cast<size_t>(a.H) * HD;
  const size_t kv_stride = static_cast<size_t>(a.KV) * HD;
  const float* qb = static_cast<const float*>(a.q) +
                    (static_cast<size_t>(b) * Sq * a.H + h) * HD;
  const float* kb = static_cast<const float*>(a.k) +
                    (static_cast<size_t>(b) * Skv * a.KV + kvh) * HD;
  const float* vb = static_cast<const float*>(a.v) +
                    (static_cast<size_t>(b) * Skv * a.KV + kvh) * HD;
  const int* qpb = a.q_pos + static_cast<size_t>(b) * Sq;
  const int* kpb = a.k_pos + static_cast<size_t>(b) * Skv;

  const TileRange tr = tile_range(a, q0, min(q0 + BQ, Sq) - 1);
  // this warp's live rows (two row groups of RM)
  const int w_lo = q0 + warp * 2 * RM;
  const int w_hi = min(w_lo + 2 * RM, Sq) - 1;
  const bool w_live = w_lo < Sq;

  {
    float4 qr[QStage::kPerThread];
    QStage::load(qr, qb, q_stride, q0, Sq);
    QStage::store(Qt, qr);
  }
  for (int r = threadIdx.x; r < BQ; r += C::kThreads)
    Qp[r] = q0 + r < Sq ? qpb[q0 + r] : 0;
  float4 kr[C::KREG];
  if (tr.lo <= tr.hi) {
    KStage::load(kr, kb, kv_stride, tr.lo * kBK, Skv);
    KStage::store(Kt, kr);
    f32_load_v<HD>(Vs, vb, kv_stride, tr.lo * kBK, Skv);
  }
  cp_async_commit();
  __syncthreads();

  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[i][e] = 0.f;
  }
  // chunk offsets of this thread's rows in Qt and keys in Kt, for the
  // four swizzle values 2 s
  int qoff[4], koff[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    qoff[s] = 4 * ((ty * (RM / 4)) ^ (2 * s));
    koff[s] = 4 * (tx ^ (2 * s));
  }

  int buf = 0;
  for (int kt = tr.lo; kt <= tr.hi; ++kt, buf ^= 1) {
    const int k0 = kt * kBK;
    const bool has_next = kt < tr.hi;
    if (has_next) {  // in flight while this tile is used
      KStage::load(kr, kb, kv_stride, k0 + kBK, Skv);
      if constexpr (VB == 2)
        f32_load_v<HD>(Vs + (buf ^ 1) * kBK * HD, vb, kv_stride, k0 + kBK,
                       Skv);
    }
    if constexpr (VB == 2) cp_async_commit();
    const bool active = w_live && !warp_skips(a, k0, w_hi);

    if (active) {
      // s[i][j] = q[row i] . k[key j], in order over hd
      float s[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 16) {
#pragma unroll
        for (int dd = 0; dd < 16; ++dd) {
          const int d = d0 + dd;
          const float4 kv4 = *reinterpret_cast<const float4*>(
              Kt + d * kBK + koff[dd >> 2]);
          const float kk[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
          float qq[RM];
#pragma unroll
          for (int u = 0; u < RM / 4; ++u) {
            const float4 t = *reinterpret_cast<const float4*>(
                Qt + d * BQ + qoff[dd >> 2] + 4 * u);
            qq[4 * u] = t.x; qq[4 * u + 1] = t.y;
            qq[4 * u + 2] = t.z; qq[4 * u + 3] = t.w;
          }
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
        }
      }

      // scale, mask (edge tiles only), online softmax; P^T to shared
      const bool full = tile_full(a, k0, w_lo, w_hi);
      int kp[4];
      bool in_seq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * tx + j;
        in_seq[j] = key < Skv;
        kp[j] = (!full && in_seq[j]) ? __ldg(kpb + key) : 0;
      }
      float p[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qp = Qp[ty * RM + i];
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float val = s[i][j] * a.scale;
          if (!full) {
            if (!in_seq[j])
              val = -CUDART_INF_F;  // past the sequence: adds exactly 0
            else if (!visible(a, qp, kp[j]))
              val = kMasked;
          }
          s[i][j] = val;
          mx = fmaxf(mx, val);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)  // the 16 lanes of this row
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float corr = ex2((m[i] - mx) * kLog2e);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = ex2((s[i][j] - mx) * kLog2e);
          sum += p[i][j];
        }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int e = 0; e < NC; ++e) acc[i][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = 4 * tx + j;
#pragma unroll
        for (int u = 0; u < RM / 4; ++u) {
          const int ch = (ty * (RM / 4) + u) ^ (tx & 7);
          *reinterpret_cast<float4*>(Pt + key * BQ + 4 * ch) =
              make_float4(p[4 * u][j], p[4 * u + 1][j], p[4 * u + 2][j],
                          p[4 * u + 3][j]);
        }
      }
    }

    cp_async_wait<VB - 1>();  // this tile's V has landed (the next may not)
    __syncthreads();          // P^T written; every read of Kt done
    if (has_next) KStage::store(Kt, kr);

    if (active) {
      const float* vt = Vs + (VB == 2 ? buf : 0) * kBK * HD;
#pragma unroll 1
      for (int c0 = 0; c0 < kBK; c0 += 32) {
#pragma unroll
        for (int cc = 0; cc < 32; ++cc) {
          const int key = c0 + cc;
          float pr[RM];
#pragma unroll
          for (int u = 0; u < RM / 4; ++u) {  // c0 % 32 == 0
            const int ch = (ty * (RM / 4) + u) ^ ((cc >> 2) & 7);
            const float4 t =
                *reinterpret_cast<const float4*>(Pt + key * BQ + 4 * ch);
            pr[4 * u] = t.x; pr[4 * u + 1] = t.y;
            pr[4 * u + 2] = t.z; pr[4 * u + 3] = t.w;
          }
          float vv[NC];
          const float* vrow = vt + key * HD;
          if constexpr (HD >= 64) {
#pragma unroll
            for (int e = 0; e < NV4; e += 4) {
              const float4 t = *reinterpret_cast<const float4*>(
                  vrow + f32_col<HD>(tx, e));
              vv[e] = t.x; vv[e + 1] = t.y; vv[e + 2] = t.z; vv[e + 3] = t.w;
            }
#pragma unroll
            for (int e = NV4; e < NC; ++e) vv[e] = vrow[f32_col<HD>(tx, e)];
          } else {
            const float2 t =
                *reinterpret_cast<const float2*>(vrow + f32_col<HD>(tx, 0));
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int e = 0; e < NC; ++e)
              acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // P^T and this V buffer read; next Kt visible
    if constexpr (VB == 1) {  // the one V buffer is free: the next tile's
      if (has_next) f32_load_v<HD>(Vs, vb, kv_stride, k0 + kBK, Skv);
      cp_async_commit();
    }
  }

  cp_async_wait<0>();  // nothing left in flight at exit
  if (!w_live) return;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float den = l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
    den = fmaxf(den, 1e-30f);
    const int r = q0 + ty * RM + i;
    if (r >= Sq) continue;
    float* orow = static_cast<float*>(a.out) +
                  ((static_cast<size_t>(b) * Sq + r) * a.H + h) * HD;
    if constexpr (HD >= 64) {
#pragma unroll
      for (int e = 0; e < NV4; e += 4)
        *reinterpret_cast<float4*>(orow + f32_col<HD>(tx, e)) =
            make_float4(acc[i][e] / den, acc[i][e + 1] / den,
                        acc[i][e + 2] / den, acc[i][e + 3] / den);
#pragma unroll
      for (int e = NV4; e < NC; ++e)
        orow[f32_col<HD>(tx, e)] = acc[i][e] / den;
    } else {
      *reinterpret_cast<float2*>(orow + f32_col<HD>(tx, 0)) =
          make_float2(acc[i][0] / den, acc[i][1] / den);
    }
  }
}

}  // namespace fa
