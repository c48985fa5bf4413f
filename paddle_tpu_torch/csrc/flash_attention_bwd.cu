// Flash-attention backward for Hopper (sm_90a): dq and dk/dv, fp32, bf16
// or fp16 in, fp32 accumulate; each in two variants that the Python
// wrapper chooses from the dtype and head dim, never after a failure. What
// they replace, what bounds them and how the design answers that: see
// paddle_tpu_torch/ops/kernels/flash_attention.py.
//
// Layout: q, dout, dq [b, sq, h, d]; k, v, dk, dv [b, sk, hk, d]; lse and
// delta = rowsum(dout * out) [b, h, sq] fp32; segment ids [b, s] int32
// (optional, sq == sk). Query head hh reads kv head hh / (h / hk).
//
// All kernels recompute the scores with the forward's conventions (finite
// -1e30 mask, causal aligned bottom-right by sk - sq, window band, segment
// equality with pad = 0), form p = exp(s - lse) and
// ds = p * (dp - delta) * scale with dp = dout . v, and round where the TPU
// kernels round: p to dout's type before p^T dout, ds to q/k's type before
// ds K and ds^T q; outputs are cast once at the end. The mask, lse, delta,
// p and ds stay in fp32 registers until those casts, so fp16's range (no
// finite -1e30) never meets the mask. Every output element is written by
// exactly one block and summed in a fixed order: no atomics, so two runs
// give the same bits.
//
// dq, wgmma (bf16 or fp16, d in {64, 128}): one block per (batch*head,
// 128-row q tile), the last q tiles launched first: two consumer
// warpgroups of 64 rows each and a producer warpgroup, which hands its
// registers to them (setmaxnreg) and of which one thread works. It loads
// the Q and dout tiles once by TMA, then streams 64-key tiles of the kv
// head's K and V through a ring of 4 shared-memory stages (TMA, 128-byte
// swizzle, mbarriers); tiles wholly outside the live band are never
// loaded. A thread's accumulator rows are fixed q rows, so it holds their
// lse and delta in registers. Per tile a warpgroup forms S = Q K^T and
// dP = dout V^T with wgmma (m64n64k16, operands K-major), p and ds on the
// fp32 fragments (the masks only on tiles that cross the diagonal, the
// window edge, sk or a segment), and dQ += dS K with wgmma whose A is ds
// rounded to T pairs in registers and whose B = K takes the transpose bit.
// A tile's S and dP are issued before the last tile's dS K, so forming one
// tile's ds overlaps the other's product. dQ (64 x d fp32) stays in
// registers and is cast and stored once.
//
// dq, simt (fp32, or d = 256): one block of 4 warps per (batch*head, q
// tile). The block keeps its q and dout rows (packed words, read as
// broadcasts) and its fp32 dq accumulator in shared memory and loops over
// the kv tiles the masks leave live, staged as packed words with an odd
// stride. Each warp owns BQ/4 rows and works on 4 at a time: lane i scores
// keys i and i+32 (s and dp in one pass over d), then in the ds K product
// owns a strip of head dims.
//
// dk/dv, wgmma (bf16 or fp16, d in {64, 128}): one block per (batch*kv
// head, 128-key tile): two consumer warpgroups of 64 keys each and a
// producer warpgroup, which hands its registers to them (setmaxnreg) and
// of which one warp works. It loads the K and V tiles once by TMA, then
// streams 64-row tiles of q and dout through a ring of shared-memory
// stages (TMA, 128-byte swizzle, mbarriers) over the GQA group's query
// heads and, for each, its live q tiles, and stages each tile's lse, delta
// and segment ids beside them; both warpgroups read every stage. Per tile
// a warpgroup forms S^T = K Q^T and dP^T = V dout^T with wgmma
// (m64n64k16, operands K-major in shared memory), p^T and ds^T on the fp32
// fragments, and dV += P^T dout, dK += dS^T Q with wgmma whose A is that
// fragment rounded to T pairs in registers and whose B (dout or q) takes
// the transpose bit. dK and dV stay in registers (64 x d fp32 each) and
// are cast and stored once.
//
// dk/dv, simt (fp32, or d = 256): one block of 4 warps per (batch*kv
// head, kv tile). K and V (packed words) and the two fp32 accumulators
// stay in shared memory; the block loops over the GQA group's query heads
// and, for each, over the live q tiles, staged as packed words with an
// odd stride. The roles of rows and keys swap: each warp owns BK/4 keys,
// lane i takes q rows i and i+32, and the p^T dout and ds^T q products run
// with lanes on strips of head dims.
//
// The simt tiles are sized so that two blocks fit an SM's shared memory in
// 16-bit types at d <= 128 (8 warps in flight per SM).
#include "hopper.cuh"

namespace {

using ptt::Elt;
using ptt::NEG_INF;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int R = 4;  // rows (dq) or keys (dk/dv) a warp handles at once

// a [rows][KW] tile of T elements from global memory into shared words with
// row stride KS; rows past `limit` are zero
template <typename T, int D>
__device__ inline void stage_words(uint32_t* dst, int ks, const T* src,
                                   size_t row_stride, int row0, int rows,
                                   int limit, int tid) {
  constexpr int KW = D * static_cast<int>(sizeof(T)) / 4;
  for (int i = tid; i < rows * (KW / 4); i += THREADS) {
    const int j = i / (KW / 4), c = i % (KW / 4);
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + j < limit)
      x = reinterpret_cast<const uint4*>(src + (size_t)(row0 + j) *
                                                   row_stride)[c];
    uint32_t* d = dst + j * ks + 4 * c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

__device__ inline bool live(int row, int key, int off, int causal,
                            int window) {
  if (!causal) return true;
  if (row + off < key) return false;
  return window <= 0 || row + off - key < window;
}

// ------------------------------------------------------------------- dq
template <typename T, int D>
struct DqGeometry {
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int BK = (sizeof(T) == 4 && D == 256) ? 32 : 64;
  static constexpr int KW = D * static_cast<int>(sizeof(T)) / 4;
  static constexpr int KS = KW + 1;
  static constexpr size_t SMEM = sizeof(float) * (BQ * D + WARPS * BK * R) +
                                 sizeof(uint32_t) * 2 * (BQ * KW + BK * KS) +
                                 sizeof(int) * BK;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg, T* __restrict__ dq,
                        int sq, int sk, int h, int hk, float scale,
                        int causal, int window) {
  using G = DqGeometry<T, D>;
  constexpr int BQ = G::BQ, BK = G::BK, KW = G::KW, KS = G::KS;
  constexpr int E = Elt<T>::PER_WORD;
  constexpr int NC = BK / 32;              // keys per lane in a tile
  constexpr int WPL = KW / 32;             // K words per lane in ds K
  constexpr int ROWS_PER_WARP = BQ / WARPS;
  constexpr int PASSES = ROWS_PER_WARP / R;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Acc = reinterpret_cast<float*>(smem);       // [BQ][D] dq
  float* Ds = Acc + BQ * D;                          // [WARPS][BK][R]
  uint32_t* Qw = reinterpret_cast<uint32_t*>(Ds + WARPS * BK * R);
  uint32_t* Gw = Qw + BQ * KW;                       // [BQ][KW]
  uint32_t* Kw = Gw + BQ * KW;                       // [BK][KS]
  uint32_t* Vw = Kw + BK * KS;                       // [BK][KS]
  int* kseg = reinterpret_cast<int*>(Vw + BK * KS);  // [BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kvh = hh / (h / hk);
  // the last q tiles see the most keys under the causal mask: launched
  // first, so the longest blocks do not trail the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int off = sk - sq;
  const size_t qstride = (size_t)h * D, kstride = (size_t)hk * D;
  const T* qb = q + ((size_t)b * sq * h + hh) * D;
  const T* gb = g + ((size_t)b * sq * h + hh) * D;
  const T* kb = k + ((size_t)b * sk * hk + kvh) * D;
  const T* vb = v + ((size_t)b * sk * hk + kvh) * D;

  stage_words<T, D>(Qw, KW, qb, qstride, q0, BQ, sq, tid);
  stage_words<T, D>(Gw, KW, gb, qstride, q0, BQ, sq, tid);
  for (int i = tid; i < BQ * D; i += THREADS) Acc[i] = 0.f;

  float lse_r[PASSES][R], del_r[PASSES][R];
  int seg_r[PASSES][R];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + warp * ROWS_PER_WARP + p * R + r;
      const bool ok = row < sq;
      lse_r[p][r] = ok ? lse[(size_t)bh * sq + row] : 0.f;
      del_r[p][r] = ok ? delta[(size_t)bh * sq + row] : 0.f;
      seg_r[p][r] = (ok && seg != nullptr) ? seg[(size_t)b * sq + row] : 0;
    }

  int hi = sk, lo = 0;
  if (causal) {
    hi = min(sk, q0 + BQ + off);
    if (window > 0) lo = max(0, q0 + off - (window - 1));
  }
  lo = (lo / BK) * BK;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the last tile's readers are done with Kw/Vw/kseg
    stage_words<T, D>(Kw, KS, kb, kstride, k0, BK, sk, tid);
    stage_words<T, D>(Vw, KS, vb, kstride, k0, BK, sk, tid);
    if (seg != nullptr)
      for (int j = tid; j < BK; j += THREADS)
        kseg[j] = k0 + j < sk ? seg[(size_t)b * sk + k0 + j] : -1;
    __syncthreads();

#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int rbase = warp * ROWS_PER_WARP + pass * R;
      float s[R][NC], dp[R][NC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[r][c] = dp[r][c] = 0.f;

#pragma unroll 2
      for (int w = 0; w < KW; ++w) {
        float kf[NC][E], vf[NC][E];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          Elt<T>::unpack(Kw[(lane + 32 * c) * KS + w], kf[c]);
          Elt<T>::unpack(Vw[(lane + 32 * c) * KS + w], vf[c]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float qf[E], gf[E];
          Elt<T>::unpack(Qw[(rbase + r) * KW + w], qf);
          Elt<T>::unpack(Gw[(rbase + r) * KW + w], gf);
#pragma unroll
          for (int e = 0; e < E; ++e)
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              s[r][c] = fmaf(qf[e], kf[c][e], s[r][c]);
              dp[r][c] = fmaf(gf[e], vf[c][e], dp[r][c]);
            }
        }
      }

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = q0 + rbase + r;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int key = k0 + lane + 32 * c;
          bool keep = live(row, key, off, causal, window);
          if (seg != nullptr) keep = keep && kseg[lane + 32 * c] ==
                                                 seg_r[pass][r];
          const float sm = keep ? s[r][c] * scale : NEG_INF;
          const float p = (row < sq && key < sk)
                              ? expf(sm - lse_r[pass][r]) : 0.f;
          const float ds = p * (dp[r][c] - del_r[pass][r]) * scale;
          // ds goes through K's type before the ds K product
          Ds[(warp * BK + lane + 32 * c) * R + r] = Elt<T>::round(ds);
        }
      }
      __syncwarp();

      float acc[R][WPL * E];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < WPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][i * E + e] = Acc[(rbase + r) * D + (lane + 32 * i) * E + e];
      const float* dw = Ds + warp * BK * R;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 d4 = *reinterpret_cast<const float4*>(dw + j * R);
        const float dr[R] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int i = 0; i < WPL; ++i) {
          float kf[E];
          Elt<T>::unpack(Kw[j * KS + lane + 32 * i], kf);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][i * E + e] = fmaf(dr[r], kf[e], acc[r][i * E + e]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < WPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            Acc[(rbase + r) * D + (lane + 32 * i) * E + e] = acc[r][i * E + e];
      __syncwarp();  // Ds is rewritten by the next pass
    }
  }
  __syncthreads();

  T* dqb = dq + ((size_t)b * sq * h + hh) * D;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = q0 + i / D;
    if (row < sq) dqb[(size_t)row * qstride + i % D] = Elt<T>::from_float(Acc[i]);
  }
}

// ---------------------------------------------------------------- dk/dv
template <typename T, int D>
struct DkvGeometry {
  static constexpr int BK = D == 64 ? 64 : 32;
  static constexpr int BQ = (sizeof(T) == 4 && D == 256) ? 32 : 64;
  static constexpr int KW = D * static_cast<int>(sizeof(T)) / 4;
  static constexpr int KS = KW + 1;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BK * D + 2 * WARPS * BQ * R + 2 * BQ) +
      sizeof(uint32_t) * 2 * (BK * KW + BQ * KS) + sizeof(int) * BQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, int h, int hk,
                         float scale, int causal, int window) {
  using G = DkvGeometry<T, D>;
  constexpr int BQ = G::BQ, BK = G::BK, KW = G::KW, KS = G::KS;
  constexpr int E = Elt<T>::PER_WORD;
  constexpr int NC = BQ / 32;              // q rows per lane in a tile
  constexpr int WPL = KW / 32;
  constexpr int KEYS_PER_WARP = BK / WARPS;
  constexpr int PASSES = KEYS_PER_WARP / R;

  extern __shared__ __align__(16) unsigned char smem[];
  float* dKs = reinterpret_cast<float*>(smem);       // [BK][D]
  float* dVs = dKs + BK * D;                         // [BK][D]
  float* Pp = dVs + BK * D;                          // [WARPS][BQ][R] p
  float* Pd = Pp + WARPS * BQ * R;                   // [WARPS][BQ][R] ds
  float* lse_s = Pd + WARPS * BQ * R;                // [BQ]
  float* del_s = lse_s + BQ;                         // [BQ]
  uint32_t* Kw = reinterpret_cast<uint32_t*>(del_s + BQ);  // [BK][KW]
  uint32_t* Vw = Kw + BK * KW;                             // [BK][KW]
  uint32_t* Qw = Vw + BK * KW;                             // [BQ][KS]
  uint32_t* Gw = Qw + BQ * KS;                             // [BQ][KS]
  int* qseg = reinterpret_cast<int*>(Gw + BQ * KS);        // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bkv = blockIdx.x;
  const int b = bkv / hk, kvh = bkv % hk, group = h / hk;
  // the first kv tiles are seen by the most q rows under the causal mask:
  // they are launched first
  const int k0 = blockIdx.y * BK;
  const int off = sk - sq;
  const size_t qstride = (size_t)h * D, kstride = (size_t)hk * D;
  const T* kb = k + ((size_t)b * sk * hk + kvh) * D;
  const T* vb = v + ((size_t)b * sk * hk + kvh) * D;

  stage_words<T, D>(Kw, KW, kb, kstride, k0, BK, sk, tid);
  stage_words<T, D>(Vw, KW, vb, kstride, k0, BK, sk, tid);
  for (int i = tid; i < BK * D; i += THREADS) dKs[i] = dVs[i] = 0.f;

  int kseg_r[PASSES][R];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = k0 + warp * KEYS_PER_WARP + p * R + r;
      kseg_r[p][r] =
          (seg != nullptr && key < sk) ? seg[(size_t)b * sk + key] : -1;
    }

  // q rows any key of this tile may be attended by
  int lo = 0, hi = sq;
  if (causal) {
    lo = max(0, k0 - off);
    if (window > 0) hi = min(sq, k0 + BK + window - 1 - off);
  }
  lo = (lo / BQ) * BQ;

  for (int gi = 0; gi < group; ++gi) {
    const int hh = kvh * group + gi;
    const int bh = b * h + hh;
    const T* qb = q + ((size_t)b * sq * h + hh) * D;
    const T* gb = g + ((size_t)b * sq * h + hh) * D;
    for (int q0 = lo; q0 < hi; q0 += BQ) {
      __syncthreads();  // the last tile's readers are done with Qw/Gw/...
      stage_words<T, D>(Qw, KS, qb, qstride, q0, BQ, sq, tid);
      stage_words<T, D>(Gw, KS, gb, qstride, q0, BQ, sq, tid);
      for (int j = tid; j < BQ; j += THREADS) {
        const int row = q0 + j;
        const bool ok = row < sq;
        lse_s[j] = ok ? lse[(size_t)bh * sq + row] : 0.f;
        del_s[j] = ok ? delta[(size_t)bh * sq + row] : 0.f;
        qseg[j] = (ok && seg != nullptr) ? seg[(size_t)b * sq + row] : -2;
      }
      __syncthreads();

#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int kbase = warp * KEYS_PER_WARP + pass * R;
        float s[R][NC], dp[R][NC];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) s[r][c] = dp[r][c] = 0.f;

#pragma unroll 2
        for (int w = 0; w < KW; ++w) {
          float qf[NC][E], gf[NC][E];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            Elt<T>::unpack(Qw[(lane + 32 * c) * KS + w], qf[c]);
            Elt<T>::unpack(Gw[(lane + 32 * c) * KS + w], gf[c]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float kf[E], vf[E];
            Elt<T>::unpack(Kw[(kbase + r) * KW + w], kf);
            Elt<T>::unpack(Vw[(kbase + r) * KW + w], vf);
#pragma unroll
            for (int e = 0; e < E; ++e)
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                s[r][c] = fmaf(kf[e], qf[c][e], s[r][c]);
                dp[r][c] = fmaf(vf[e], gf[c][e], dp[r][c]);
              }
          }
        }

#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int key = k0 + kbase + r;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int j = lane + 32 * c;
            const int row = q0 + j;
            bool keep = live(row, key, off, causal, window);
            if (seg != nullptr) keep = keep && qseg[j] == kseg_r[pass][r];
            const float sm = keep ? s[r][c] * scale : NEG_INF;
            const float p = (row < sq && key < sk) ? expf(sm - lse_s[j])
                                                   : 0.f;
            const float ds = p * (dp[r][c] - del_s[j]) * scale;
            // p goes through dout's type before p^T dout, ds through q's
            // before ds^T q
            Pp[(warp * BQ + j) * R + r] = Elt<T>::round(p);
            Pd[(warp * BQ + j) * R + r] = Elt<T>::round(ds);
          }
        }
        __syncwarp();

        // dv += p^T dout, then dk += ds^T q: lanes on strips of head dims
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          float* A = which == 0 ? dVs : dKs;
          const float* pw = (which == 0 ? Pp : Pd) + warp * BQ * R;
          const uint32_t* X = which == 0 ? Gw : Qw;
          float acc[R][WPL * E];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < WPL; ++i)
#pragma unroll
              for (int e = 0; e < E; ++e)
                acc[r][i * E + e] =
                    A[(kbase + r) * D + (lane + 32 * i) * E + e];
#pragma unroll 4
          for (int j = 0; j < BQ; ++j) {
            const float4 p4 = *reinterpret_cast<const float4*>(pw + j * R);
            const float pr[R] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int i = 0; i < WPL; ++i) {
              float xf[E];
              Elt<T>::unpack(X[j * KS + lane + 32 * i], xf);
#pragma unroll
              for (int r = 0; r < R; ++r)
#pragma unroll
                for (int e = 0; e < E; ++e)
                  acc[r][i * E + e] = fmaf(pr[r], xf[e], acc[r][i * E + e]);
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < WPL; ++i)
#pragma unroll
              for (int e = 0; e < E; ++e)
                A[(kbase + r) * D + (lane + 32 * i) * E + e] =
                    acc[r][i * E + e];
        }
        __syncwarp();  // Pp/Pd are rewritten by the next pass
      }
    }
  }
  __syncthreads();

  T* dkb = dk + ((size_t)b * sk * hk + kvh) * D;
  T* dvb = dv + ((size_t)b * sk * hk + kvh) * D;
  for (int i = tid; i < BK * D; i += THREADS) {
    const int key = k0 + i / D;
    if (key >= sk) continue;
    const size_t at = (size_t)key * kstride + i % D;
    dkb[at] = Elt<T>::from_float(dKs[i]);
    dvb[at] = Elt<T>::from_float(dVs[i]);
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int* seg;
  int b, sq, sk, h, hk;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const size_t smem = DqGeometry<T, D>::SMEM;
  auto kernel = flash_bwd_dq_simt_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = DqGeometry<T, D>::BQ;
  const dim3 grid(a.b * a.h, (a.sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.seg, static_cast<T*>(dq), a.sq, a.sk, a.h, a.hk, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = DkvGeometry<T, D>::SMEM;
  auto kernel = flash_bwd_dkv_simt_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int BK = DkvGeometry<T, D>::BK;
  const dim3 grid(a.b * a.hk, (a.sk + BK - 1) / BK);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      a.seg, static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk, a.h, a.hk,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const Args& a, void* o0, void* o1) {
  const bool dq = o1 == nullptr;
  switch (d) {
    case 64:
      return dq ? launch_dq<T, 64>(a, o0) : launch_dkv<T, 64>(a, o0, o1);
    case 128:
      return dq ? launch_dq<T, 128>(a, o0) : launch_dkv<T, 128>(a, o0, o1);
    case 256:
      return dq ? launch_dq<T, 256>(a, o0) : launch_dkv<T, 256>(a, o0, o1);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* g,
        const void* lse, const void* delta, const void* seg, void* o0,
        void* o1, int b, int sq, int sk, int h, int hk, int d, float scale,
        int causal, int window, int dtype, void* stream) {
  const Args a{q, k, v, g,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(seg), b, sq, sk, h, hk, scale, causal,
               window, static_cast<cudaStream_t>(stream)};
  return ptt::by_dtype(dtype, [&](auto tag) {
    return dispatch<typename decltype(tag)::type>(d, a, o0, o1);
  });
}

// ------------------------------------------------------- dk/dv on wgmma
namespace wg {

constexpr int BK = 128;                // keys per block: 64 a warpgroup
constexpr int BQ = 64;                 // q rows per streamed tile
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 3;
constexpr int ROW_BYTES = 128;         // one half-row: 64 bf16 or fp16
constexpr int Q_HALF = BQ * ROW_BYTES;   // one half of a q or dout tile
constexpr int KV_HALF = BK * ROW_BYTES;  // one half of the K or V tile

template <int D>
struct Smem {
  static constexpr int Q_TILE = (D / 64) * Q_HALF;    // 64 rows x D
  static constexpr int KV_TILE = (D / 64) * KV_HALF;  // 128 rows x D
  // 1024 for the alignment of the swizzled tiles; K, V; the Q and dout
  // stages; lse, delta and q segment ids per stage; the barriers (K/V's,
  // and full / empty per stage)
  static constexpr size_t BYTES = 1024 + 2 * KV_TILE + 2 * STAGES * Q_TILE +
                                  3 * STAGES * BQ * 4 + 8 * (1 + 2 * STAGES);
};

}  // namespace wg

template <typename T, int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ seg,
                               T* __restrict__ dk, T* __restrict__ dv, int sq,
                               int sk,
                               int h, int hk, float scale, int causal,
                               int window) {
  using S = wg::Smem<D>;
  constexpr int BQ = wg::BQ, BK = wg::BK, STAGES = wg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = ptt::align1024(smem_raw);
  unsigned char* Vs = Ks + S::KV_TILE;
  unsigned char* Qs = Vs + S::KV_TILE;           // [STAGES] tiles
  unsigned char* Gs = Qs + STAGES * S::Q_TILE;   // [STAGES] tiles
  float* lse_s = reinterpret_cast<float*>(Gs + STAGES * S::Q_TILE);
  float* del_s = lse_s + STAGES * BQ;
  int* qseg_s = reinterpret_cast<int*>(del_s + STAGES * BQ);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(qseg_s + STAGES * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int bkv = blockIdx.x;
  const int b = bkv / hk, kvh = bkv % hk, group = h / hk;
  // the first kv tiles are seen by the most q rows under the causal mask:
  // they are launched first
  const int k0 = blockIdx.y * BK;
  const int off = sk - sq;
  // q rows any key of this tile may be attended by
  int lo = 0, hi = sq;
  if (causal) {
    lo = max(0, k0 - off);
    if (window > 0) hi = min(sq, k0 + BK + window - 1 - off);
  }
  lo = (lo / BQ) * BQ;
  const int nq = hi > lo ? (hi - lo + BQ - 1) / BQ : 0;
  const int n = group * nq;  // q tiles: the group's heads, then their rows

  if (tid == 0) {
    ptt::mbar_init(kvbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      ptt::mbar_init(full + st, 1 + 32);  // the TMA's and the warp's rows
      ptt::mbar_init(empty + st, wg::CONSUMERS * 128);
    }
    ptt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= wg::CONSUMERS * 128) {  // the producer warpgroup
    ptt::setmaxnreg_dec<wg::PRODUCER_REGS>();
    if (tid >= wg::CONSUMERS * 128 + 32) return;  // one warp is enough
    if (lane == 0) {
      ptt::mbar_arrive_tx(kvbar, 2 * S::KV_TILE);
      for (int half = 0; half < D / 64; ++half) {
        ptt::tma_load_4d(Ks + half * wg::KV_HALF, &tk, kvbar, 64 * half, kvh,
                         k0, b);
        ptt::tma_load_4d(Vs + half * wg::KV_HALF, &tv, kvbar, 64 * half, kvh,
                         k0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      const int hh = kvh * group + i / nq, q0 = lo + (i % nq) * BQ;
      const int bh = b * h + hh;
      ptt::mbar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {
        ptt::mbar_arrive_tx(full + st, 2 * S::Q_TILE);
        for (int half = 0; half < D / 64; ++half) {
          ptt::tma_load_4d(Qs + st * S::Q_TILE + half * wg::Q_HALF, &tq,
                           full + st, 64 * half, hh, q0, b);
          ptt::tma_load_4d(Gs + st * S::Q_TILE + half * wg::Q_HALF, &tg,
                           full + st, 64 * half, hh, q0, b);
        }
      }
      for (int j = lane; j < BQ; j += 32) {
        const int row = q0 + j;
        const bool ok = row < sq;
        lse_s[st * BQ + j] = ok ? lse[(size_t)bh * sq + row] : 0.f;
        del_s[st * BQ + j] = ok ? delta[(size_t)bh * sq + row] : 0.f;
        qseg_s[st * BQ + j] =
            (ok && seg != nullptr) ? seg[(size_t)b * sq + row] : -2;
      }
      ptt::mbar_arrive(full + st);
    }
    return;
  }

  // a consumer warpgroup, on keys wgi*64 .. +63 of the tile: this thread
  // owns keys kr and kr + 8 (rows of the accumulator fragments, see
  // hopper.cuh); the columns of S^T and dP^T are q rows
  ptt::setmaxnreg_inc<wg::CONSUMER_REGS>();
  const int wgi = tid / 128, w = (tid & 127) / 32, quad = lane & 3;
  const unsigned char* kt = Ks + wgi * 64 * wg::ROW_BYTES;
  const unsigned char* vt = Vs + wgi * 64 * wg::ROW_BYTES;
  int key[2], kseg[2];
  key[0] = k0 + wgi * 64 + w * 16 + lane / 4;
  key[1] = key[0] + 8;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kseg[r] = (seg != nullptr && key[r] < sk) ? seg[(size_t)b * sk + key[r]]
                                              : -1;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  ptt::mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, q0 = lo + (i % nq) * BQ;
    const unsigned char* qt = Qs + st * S::Q_TILE;
    const unsigned char* gt = Gs + st * S::Q_TILE;
    ptt::mbar_wait(full + st, (i / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dout^T, both operands K-major
    float sT[BQ / 2], dpT[BQ / 2];
    ptt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = (kk / 4) * wg::KV_HALF + (kk % 4) * 32;
      const int bt = (kk / 4) * wg::Q_HALF + (kk % 4) * 32;
      ptt::wgmma_ss<T, BQ>(sT, ptt::desc_kmajor(kt + at),
                        ptt::desc_kmajor(qt + bt), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = (kk / 4) * wg::KV_HALF + (kk % 4) * 32;
      const int bt = (kk / 4) * wg::Q_HALF + (kk % 4) * 32;
      ptt::wgmma_ss<T, BQ>(dpT, ptt::desc_kmajor(vt + at),
                        ptt::desc_kmajor(gt + bt), kk > 0);
    }
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_regs<BQ / 2>(sT);
    ptt::fence_regs<BQ / 2>(dpT);

    // p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - delta) scale, with
    // the forward's masks; sT becomes p^T and dpT ds^T
    const float* ls = lse_s + st * BQ;
    const float* dl = del_s + st * BQ;
    const int* qs = qseg_s + st * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * quad + e;
        const int row = q0 + col;
        const float lse_c = ls[col], del_c = dl[col];
        const int qseg = qs[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int reg = 4 * j + 2 * r + e;
          bool keep = live(row, key[r], off, causal, window);
          if (seg != nullptr) keep = keep && qseg == kseg[r];
          const float sm = keep ? sT[reg] * scale : NEG_INF;
          const float p =
              (row < sq && key[r] < sk) ? __expf(sm - lse_c) : 0.f;
          dpT[reg] = p * (dpT[reg] - del_c) * scale;
          sT[reg] = p;
        }
      }
    // p through dout's type before p^T dout, ds through q's before
    // ds^T q: the T pairs of columns 16kk .. 16kk+15 are step kk's A
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pa[kk][c] = ptt::pack2<T>(sT[8 * kk + 2 * c], sT[8 * kk + 2 * c + 1]);
        da[kk][c] =
            ptt::pack2<T>(dpT[8 * kk + 2 * c], dpT[8 * kk + 2 * c + 1]);
      }

    // dV += P^T dout, dK += dS^T Q: B MN-major (the transpose bit)
    ptt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      ptt::wgmma_rs<T, D>(dv_acc, pa[kk],
                       ptt::desc_mnmajor(gt + kk * 16 * wg::ROW_BYTES,
                                         wg::Q_HALF),
                       1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      ptt::wgmma_rs<T, D>(dk_acc, da[kk],
                       ptt::desc_mnmajor(qt + kk * 16 * wg::ROW_BYTES,
                                         wg::Q_HALF),
                       1);
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_regs<D / 2>(dv_acc);
    ptt::fence_regs<D / 2>(dk_acc);
    ptt::mbar_arrive(empty + st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= sk) continue;
    const size_t at = (((size_t)b * sk + key[r]) * hk + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j + 2 * quad) =
          ptt::pack2<T>(dk_acc[c], dk_acc[c + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j + 2 * quad) =
          ptt::pack2<T>(dv_acc[c], dv_acc[c + 1]);
    }
  }
}

template <typename T, int D>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  CUtensorMap tq, tk, tv, tg;
  int rc = ptt::encode_bshd<T>(&tq, a.q, a.b, a.sq, a.h, D, wg::BQ);
  if (rc == 0) rc = ptt::encode_bshd<T>(&tg, a.g, a.b, a.sq, a.h, D, wg::BQ);
  if (rc == 0) rc = ptt::encode_bshd<T>(&tk, a.k, a.b, a.sk, a.hk, D, wg::BK);
  if (rc == 0) rc = ptt::encode_bshd<T>(&tv, a.v, a.b, a.sk, a.hk, D, wg::BK);
  if (rc != 0) return rc;
  const size_t smem = wg::Smem<D>::BYTES;
  auto kernel = flash_bwd_dkv_wgmma_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.hk, (a.sk + wg::BK - 1) / wg::BK);
  kernel<<<grid, wg::THREADS, smem, a.stream>>>(
      tq, tk, tv, tg, a.lse, a.delta, a.seg,
      static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk, a.h, a.hk,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

// ---------------------------------------------------------- dq on wgmma
namespace wgdq {

constexpr int BQ = 128;                // q rows per block: 64 a warpgroup
constexpr int BK = 64;                 // keys per streamed K/V tile
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 4;
constexpr int ROW_BYTES = 128;           // one half-row: 64 bf16 or fp16
constexpr int Q_HALF = BQ * ROW_BYTES;   // one half of the Q or dout tile
constexpr int KV_HALF = BK * ROW_BYTES;  // one half of a K or V tile

template <int D>
struct Smem {
  static constexpr int Q_TILE = (D / 64) * Q_HALF;    // 128 rows x D
  static constexpr int KV_TILE = (D / 64) * KV_HALF;  // 64 rows x D
  // 1024 for the alignment of the swizzled tiles; Q and dout; the K and V
  // stages; the barriers (Q/dout's, and full / empty per stage)
  static constexpr size_t BYTES =
      1024 + 2 * Q_TILE + 2 * STAGES * KV_TILE + 8 * (1 + 2 * STAGES);
};

}  // namespace wgdq

// dq for one (batch*head, 128-row q tile): two consumer warpgroups of 64
// rows and a producer warpgroup (see the file's head).
template <typename T, int D>
__global__ void __launch_bounds__(wgdq::THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ seg, T* __restrict__ dq,
                              int sq, int sk, int h, int hk, float scale,
                              int causal, int window) {
  using S = wgdq::Smem<D>;
  constexpr int BQ = wgdq::BQ, BK = wgdq::BK, STAGES = wgdq::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = ptt::align1024(smem_raw);
  unsigned char* Gs = Qs + S::Q_TILE;
  unsigned char* Ks = Gs + S::Q_TILE;            // [STAGES] tiles
  unsigned char* Vs = Ks + STAGES * S::KV_TILE;  // [STAGES] tiles
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + STAGES * S::KV_TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kvh = hh / (h / hk);
  // the last q tiles see the most keys under the causal mask: launched
  // first, so the longest blocks do not trail the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int off = sk - sq;
  // key range any row of this tile may attend
  int hi = sk, lo = 0;
  if (causal) {
    hi = min(sk, q0 + BQ + off);
    if (window > 0) lo = max(0, q0 + off - (window - 1));
  }
  lo = (lo / BK) * BK;
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  if (tid == 0) {
    ptt::mbar_init(qbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      ptt::mbar_init(full + st, 1);
      ptt::mbar_init(empty + st, wgdq::CONSUMERS * 128);
    }
    ptt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= wgdq::CONSUMERS * 128) {  // the producer warpgroup
    ptt::setmaxnreg_dec<wgdq::PRODUCER_REGS>();
    if (tid != wgdq::CONSUMERS * 128) return;  // one thread is enough
    ptt::mbar_arrive_tx(qbar, 2 * S::Q_TILE);
    for (int half = 0; half < D / 64; ++half) {
      ptt::tma_load_4d(Qs + half * wgdq::Q_HALF, &tq, qbar, 64 * half, hh, q0,
                       b);
      ptt::tma_load_4d(Gs + half * wgdq::Q_HALF, &tg, qbar, 64 * half, hh, q0,
                       b);
    }
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES, k0 = lo + i * BK;
      ptt::mbar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
      ptt::mbar_arrive_tx(full + st, 2 * S::KV_TILE);
      for (int half = 0; half < D / 64; ++half) {
        ptt::tma_load_4d(Ks + st * S::KV_TILE + half * wgdq::KV_HALF, &tk,
                         full + st, 64 * half, kvh, k0, b);
        ptt::tma_load_4d(Vs + st * S::KV_TILE + half * wgdq::KV_HALF, &tv,
                         full + st, 64 * half, kvh, k0, b);
      }
    }
    return;
  }

  // a consumer warpgroup, on q rows wgi*64 .. +63 of the tile: this thread
  // owns rows row[0] and row[1] = row[0] + 8 of every accumulator fragment
  // (see hopper.cuh), so it loads their lse, delta and segment ids once
  ptt::setmaxnreg_inc<wgdq::CONSUMER_REGS>();
  const int wgi = tid / 128, lane = tid & 31, w = (tid & 127) / 32;
  const int quad = lane & 3;
  int row[2], qseg[2] = {0, 0};
  float lse_r[2], del_r[2];
  row[0] = q0 + wgi * 64 + w * 16 + lane / 4;
  row[1] = row[0] + 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < sq;
    lse_r[r] = ok ? lse[(size_t)bh * sq + row[r]] : 0.f;
    del_r[r] = ok ? delta[(size_t)bh * sq + row[r]] : 0.f;
    if (seg != nullptr) qseg[r] = ok ? seg[(size_t)b * sq + row[r]] : 0;
  }
  // whether a tile needs the per-element masks: the same answer for all
  // 64 rows of the warpgroup
  const int rmin = q0 + wgi * 64, rmax = rmin + 63;
  auto masked = [&](int k0) {
    return seg != nullptr || k0 + BK > sk ||
           (causal && (k0 + BK - 1 > rmin + off ||
                       (window > 0 && k0 <= rmax + off - window)));
  };
  float acc[D / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t da[BK / 16][4];  // the last tile's ds: the A operand of dS K
  const unsigned char* qtile = Qs + wgi * 64 * wgdq::ROW_BYTES;
  const unsigned char* gtile = Gs + wgi * 64 * wgdq::ROW_BYTES;

  // S = Q K^T and dP = dout V^T, both operands K-major
  auto issue_s = [&](int i) {
    const unsigned char* kt = Ks + (i % STAGES) * S::KV_TILE;
    const unsigned char* vt = Vs + (i % STAGES) * S::KV_TILE;
    ptt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = (kk / 4) * wgdq::Q_HALF + (kk % 4) * 32;
      const int bt = (kk / 4) * wgdq::KV_HALF + (kk % 4) * 32;
      ptt::wgmma_ss<T, BK>(s, ptt::desc_kmajor(qtile + at),
                           ptt::desc_kmajor(kt + bt), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int at = (kk / 4) * wgdq::Q_HALF + (kk % 4) * 32;
      const int bt = (kk / 4) * wgdq::KV_HALF + (kk % 4) * 32;
      ptt::wgmma_ss<T, BK>(dp, ptt::desc_kmajor(gtile + at),
                           ptt::desc_kmajor(vt + bt), kk > 0);
    }
    ptt::wgmma_commit();
  };
  // dQ += dS K: K as B, MN-major (the transpose bit)
  auto issue_dq = [&](int i) {
    const unsigned char* kt = Ks + (i % STAGES) * S::KV_TILE;
    ptt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      ptt::wgmma_rs<T, D>(acc, da[kk],
                          ptt::desc_mnmajor(kt + kk * 16 * wgdq::ROW_BYTES,
                                            wgdq::KV_HALF),
                          1);
    ptt::wgmma_commit();
  };
  // p = exp(s * scale - lse) with the forward's masks (keys at or past sk
  // give p = 0), ds = p (dp - delta) scale, left in dp
  auto grads = [&](int k0) {
    if (masked(k0)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * quad + e;
          const int kseg = (seg != nullptr && key < sk)
                               ? seg[(size_t)b * sk + key] : -1;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int reg = 4 * j + 2 * r + e;
            bool keep = live(row[r], key, off, causal, window);
            if (seg != nullptr) keep = keep && kseg == qseg[r];
            const float sm = keep ? s[reg] * scale : NEG_INF;
            const float p = key < sk ? __expf(sm - lse_r[r]) : 0.f;
            dp[reg] = p * (dp[reg] - del_r[r]) * scale;
          }
        }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        const float p = __expf(s[i] * scale - lse_r[r]);
        dp[i] = p * (dp[i] - del_r[r]) * scale;
      }
    }
  };
  // ds goes through K's type before dS K: the T pairs of columns
  // 16kk .. 16kk+15 are step kk's A operand
  auto to_da = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        da[kk][c] = ptt::pack2<T>(dp[8 * kk + 2 * c], dp[8 * kk + 2 * c + 1]);
  };

  ptt::mbar_wait(qbar, 0);
  // The first tile alone; then each turn issues this tile's S and dP and
  // the last tile's dS K as two wgmma groups and forms this tile's ds while
  // dS K is in flight (no first-turn branch inside the loop, so ptxas can
  // see which group each wait retires).
  if (ntiles > 0) {
    ptt::mbar_wait(full, 0);
    issue_s(0);
    ptt::wgmma_wait<0>();
    ptt::fence_regs<BK / 2>(s);
    ptt::fence_regs<BK / 2>(dp);
    grads(lo);
    to_da();
  }
  for (int i = 1; i < ntiles; ++i) {
    ptt::mbar_wait(full + i % STAGES, (i / STAGES) & 1);
    issue_s(i);
    issue_dq(i - 1);
    ptt::wgmma_wait<1>();
    ptt::fence_regs<BK / 2>(s);
    ptt::fence_regs<BK / 2>(dp);
    grads(lo + i * BK);
    ptt::wgmma_wait<0>();
    ptt::fence_regs<D / 2>(acc);
    ptt::mbar_arrive(empty + (i - 1) % STAGES);
    to_da();
  }
  if (ntiles > 0) {  // the last tile's dS K
    issue_dq(ntiles - 1);
    ptt::wgmma_wait<0>();
    ptt::fence_regs<D / 2>(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= sq) continue;
    T* out = dq + (((size_t)b * sq + row[r]) * h + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * quad) =
          ptt::pack2<T>(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <typename T, int D>
int launch_dq_wgmma(const Args& a, void* dq) {
  CUtensorMap tq, tk, tv, tg;
  int rc = ptt::encode_bshd<T>(&tq, a.q, a.b, a.sq, a.h, D, wgdq::BQ);
  if (rc == 0) rc = ptt::encode_bshd<T>(&tg, a.g, a.b, a.sq, a.h, D, wgdq::BQ);
  if (rc == 0)
    rc = ptt::encode_bshd<T>(&tk, a.k, a.b, a.sk, a.hk, D, wgdq::BK);
  if (rc == 0)
    rc = ptt::encode_bshd<T>(&tv, a.v, a.b, a.sk, a.hk, D, wgdq::BK);
  if (rc != 0) return rc;
  const size_t smem = wgdq::Smem<D>::BYTES;
  auto kernel = flash_bwd_dq_wgmma_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.sq + wgdq::BQ - 1) / wgdq::BQ);
  kernel<<<grid, wgdq::THREADS, smem, a.stream>>>(
      tq, tk, tv, tg, a.lse, a.delta, a.seg, static_cast<T*>(dq), a.sq, a.sk,
      a.h, a.hk, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

// The wgmma kernels: bf16 or fp16 (dtype 1 or 2), d in {64, 128}; dq when
// o1 is null, else dk (o0) and dv (o1).
int run_wgmma(const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* delta, const void* seg, void* o0,
              void* o1, int b, int sq, int sk, int h, int hk, int d,
              float scale, int causal, int window, int dtype, void* stream) {
  const Args a{q, k, v, g,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(seg), b, sq, sk, h, hk, scale, causal,
               window, static_cast<cudaStream_t>(stream)};
  return ptt::by_half_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    const bool dq = o1 == nullptr;
    if (d == 64)
      return dq ? launch_dq_wgmma<T, 64>(a, o0)
                : launch_dkv_wgmma<T, 64>(a, o0, o1);
    if (d == 128)
      return dq ? launch_dq_wgmma<T, 128>(a, o0)
                : launch_dkv_wgmma<T, 128>(a, o0, o1);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (the wgmma entry points take 1 and 2,
// at d 64 and 128). seg may be null. window <= 0 means none.
extern "C" int flash_attention_bwd_dq_simt(const void* q, const void* k,
                                           const void* v, const void* g,
                                           const void* lse, const void* delta,
                                           const void* seg, void* dq, int b,
                                           int sq, int sk, int h, int hk,
                                           int d, float scale, int causal,
                                           int window, int dtype,
                                           void* stream) {
  return run(q, k, v, g, lse, delta, seg, dq, nullptr, b, sq, sk, h, hk, d,
             scale, causal, window, dtype, stream);
}

extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k,
                                            const void* v, const void* g,
                                            const void* lse, const void* delta,
                                            const void* seg, void* dq, int b,
                                            int sq, int sk, int h, int hk,
                                            int d, float scale, int causal,
                                            int window, int dtype,
                                            void* stream) {
  return run_wgmma(q, k, v, g, lse, delta, seg, dq, nullptr, b, sq, sk, h,
                   hk, d, scale, causal, window, dtype, stream);
}

extern "C" int flash_attention_bwd_dkv_simt(const void* q, const void* k,
                                       const void* v, const void* g,
                                       const void* lse, const void* delta,
                                       const void* seg, void* dk, void* dv,
                                       int b, int sq, int sk, int h, int hk,
                                       int d, float scale, int causal,
                                       int window, int dtype, void* stream) {
  return run(q, k, v, g, lse, delta, seg, dk, dv, b, sq, sk, h, hk, d, scale,
             causal, window, dtype, stream);
}

extern "C" int flash_attention_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, const void* seg, void* dk, void* dv,
    int b, int sq, int sk, int h, int hk, int d, float scale, int causal,
    int window, int dtype, void* stream) {
  return run_wgmma(q, k, v, g, lse, delta, seg, dk, dv, b, sq, sk, h, hk, d,
                   scale, causal, window, dtype, stream);
}
