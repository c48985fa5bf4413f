// Flash-attention forward for Hopper (sm_90a), fp32 accumulate. What it
// replaces, what bounds it and how the design answers that: see
// paddle_tpu_torch/ops/kernels/flash_attention.py. Two kernels, chosen by
// the Python wrapper from the dtype and head dim, never after a failure:
//
// Layout: q [b, sq, h, d], k/v [b, sk, hk, d], segment ids [b, s] int32
// (optional, sq == sk), out [b, sq, h, d], lse [b, h, sq] fp32. Query head
// hh reads kv head hh / (h / hk).
//
// wgmma (bf16 or fp16, d in {64, 128}): one block per (batch*head,
// 128-row q tile), the last q tiles (the most keys under the causal mask)
// launched first. Two consumer warpgroups own 64 query rows each; a
// producer warpgroup hands its registers to them (setmaxnreg), and one of
// its threads loads the Q tile once and streams 128-key K/V tiles through
// a ring of 3 shared-memory stages, all by TMA with the 128-byte swizzle,
// completed on mbarriers. S = Q K^T is wgmma m64n128k16 with both
// operands K-major in shared memory; the online softmax runs on the fp32
// accumulator fragment (row max over the 4 lanes of a quad, the masks per
// element only on tiles that cut the causal diagonal, the window band,
// sk or a segment); p, rounded to the input type, is already the register
// A operand of O += P V, whose B = V takes wgmma's transpose bit. A tile's
// S = Q K^T is issued before the last tile's P V, so the softmax of one
// overlaps the other on the tensor cores. Tiles wholly above the causal
// diagonal or before the window band are never loaded; keys past sk read
// as zeros (TMA) and are masked. The mask value and the running max stay
// in fp32 registers, so fp16's range (no finite -1e30) never meets them.
//
// simt (fp32, or d = 256; fp32, bf16 or fp16 in): one block of 4 warps
// per (batch*head, 64-row query tile), looping over 64-key tiles of K and
// V staged in shared memory with an odd word stride, with the products as
// fp32 FMAs on the CUDA cores. Each warp owns 16 query rows and works on 4
// of them at a time: lane i scores keys i and i+32 against the 4 rows, and
// in the PV product owns a strip of head dims. Rows keep their running max
// and sum in registers and their output accumulator in shared memory.
#include "hopper.cuh"

namespace {

using ptt::Elt;
using ptt::NEG_INF;

constexpr int BQ = 64;                    // query rows per block
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;  // 16
constexpr int R = 4;                       // rows a warp scores at once
constexpr int PASSES = ROWS_PER_WARP / R;

template <typename T, int D>
struct Geometry {
  // fp32 at d=256 halves the key tile to stay inside 227 KB
  static constexpr int BK = (sizeof(T) == 4 && D == 256) ? 32 : 64;
  static constexpr int KW = D * static_cast<int>(sizeof(T)) / 4;  // words/row
  static constexpr int KS = KW + 1;  // odd stride: column reads hit 32 banks
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BQ * D + WARPS * BK * R) +
      sizeof(uint32_t) * 2 * BK * KS + sizeof(int) * BK;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ out, float* __restrict__ lse, int sq,
                     int sk, int h, int hk, float scale, int causal,
                     int window) {
  using G = Geometry<T, D>;
  constexpr int BK = G::BK, KW = G::KW, KS = G::KS;
  constexpr int E = Elt<T>::PER_WORD;
  constexpr int NC = BK / 32;  // keys per lane in a tile
  constexpr int WPL = KW / 32;  // V words per lane

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);           // [BQ][D]
  float* Os = Qs + BQ * D;                              // [BQ][D]
  float* Ps = Os + BQ * D;                              // [WARPS][BK][R]
  uint32_t* Ks = reinterpret_cast<uint32_t*>(Ps + WARPS * BK * R);
  uint32_t* Vs = Ks + BK * KS;                          // [BK][KS] words
  int* kseg = reinterpret_cast<int*>(Vs + BK * KS);     // [BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h, kvh = hh / (h / hk);
  const int q0 = blockIdx.x * BQ;
  const int off = sk - sq;  // bottom-right causal alignment

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = q0 + i / D;
    Qs[i] = row < sq ? Elt<T>::to_float(
                           q[(((size_t)b * sq + row) * h + hh) * D + i % D])
                     : 0.f;
    Os[i] = 0.f;
  }

  float m_r[PASSES][R], l_r[PASSES][R];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m_r[p][r] = NEG_INF;
      l_r[p][r] = 0.f;
    }

  // key range any row of this tile may attend
  int hi = sk, lo = 0;
  if (causal) {
    hi = min(sk, q0 + BQ + off);
    if (window > 0) lo = max(0, q0 + off - (window - 1));
  }
  lo = (lo / BK) * BK;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the last tile's readers are done with Ks/Vs/kseg
    for (int i = tid; i < BK * (KW / 4); i += THREADS) {
      const int j = i / (KW / 4), c = i % (KW / 4);
      const int key = k0 + j;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
      if (key < sk) {
        const size_t base = (((size_t)b * sk + key) * hk + kvh) * D;
        kx = reinterpret_cast<const uint4*>(k + base)[c];
        vx = reinterpret_cast<const uint4*>(v + base)[c];
      }
      uint32_t* kd = Ks + j * KS + 4 * c;
      uint32_t* vd = Vs + j * KS + 4 * c;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      vd[0] = vx.x; vd[1] = vx.y; vd[2] = vx.z; vd[3] = vx.w;
    }
    if (seg != nullptr)
      for (int j = tid; j < BK; j += THREADS)
        kseg[j] = k0 + j < sk ? seg[(size_t)b * sk + k0 + j] : -1;
    __syncthreads();

#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const int rbase = warp * ROWS_PER_WARP + pass * R;  // row in tile
      const float* qrow = Qs + rbase * D;
      float s[R][NC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) s[r][c] = 0.f;

#pragma unroll 4
      for (int w = 0; w < KW; ++w) {
        float kf[NC][E];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          Elt<T>::unpack(Ks[(lane + 32 * c) * KS + w], kf[c]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float qv = qrow[r * D + w * E + e];
#pragma unroll
            for (int c = 0; c < NC; ++c) s[r][c] = fmaf(qv, kf[c][e], s[r][c]);
          }
      }

      float alpha[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = q0 + rbase + r;
        const int qseg =
            (seg != nullptr && row < sq) ? seg[(size_t)b * sq + row] : 0;
        float mx = NEG_INF;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int key = k0 + lane + 32 * c;
          bool keep = key < sk;
          if (causal) {
            keep = keep && row + off >= key;
            if (window > 0) keep = keep && row + off - key < window;
          }
          if (seg != nullptr) keep = keep && kseg[lane + 32 * c] == qseg;
          s[r][c] = keep ? s[r][c] * scale : NEG_INF;
          mx = fmaxf(mx, s[r][c]);
        }
        mx = ptt::warp_max(mx);
        const float m_prev = m_r[pass][r];
        const float m_new = fmaxf(m_prev, mx);
        alpha[r] = expf(m_prev - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float p = expf(s[r][c] - m_new);
          psum += p;
          // p goes through V's type before the PV product, as on the TPU
          Ps[(warp * BK + lane + 32 * c) * R + r] = Elt<T>::round(p);
        }
        l_r[pass][r] = alpha[r] * l_r[pass][r] + ptt::warp_sum(psum);
        m_r[pass][r] = m_new;
      }
      __syncwarp();

      float acc[R][WPL * E];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < WPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][i * E + e] =
                Os[(rbase + r) * D + (lane + 32 * i) * E + e] * alpha[r];
      const float* pw = Ps + warp * BK * R;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + j * R);
        const float pr[R] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i = 0; i < WPL; ++i) {
          float vf[E];
          Elt<T>::unpack(Vs[j * KS + lane + 32 * i], vf);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][i * E + e] = fmaf(pr[r], vf[e], acc[r][i * E + e]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < WPL; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e)
            Os[(rbase + r) * D + (lane + 32 * i) * E + e] = acc[r][i * E + e];
      __syncwarp();  // Ps is rewritten by the next pass
    }
  }

#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int local = warp * ROWS_PER_WARP + pass * R + r;
      const int row = q0 + local;
      if (row >= sq) continue;
      const float l = fmaxf(l_r[pass][r], 1e-30f);
      T* orow = out + (((size_t)b * sq + row) * h + hh) * D;
      for (int dd = lane; dd < D; dd += 32)
        orow[dd] = Elt<T>::from_float(Os[local * D + dd] / l);
      if (lane == 0) lse[(size_t)bh * sq + row] = m_r[pass][r] + logf(l);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg, void* out, float* lse, int b, int sq,
                   int sk, int h, int hk, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = Geometry<T, D>::SMEM;
  auto kernel = flash_fwd_simt_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), lse, sq, sk, h,
      hk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const int* seg, void* out, float* lse, int b, int sq,
                       int sk, int h, int hk, float scale, int causal,
                       int window, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, seg, out, lse, b, sq, sk, h, hk, scale,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, seg, out, lse, b, sq, sk, h, hk, scale,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, seg, out, lse, b, sq, sk, h, hk, scale,
                            causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ wgmma
namespace wg {

constexpr int BQ = 128;         // query rows per block
constexpr int BK = 128;         // keys per K/V tile
constexpr int CONSUMERS = 2;    // warpgroups of 64 rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int ROW_BYTES = 128;  // one half-row: 64 bf16 or fp16
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int HALVES = D / 64;
  static constexpr int STAGES = 3;
  static constexpr int Q_HALF = BQ * ROW_BYTES;
  static constexpr int KV_HALF = BK * ROW_BYTES;
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;  // one K or V tile
  // 1024 for the alignment of the swizzled tiles, then Q, the K stages,
  // the V stages and the barriers (Q's, and full / empty per stage)
  static constexpr size_t BYTES = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                                  8 * (1 + 2 * STAGES);
};

// The masks a tile needs, the same for every row of a warpgroup.
struct Masks {
  const int* seg;
  int b, sk, off, causal, window;
  float scale;
};

// One tile of the online softmax on a warpgroup's m64n128 score fragment
// s (see hopper.cuh for the map): scale and mask (per element only when
// `masked`), fold the tile's row max into m, leave p = exp(s - m) in s,
// add this thread's share of the row sums to l (the 4 lanes of a quad are
// summed once, at the end) and return the factor the output rows must be
// rescaled by. Keys at or past sk give p = 0 exactly.
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0,
                                               const int (&row)[2],
                                               const int (&qseg)[2],
                                               bool masked, const Masks& k,
                                               int quad) {
  float mx[2] = {NEG_INF, NEG_INF};
  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * quad + e;
        const int kseg = (k.seg != nullptr && key < k.sk)
                             ? k.seg[(size_t)k.b * k.sk + key] : -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          bool keep = true;
          if (k.causal) {
            keep = row[r] + k.off >= key;
            if (k.window > 0) keep = keep && row[r] + k.off - key < k.window;
          }
          if (k.seg != nullptr) keep = keep && kseg == qseg[r];
          x = key >= k.sk ? -INFINITY : (keep ? x * k.scale : NEG_INF);
          mx[r] = fmaxf(mx[r], x);
        }
      }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] *= k.scale;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ptt::ex2((m[r] - m_new) * LOG2E);
    m[r] = m_new;
    neg_m[r] = -m_new * LOG2E;
    l[r] *= alpha[r];
  }
  // unmasked: one FMA. Masked: a row whose scores so far are all masked
  // has m = NEG_INF, and only s - m is exactly 0 there (as in the TPU
  // kernel, such entries count 1 until a live score rescales them away)
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    s[i] = ptt::ex2(masked ? (s[i] - m[r]) * LOG2E
                           : fmaf(s[i], LOG2E, neg_m[r]));
    l[r] += s[i];
  }
}

}  // namespace wg

template <typename T, int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const int* __restrict__ seg,
                           T* __restrict__ out,
                           float* __restrict__ lse, int sq, int sk, int h,
                           int hk, float scale, int causal, int window) {
  using S = wg::Smem<D>;
  constexpr int BQ = wg::BQ, BK = wg::BK, STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = ptt::align1024(smem_raw);
  unsigned char* Ks = Qs + S::Q_BYTES;
  unsigned char* Vs = Ks + STAGES * S::KV_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + STAGES * S::KV_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h, kvh = hh / (h / hk);
  // the last q tiles see the most keys under the causal mask: launched
  // first, so the longest blocks do not trail the grid
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int off = sk - sq;  // bottom-right causal alignment
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
      ptt::mbar_init(empty + st, wg::CONSUMERS * 128);
    }
    ptt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= wg::CONSUMERS * 128) {  // the producer warpgroup
    ptt::setmaxnreg_dec<wg::PRODUCER_REGS>();
    if (tid == wg::CONSUMERS * 128) {
      ptt::mbar_arrive_tx(qbar, S::Q_BYTES);
      for (int half = 0; half < S::HALVES; ++half)
        ptt::tma_load_4d(Qs + half * S::Q_HALF, &tq, qbar, 64 * half, hh, q0,
                         b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES, k0 = lo + i * BK;
        ptt::mbar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
        ptt::mbar_arrive_tx(full + st, 2 * S::KV_BYTES);
        unsigned char* kt = Ks + st * S::KV_BYTES;
        unsigned char* vt = Vs + st * S::KV_BYTES;
        for (int half = 0; half < S::HALVES; ++half) {
          ptt::tma_load_4d(kt + half * S::KV_HALF, &tk, full + st, 64 * half,
                           kvh, k0, b);
          ptt::tma_load_4d(vt + half * S::KV_HALF, &tv, full + st, 64 * half,
                           kvh, k0, b);
        }
      }
    }
  } else {  // a consumer warpgroup: rows wgi*64 .. +63 of the tile
    ptt::setmaxnreg_inc<wg::CONSUMER_REGS>();
    // this thread owns rows r and r + 8 of the accumulator fragment
    const int wgi = tid / 128, lane = tid & 31, w = (tid & 127) / 32;
    const int quad = lane & 3;
    int row[2];
    row[0] = q0 + wgi * 64 + w * 16 + lane / 4;
    row[1] = row[0] + 8;
    int qseg[2] = {0, 0};
    if (seg != nullptr)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        qseg[r] = row[r] < sq ? seg[(size_t)b * sq + row[r]] : 0;
    const wg::Masks masks{seg, b, sk, off, causal, window, scale};
    // whether a tile needs the per-element masks: the same answer for all
    // 64 rows of the warpgroup
    const int rmin = q0 + wgi * 64, rmax = rmin + 63;
    auto masked = [&](int k0) {
      return seg != nullptr || k0 + BK > sk ||
             (causal && (k0 + BK - 1 > rmin + off ||
                         (window > 0 && k0 <= rmax + off - window)));
    };
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float o[D / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t pa[BK / 16][4];  // the last tile's p: the A operand of P V
    const unsigned char* qtile = Qs + wgi * 64 * wg::ROW_BYTES;

    ptt::mbar_wait(qbar, 0);
    auto issue_s = [&](int i) {
      const unsigned char* kt = Ks + (i % STAGES) * S::KV_BYTES;
      ptt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int at = (kk / 4) * S::Q_HALF + (kk % 4) * 32;
        const int bt = (kk / 4) * S::KV_HALF + (kk % 4) * 32;
        ptt::wgmma_ss<T, BK>(s, ptt::desc_kmajor(qtile + at),
                          ptt::desc_kmajor(kt + bt), kk > 0);
      }
      ptt::wgmma_commit();
    };
    auto issue_pv = [&](int i) {
      const unsigned char* vt = Vs + (i % STAGES) * S::KV_BYTES;
      ptt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        ptt::wgmma_rs<T, D>(o, pa[kk],
                         ptt::desc_mnmajor(vt + kk * 16 * wg::ROW_BYTES,
                                           S::KV_HALF),
                         1);
      ptt::wgmma_commit();
    };
    auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * j + 2 * r] *= alpha[r];
          o[4 * j + 2 * r + 1] *= alpha[r];
        }
    };
    // p goes through V's type before the PV product, as on the TPU: the
    // T pairs of columns 16kk .. 16kk+15 are step kk's A operand
    auto to_pa = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pa[kk][c] = ptt::pack2<T>(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
    };
    // The first tile alone; then each turn issues this tile's S and the
    // last tile's P V as two wgmma groups and runs this tile's softmax
    // while P V is in flight. The loop has no first-turn branch, so ptxas
    // can see which group each wait retires and serializes nothing.
    if (ntiles > 0) {
      ptt::mbar_wait(full, 0);
      issue_s(0);
      ptt::wgmma_wait<0>();
      ptt::fence_regs<BK / 2>(s);
      wg::online_softmax(s, m, l, alpha, lo, row, qseg, masked(lo), masks,
                         quad);
      to_pa();
    }
    for (int i = 1; i < ntiles; ++i) {
      const int k0 = lo + i * BK;
      ptt::mbar_wait(full + i % STAGES, (i / STAGES) & 1);
      issue_s(i);
      rescale_o();  // to the last tile's max, before its P V is added
      issue_pv(i - 1);
      ptt::wgmma_wait<1>();
      ptt::fence_regs<BK / 2>(s);
      wg::online_softmax(s, m, l, alpha, k0, row, qseg, masked(k0), masks,
                         quad);
      ptt::wgmma_wait<0>();
      ptt::fence_regs<D / 2>(o);
      ptt::mbar_arrive(empty + (i - 1) % STAGES);
      to_pa();
    }
    if (ntiles > 0) {  // the last tile's P V
      rescale_o();
      issue_pv(ntiles - 1);
      ptt::wgmma_wait<0>();
      ptt::fence_regs<D / 2>(o);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (row[r] >= sq) continue;
      const float lc = fmaxf(l[r], 1e-30f);
      T* orow = out + (((size_t)b * sq + row[r]) * h + hh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
            ptt::pack2<T>(o[4 * j + 2 * r] / lc, o[4 * j + 2 * r + 1] / lc);
      if (quad == 0) lse[(size_t)bh * sq + row[r]] = m[r] + logf(lc);
    }
  }
}

template <typename T, int D>
int launch_wgmma(const void* q, const void* k, const void* v, const int* seg,
                 void* out, float* lse, int b, int sq, int sk, int h, int hk,
                 float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = ptt::encode_bshd<T>(&tq, q, b, sq, h, D, wg::BQ);
  if (rc == 0) rc = ptt::encode_bshd<T>(&tk, k, b, sk, hk, D, wg::BK);
  if (rc == 0) rc = ptt::encode_bshd<T>(&tv, v, b, sk, hk, D, wg::BK);
  if (rc != 0) return rc;
  const size_t smem = wg::Smem<D>::BYTES;
  auto kernel = flash_fwd_wgmma_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + wg::BQ - 1) / wg::BQ);
  kernel<<<grid, wg::THREADS, smem, stream>>>(
      tq, tk, tv, seg, static_cast<T*>(out), lse, sq, sk, h, hk,
      scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. seg may be null. window <= 0 means
// none.
extern "C" int flash_attention_fwd_simt(const void* q, const void* k,
                                   const void* v, const void* seg, void* out,
                                   void* lse, int b, int sq, int sk, int h,
                                   int hk, int d, float scale, int causal,
                                   int window, int dtype, void* stream) {
  const int* s = static_cast<const int*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return dispatch_d<T>(d, q, k, v, s, out, l, b, sq, sk, h, hk, scale,
                         causal, window, st);
  });
}

// bf16 or fp16 (dtype 1 or 2), d in {64, 128}; the other arguments as
// flash_attention_fwd_simt
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, const void* seg,
                                         void* out, void* lse, int b, int sq,
                                         int sk, int h, int hk, int d,
                                         float scale, int causal, int window,
                                         int dtype, void* stream) {
  const int* s = static_cast<const int*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_half_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (d == 64)
      return launch_wgmma<T, 64>(q, k, v, s, out, l, b, sq, sk, h, hk, scale,
                                 causal, window, st);
    if (d == 128)
      return launch_wgmma<T, 128>(q, k, v, s, out, l, b, sq, sk, h, hk,
                                  scale, causal, window, st);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
