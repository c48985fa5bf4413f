// Flash-attention forward for Hopper (sm_90a), bf16 or fp32 in, fp32
// accumulate. What it replaces, what bounds it and how the design answers
// that: see paddle_tpu_torch/ops/kernels/flash_attention.py.
//
// Layout: q [b, sq, h, d], k/v [b, sk, hk, d], segment ids [b, s] int32
// (optional, sq == sk), out [b, sq, h, d], lse [b, h, sq] fp32. Query head
// hh reads kv head hh / (h / hk).
//
// One block of 4 warps per (batch*head, 64-row query tile). The block loops
// over 64-key tiles of K and V staged in shared memory, with an online
// softmax in fp32; tiles wholly above the causal diagonal or before the
// window band are never loaded. Each warp owns 16 query rows and works on 4
// of them at a time: lane i scores keys i and i+32 against the 4 rows, and
// in the PV product owns a strip of head dims. Rows keep their running
// max and sum in registers and their output accumulator in shared memory.
#include "common.cuh"

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
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  auto kernel = flash_fwd_kernel<T, D>;
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

}  // namespace

// dtype: 0 = fp32, 1 = bf16. seg may be null. window <= 0 means none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* seg, void* out,
                                   void* lse, int b, int sq, int sk, int h,
                                   int hk, int d, float scale, int causal,
                                   int window, int dtype, void* stream) {
  const int* s = static_cast<const int*>(seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, s, out, l, b, sq, sk, h, hk, scale,
                             causal, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, s, out, l, b, sq, sk, h, hk,
                                     scale, causal, window, st);
  return cudaErrorInvalidValue;
}
