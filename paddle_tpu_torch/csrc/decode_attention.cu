// Single-query decode attention over a static KV cache for Hopper
// (sm_90a), bf16 or fp32 in, fp32 accumulate. What it replaces, what bounds
// it and how the design answers that: see
// paddle_tpu_torch/ops/kernels/decode_attention.py.
//
// Layout: q [b, h, d], caches [b, T, kv, d], out [b, h, d]. Positions
// 0..cache_index attend (only the trailing `window` of them when
// window > 0). Query head kvh*G + g reads kv head kvh, G = h / kv.
//
// One block of 8 warps per (row, kv head). The block holds that head's G
// queries in registers (lane i owns d/32 contiguous dims) and reads each
// valid K/V position exactly once for all G of them. Warps take
// interleaved runs of U positions, load the run's K and V rows before
// using any (U loads in flight per warp), and keep an online softmax per
// query in fp32. At the end the 8 partial softmaxes are merged through
// shared memory.
#include "common.cuh"

namespace {

using ptt::Elt;
using ptt::NEG_INF;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GROUP = 8;  // query heads per kv head

template <int D>
struct Run {
  static constexpr int U = D <= 128 ? 4 : 2;  // positions a warp loads at once
};

inline size_t smem_bytes(int group, int d) {
  return sizeof(float) * WARPS * group * (2 + d);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, T* __restrict__ out, int tlen,
                  int h, int kv, int cache_index, float scale, int window) {
  constexpr int DPL = D / 32;  // dims per lane
  constexpr int U = Run<D>::U;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int group = h / kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float qr[MAX_GROUP][DPL], acc[MAX_GROUP][DPL], m[MAX_GROUP], l[MAX_GROUP];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[g][i] = 0.f;
      acc[g][i] = 0.f;
    }
    if (g < group)
      ptt::load_floats<T, DPL>(
          q + ((size_t)b * h + kvh * group + g) * D + lane * DPL, qr[g]);
  }

  const int valid = cache_index + 1;
  const int lo = window > 0 ? max(0, valid - window) : 0;
  for (int base = lo + warp * U; base < valid; base += WARPS * U) {
    float kf[U][DPL], vf[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      if (t < valid) {
        const size_t row = (((size_t)b * tlen + t) * kv + kvh) * D + lane * DPL;
        ptt::load_floats<T, DPL>(kc + row, kf[u]);
        ptt::load_floats<T, DPL>(vc + row, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u >= valid) break;
#pragma unroll
      for (int g = 0; g < MAX_GROUP; ++g) {
        if (g >= group) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qr[g][i], kf[u][i], part);
        const float s = ptt::warp_sum(part) * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        // p goes through V's type before the PV product, as on the TPU
        const float pr = Elt<T>::round(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[g][i] = fmaf(pr, vf[u][i], acc[g][i] * alpha);
        m[g] = m_new;
      }
    }
  }

  extern __shared__ __align__(16) float sm[];
  float* ms = sm;                        // [WARPS][group]
  float* ls = ms + WARPS * group;        // [WARPS][group]
  float* as = ls + WARPS * group;        // [WARPS][group][D]
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    if (g >= group) break;
    if (lane == 0) {
      ms[warp * group + g] = m[g];
      ls[warp * group + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      as[(warp * group + g) * D + lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < group * D; idx += THREADS) {
    const int g = idx / D, dd = idx % D;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w * group + g]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(ms[w * group + g] - mx);
      lsum += ls[w * group + g] * c;
      o += as[(w * group + g) * D + dd] * c;
    }
    out[((size_t)b * h + kvh * group + g) * D + dd] =
        Elt<T>::from_float(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out,
                   int b, int tlen, int h, int kv, int cache_index,
                   float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(h / kv, D);
  auto kernel = decode_kernel<T, D>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kv, b), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(out), tlen, h, kv,
      cache_index, scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kc, const void* vc,
                       void* out, int b, int tlen, int h, int kv,
                       int cache_index, float scale, int window,
                       cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, kc, vc, out, b, tlen, h, kv, cache_index, scale,
                           window, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, out, b, tlen, h, kv, cache_index,
                            scale, window, stream);
    case 256:
      return launch<T, 256>(q, kc, vc, out, b, tlen, h, kv, cache_index,
                            scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. window <= 0 means none.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, void* out, int b,
                                    int tlen, int h, int kv, int d,
                                    int cache_index, float scale, int window,
                                    int dtype, void* stream) {
  if (h % kv != 0 || h / kv > MAX_GROUP || cache_index < 0 ||
      cache_index >= tlen)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k_cache, v_cache, out, b, tlen, h, kv,
                             cache_index, scale, window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k_cache, v_cache, out, b, tlen, h,
                                     kv, cache_index, scale, window, st);
  return cudaErrorInvalidValue;
}
