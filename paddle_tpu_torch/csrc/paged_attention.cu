// Grid paged attention for Hopper (sm_90a): single-query paged decode,
// fp32, bf16 or fp16 in, fp32 accumulate. What it replaces, what bounds it
// and how the design answers that: see
// paddle_tpu_torch/ops/kernels/paged_attention.py.
//
// Layout: q [R, h, d], pools [P, B, kvh, d], block_tables [R, M] int32,
// seq_lens [R] int32, out like q. Row r's query sits at position
// seq_lens[r] and attends positions 0 .. seq_lens[r] (only the trailing
// `window` of them when window > 0). Logical position p of row r lives in
// physical block block_tables[r, p / B] at offset p % B.
//
// The TPU kernel's fixed (R, kvh, M) grid becomes one block of 8 warps per
// (kv head, row); its third axis, the row's table slots, becomes a loop
// inside the block from the first in-window slot to the last live one (the
// TPU kernel's index-map clamp, written as the loop's bounds), so a slot
// past the live count is never read. The loop runs in tiles of KT
// positions: each tile's K and V rows are fetched into registers one tile
// ahead, stored to shared memory as fp32, and each physical K/V row is
// read once for the head's whole query group. Per tile: scores [group, KT]
// (one thread per pair, float4 dot products), an online softmax per query
// row (one warp per row), and the PV product (one thread per output
// element) -- the ragged kernel's order of sums, so without a window (the
// loop then starts at position 0 in both) the two kernels agree bit for
// bit.
#include "common.cuh"

namespace {

using ptt::Elt;
using ptt::NEG_INF;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GROUP = 32;  // query heads per kv head

template <int D>
struct Tile {
  static constexpr int KT = D <= 128 ? 64 : 32;  // positions per tile
  static constexpr int LD = D + 4;  // row stride of q_s and k_s, in floats
};

// Offsets (in floats) into dynamic shared memory; each a multiple of 4 so
// float4 accesses stay aligned.
struct Smem {
  int q, k, v, s, m, l, a, total;
};

template <int D>
inline __host__ __device__ Smem layout(int group) {
  constexpr int KT = Tile<D>::KT, LD = Tile<D>::LD;
  Smem o;
  o.q = 0;                    // q_s [group][LD]
  o.k = o.q + group * LD;     // k_s [KT][LD]
  o.v = o.k + KT * LD;        // v_s [KT][D]
  o.s = o.v + KT * D;         // s_s [group][KT]: scores, then rounded p
  o.m = o.s + group * KT;     // running max per query row
  o.l = o.m + MAX_GROUP;      // running sum per query row
  o.a = o.l + MAX_GROUP;      // this tile's rescale factor per query row
  o.total = o.a + MAX_GROUP;
  return o;
}

template <typename T, int D>
struct Loader {
  static constexpr int KT = Tile<D>::KT, LD = Tile<D>::LD;
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int CPR = D / EPC;         // 16-byte chunks per K/V row
  static constexpr int N = 2 * KT * CPR / THREADS;  // chunks per thread
  static_assert((2 * KT * CPR) % THREADS == 0, "tile must split evenly");

  // Start the global loads of the K and V rows at positions
  // base .. base+KT-1 (zeros past `hi`) into registers.
  __device__ static inline void fetch(uint4 (&buf)[N], const T* kp,
                                      const T* vp, const int* trow, int base,
                                      int hi, int B, int kvh, int hk) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = threadIdx.x + n * THREADS;
      const int which = c / (KT * CPR), rem = c % (KT * CPR);
      const int j = rem / CPR, cc = rem % CPR;
      const int p = base + j;
      if (p < hi) {
        const int phys = trow[p / B];
        const T* src = (which ? vp : kp) +
                       (((size_t)phys * B + p % B) * kvh + hk) * D + cc * EPC;
        buf[n] = *reinterpret_cast<const uint4*>(src);
      } else {
        buf[n] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // Unpack the fetched chunks into k_s / v_s as fp32.
  __device__ static inline void store(const uint4 (&buf)[N], float* k_s,
                                      float* v_s) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = threadIdx.x + n * THREADS;
      const int which = c / (KT * CPR), rem = c % (KT * CPR);
      const int j = rem / CPR, cc = rem % CPR;
      const uint32_t w[4] = {buf[n].x, buf[n].y, buf[n].z, buf[n].w};
      float f[EPC];
#pragma unroll
      for (int i = 0; i < 4; ++i) Elt<T>::unpack(w[i], f + i * Elt<T>::PER_WORD);
      float* dst = which ? v_s + j * D + cc * EPC : k_s + j * LD + cc * EPC;
#pragma unroll
      for (int i = 0; i < EPC; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    grid_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const int* __restrict__ tables,
                      const int* __restrict__ lens, T* __restrict__ out,
                      int h, int kvh, int M, int B, float scale, int window) {
  using Ld = Loader<T, D>;
  constexpr int KT = Tile<D>::KT, LD = Tile<D>::LD;
  constexpr int NACC = MAX_GROUP * D / THREADS;  // outputs per thread, at most
  const int hk = blockIdx.x, r = blockIdx.y;
  const int group = h / kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float sm[];
  const Smem L = layout<D>(group);
  float* q_s = sm + L.q;
  float* k_s = sm + L.k;
  float* v_s = sm + L.v;
  float* s_s = sm + L.s;
  float* m_s = sm + L.m;
  float* l_s = sm + L.l;
  float* a_s = sm + L.a;

  // query row g is query head hk*group + g
  for (int idx = tid; idx < group * Ld::CPR; idx += THREADS) {
    const int g = idx / Ld::CPR, c = idx % Ld::CPR;
    float f[Ld::EPC];
    ptt::load_floats<T, Ld::EPC>(
        q + ((size_t)r * h + hk * group + g) * D + c * Ld::EPC, f);
#pragma unroll
    for (int e = 0; e < Ld::EPC; ++e) q_s[g * LD + c * Ld::EPC + e] = f[e];
  }
  if (tid < MAX_GROUP) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int len = lens[r];
  const int valid = len + 1;  // positions 0 .. len attend
  // table slots from the first in-window one to the last live one
  const int lo = window > 0 ? max(0, valid - window) / B * B : 0;
  const int hi = min(valid, M * B);
  const int* trow = tables + (size_t)r * M;

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;

  uint4 buf[Ld::N];
  if (lo < hi) Ld::fetch(buf, kp, vp, trow, lo, hi, B, kvh, hk);
  __syncthreads();

  for (int base = lo; base < hi; base += KT) {
    Ld::store(buf, k_s, v_s);
    __syncthreads();
    if (base + KT < hi) Ld::fetch(buf, kp, vp, trow, base + KT, hi, B, kvh, hk);

    // scores, masked to the finite NEG_INF as the TPU kernel does
    for (int pidx = tid; pidx < group * KT; pidx += THREADS) {
      const int g = pidx / KT, j = pidx % KT;
      const int p = base + j;
      float s = NEG_INF;
      if (p < hi && (window <= 0 || p >= valid - window)) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + g * LD);
        const float4* kv = reinterpret_cast<const float4*>(k_s + j * LD);
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < D / 4; ++c) {
          const float4 a = qv[c], b = kv[c];
          dot = fmaf(a.x, b.x, dot);
          dot = fmaf(a.y, b.y, dot);
          dot = fmaf(a.z, b.z, dot);
          dot = fmaf(a.w, b.w, dot);
        }
        s = dot * scale;
      }
      s_s[g * KT + j] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < group; g += WARPS) {
      const float m_old = m_s[g];
      float mx = NEG_INF;
      for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, s_s[g * KT + j]);
      mx = ptt::warp_max(mx);
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < KT; j += 32) {
        const float p = expf(s_s[g * KT + j] - m_new);
        sum += p;
        // p goes through V's type before the PV product, as on the TPU
        s_s[g * KT + j] = Elt<T>::round(p);
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int o = tid + k * THREADS;
      if (o < group * D) {
        const int g = o / D, dd = o % D;
        const float* prow = s_s + g * KT;
        float a = acc[k] * a_s[g];
#pragma unroll 8
        for (int j = 0; j < KT; ++j) a = fmaf(prow[j], v_s[j * D + dd], a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const int o = tid + k * THREADS;
    if (o < group * D) {
      const int g = o / D, dd = o % D;
      out[((size_t)r * h + hk * group + g) * D + dd] =
          Elt<T>::from_float(acc[k] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int R,
                   int h, int kvh, int M, int B, float scale, int window,
                   cudaStream_t stream) {
  auto kernel = grid_paged_kernel<T, D>;
  // opt in once, for the largest group, at the first (uncaptured) call: a
  // launch inside a CUDA graph capture then sets no attribute
  static const cudaError_t attr = ptt::allow_smem(
      kernel, sizeof(float) * layout<D>(MAX_GROUP).total);
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * layout<D>(h / kvh).total;
  kernel<<<dim3(kvh, R), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), h, kvh, M, B,
      scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kp, const void* vp,
                       const void* tables, const void* lens, void* out, int R,
                       int h, int kvh, int M, int B, float scale, int window,
                       cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, kp, vp, tables, lens, out, R, h, kvh, M, B,
                           scale, window, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, tables, lens, out, R, h, kvh, M, B,
                            scale, window, stream);
    case 256:
      return launch<T, 256>(q, kp, vp, tables, lens, out, R, h, kvh, M, B,
                            scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. window <= 0 means none.
extern "C" int paged_attention_fwd(const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* lens, void* out, int R, int h,
                                   int kvh, int d, int M, int B, float scale,
                                   int window, int dtype, void* stream) {
  if (R < 1 || kvh < 1 || h % kvh != 0 || h / kvh > MAX_GROUP || M < 1 ||
      B < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_dtype(dtype, [&](auto tag) {
    return dispatch_d<typename decltype(tag)::type>(
        d, q, kp, vp, tables, lens, out, R, h, kvh, M, B, scale, window, st);
  });
}
