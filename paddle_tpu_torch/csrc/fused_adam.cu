// One fused Adam / AdamW update over many tensors for Hopper (sm_90a).
// What it replaces, what bounds it and how the design answers that: see
// paddle_tpu_torch/ops/kernels/fused_adam.py.
//
// Every tensor of one (parameter type, gradient type, master or not)
// group is updated by one launch. The wrapper builds, once per optimizer
// state, a device table of entries (parameter, fp32 master or null, m, v,
// element count, decay flag) and the inclusive prefix sums of each
// tensor's chunk count; each step it uploads only the gradients' pointers
// (autograd hands out new gradient tensors every step). A block walks the
// chunks grid-stride, finds a chunk's tensor by binary search in the
// prefix sums, and updates CHUNK elements of it, 4 to a thread at a time
// with 16-byte loads of the fp32 master, m and v (8 or 16 bytes of the
// 16-bit or fp32 gradient and parameter); a tensor's ragged tail goes one
// element a thread.
//
// Per element, in fp32, with every operation rounded on its own (the _rn
// intrinsics: no contraction into fma), in the order of the JAX
// package's Adam._update behind GradScaler.unscale and
// ClipGradByGlobalNorm:
//   g = float(grad); g = g * inv_scale; g = g * clip_scale (rounded to
//   the gradient's type when there is no inv_scale);
//   w = master (or float(param));
//   Adam with decay:  g = g + wd * w
//   m = b1 * m + (1 - b1) * g;   v = b2 * v + (1 - b2) * (g * g)
//   u = (m / bc1) / (sqrt(v / bc2) + eps)
//   AdamW with decay: u = u + wd * w
//   w = w - lr * u;   master = w;   param = w rounded to its type.
// inv_scale, clip_scale and found_inf are device scalars (null: absent);
// when *found_inf is set the launch writes nothing, so a skipped fp16 step
// needs no host sync.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;
// elements a chunk: 8 per thread
constexpr int64_t CHUNK = THREADS * VEC * 2;

struct Entry {
  void* param;
  float* master;  // null: the parameter itself is the working copy
  float* m;
  float* v;
  int64_t numel;
  int32_t decay;
  int32_t pad;
};

struct Scalars {
  float lr, b1, b2, omb1, omb2, bc1, bc2, eps, wd;
  int decoupled;
};

template <typename T>
__device__ inline float to_f(T x) {
  return ptt::Elt<T>::to_float(x);
}

template <typename T>
__device__ inline T from_f(float x) {
  return ptt::Elt<T>::from_float(x);
}

// 4 contiguous elements of T at p (aligned to 4 x sizeof(T)) as floats
template <typename T>
__device__ inline void load4(const T* p, float* f) {
  ptt::load_floats<T, VEC>(p, f);
}

__device__ inline uint32_t bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ inline uint32_t bits16(__half x) { return __half_as_ushort(x); }

// 4 floats to 4 contiguous elements of T at p (aligned to 4 x sizeof(T)),
// each rounded to nearest even
template <typename T>
__device__ inline void store4(T* p, const float* f) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint2 w;
    w.x = bits16(from_f<T>(f[0])) | (bits16(from_f<T>(f[1])) << 16);
    w.y = bits16(from_f<T>(f[2])) | (bits16(from_f<T>(f[3])) << 16);
    *reinterpret_cast<uint2*>(p) = w;
  }
}

// unscale, then clip; a clipped gradient without an unscale is rounded
// back to its type, as ClipGradByGlobalNorm's astype(g.dtype) does
template <typename G>
__device__ inline float scaled(float g, bool use_inv, float inv,
                               bool use_clip, float cs) {
  if (use_inv) g = __fmul_rn(g, inv);
  if (use_clip) {
    g = __fmul_rn(g, cs);
    if (!use_inv) g = ptt::Elt<G>::round(g);
  }
  return g;
}

__device__ inline float adam_one(float g, float& w, float& m, float& v,
                                 bool decay, const Scalars& s) {
  if (decay && !s.decoupled) g = __fadd_rn(g, __fmul_rn(s.wd, w));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (decay && s.decoupled) u = __fadd_rn(u, __fmul_rn(s.wd, w));
  w = __fsub_rn(w, __fmul_rn(s.lr, u));
  return w;
}

template <typename P, typename G, bool MASTER>
__global__ void __launch_bounds__(THREADS)
    fused_adam_kernel(const Entry* __restrict__ table,
                      const int64_t* __restrict__ grads,
                      const int64_t* __restrict__ chunk_end, int n,
                      int64_t nchunks, Scalars s,
                      const float* __restrict__ clip,
                      const float* __restrict__ inv_scale,
                      const bool* __restrict__ found_inf) {
  if (found_inf != nullptr && *found_inf) return;
  const float inv = inv_scale != nullptr ? *inv_scale : 1.f;
  const float cs = clip != nullptr ? *clip : 1.f;
  const bool use_inv = inv_scale != nullptr, use_clip = clip != nullptr;
  for (int64_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
    // the tensor of chunk c: the first t with chunk_end[t] > c
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_end[mid] > c) hi = mid; else lo = mid + 1;
    }
    const Entry e = table[lo];
    const int64_t first = lo ? chunk_end[lo - 1] : 0;
    const int64_t start = (c - first) * CHUNK;
    const int64_t end = e.numel < start + CHUNK ? e.numel : start + CHUNK;
    P* param = static_cast<P*>(e.param);
    const G* grad = reinterpret_cast<const G*>(grads[lo]);
    const bool decay = e.decay != 0;
    for (int64_t i = start + VEC * threadIdx.x; i < end;
         i += VEC * THREADS) {
      if (i + VEC <= end) {
        float g[VEC], w[VEC], m[VEC], v[VEC];
        load4(grad + i, g);
        if constexpr (MASTER) {
          load4(e.master + i, w);
        } else {
          load4(param + i, w);
        }
        load4(e.m + i, m);
        load4(e.v + i, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          g[k] = scaled<G>(g[k], use_inv, inv, use_clip, cs);
          adam_one(g[k], w[k], m[k], v[k], decay, s);
        }
        store4(e.m + i, m);
        store4(e.v + i, v);
        if constexpr (MASTER) store4(e.master + i, w);
        store4(param + i, w);
      } else {
        for (int64_t j = i; j < end; ++j) {
          float g = to_f(grad[j]);
          float w = MASTER ? e.master[j] : to_f(param[j]);
          float m = e.m[j], v = e.v[j];
          g = scaled<G>(g, use_inv, inv, use_clip, cs);
          adam_one(g, w, m, v, decay, s);
          e.m[j] = m;
          e.v[j] = v;
          if constexpr (MASTER) e.master[j] = w;
          param[j] = from_f<P>(w);
        }
      }
    }
  }
}

template <typename P, typename G>
int launch(bool master, const void* table, const void* grads,
           const void* chunk_end, int n, int64_t nchunks, int blocks,
           const Scalars& s, const void* clip, const void* inv,
           const void* found, cudaStream_t st) {
  auto kernel = master ? fused_adam_kernel<P, G, true>
                       : fused_adam_kernel<P, G, false>;
  kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const Entry*>(table), static_cast<const int64_t*>(grads),
      static_cast<const int64_t*>(chunk_end), n, nchunks, s,
      static_cast<const float*>(clip), static_cast<const float*>(inv),
      static_cast<const bool*>(found));
  return cudaGetLastError();
}

}  // namespace

// The table's layout, so the wrapper can check it packs entries the same
// way: bytes an entry, and the chunk length in elements.
extern "C" int fused_adam_entry_bytes() { return sizeof(Entry); }
extern "C" long long fused_adam_chunk() { return CHUNK; }

// table: n Entry (device); grads: n int64 gradient pointers (device);
// chunk_end: n int64, inclusive prefix sums of ceil(numel / CHUNK)
// (device), nchunks = chunk_end[n - 1]; pdtype / gdtype: 0 fp32, 1 bf16,
// 2 fp16; master: 1 when the entries carry fp32 masters (then the
// parameter receives the master rounded to its type; without them the
// parameter itself, read as float, is updated). Every base pointer must be
// 16-byte aligned. clip, inv_scale: fp32 device scalars or null;
// found_inf: a bool device scalar or null.
extern "C" int fused_adam_step(const void* table, const void* grads,
                               const void* chunk_end, int n,
                               long long nchunks, int blocks, float lr,
                               float b1, float b2, float omb1, float omb2,
                               float bc1, float bc2, float eps, float wd,
                               int decoupled, int master, int pdtype,
                               int gdtype, const void* clip,
                               const void* inv_scale, const void* found_inf,
                               void* stream) {
  if (n < 1 || nchunks < 1 || blocks < 1) return cudaErrorInvalidValue;
  const Scalars s{lr, b1, b2, omb1, omb2, bc1, bc2, eps, wd, decoupled};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_dtype(pdtype, [&](auto ptag) {
    using P = typename decltype(ptag)::type;
    return ptt::by_dtype(gdtype, [&](auto gtag) {
      using G = typename decltype(gtag)::type;
      return launch<P, G>(master != 0, table, grads, chunk_end, n, nchunks,
                          blocks, s, clip, inv_scale, found_inf, st);
    });
  });
}
