// Shared helpers for the attention kernels: element types, packed loads,
// warp reductions, and the error-string entry point every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <map>
#include <mutex>
#include <utility>

namespace ptt {

// The finite mask value of the TPU kernels: exp(NEG_INF - m) is 0 once a
// row has seen a real score, and a fully masked tile cannot make a NaN.
constexpr float NEG_INF = -1e30f;

// Codes the C entry points return beside cudaError_t values: a tensor map
// that cuTensorMapEncodeTiled refused (ERR_TENSOR_MAP + its CUresult), or
// no cuTensorMapEncodeTiled to call.
constexpr int ERR_TENSOR_MAP = 10000;
constexpr int ERR_NO_ENCODER = 20000;

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int PER_WORD = 1;  // elements per 32-bit word
  __device__ static inline void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  __device__ static inline float to_float(float x) { return x; }
  __device__ static inline float from_float(float x) { return x; }
  // the value after a round trip through the element type
  __device__ static inline float round(float x) { return x; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  // little-endian: element 0 is the low half-word
  __device__ static inline void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static inline float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static inline __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype does
  }
  __device__ static inline float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

template <>
struct Elt<__half> {
  static constexpr int PER_WORD = 2;
  // little-endian: element 0 is the low half-word
  __device__ static inline void unpack(uint32_t w, float* f) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w));
    f[0] = x.x;
    f[1] = x.y;
  }
  __device__ static inline float to_float(__half x) { return __half2float(x); }
  __device__ static inline __half from_float(float x) {
    return __float2half_rn(x);  // round to nearest even, as astype does
  }
  __device__ static inline float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

// The dtype codes of the Python wrappers: 0 = fp32, 1 = bf16, 2 = fp16.
template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the element type of `dtype` (any of the three), or
// cudaErrorInvalidValue for another code.
template <typename F>
inline int by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return static_cast<int>(f(Tag<float>{}));
    case 1:
      return static_cast<int>(f(Tag<__nv_bfloat16>{}));
    case 2:
      return static_cast<int>(f(Tag<__half>{}));
    default:
      return cudaErrorInvalidValue;
  }
}

// As by_dtype for the 16-bit types alone, which the tensor-core kernels
// take (f is never instantiated for fp32, which gives
// cudaErrorInvalidValue).
template <typename F>
inline int by_half_dtype(int dtype, F&& f) {
  if (dtype == 1) return static_cast<int>(f(Tag<__nv_bfloat16>{}));
  if (dtype == 2) return static_cast<int>(f(Tag<__half>{}));
  return cudaErrorInvalidValue;
}

// N contiguous elements at p (aligned to their size in bytes) -> N floats,
// with the widest loads the size allows.
template <typename T, int N>
__device__ inline void load_floats(const T* p, float* f) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  constexpr int WORDS = BYTES / 4;
  constexpr int E = Elt<T>::PER_WORD;
  uint32_t w[WORDS];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else {
    static_assert(BYTES == 4, "load_floats takes 4, 8 or 16k bytes");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < WORDS; ++i) Elt<T>::unpack(w[i], f + i * E);
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, once per
// kernel, card and larger size: the attribute call costs the host more
// than a short kernel takes to run, and the wrappers launch at every call.
// The attribute is one ceiling per kernel, so it is only ever raised (a
// smaller request after a larger one keeps the larger ceiling).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> ceiling;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> hold(mu);
  auto it = ceiling.find(key);
  if (it != ceiling.end() && it->second >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) ceiling[key] = bytes;
  return err;
}

}  // namespace ptt

extern "C" const char* kernel_error_string(int err) {
  static char text[96];
  if (err == ptt::ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled is not available";
  if (err >= ptt::ERR_TENSOR_MAP && err < ptt::ERR_NO_ENCODER) {
    snprintf(text, sizeof(text),
             "cuTensorMapEncodeTiled refused the tensor map (CUresult %d)",
             err - ptt::ERR_TENSOR_MAP);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
