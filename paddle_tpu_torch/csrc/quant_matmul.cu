// Fused weight-only dequant-matmul for Hopper (sm_90a): x [m, din] (fp32,
// bf16 or fp16) times int8 [din, dout] or int4 [din/2, dout] codes with
// bf16 scales [din/128, dout], fp32 dequant and fp32 sums, out [m, dout]
// in x's type (rounded once).
// What it replaces, what bounds it and how the design answers that: see
// paddle_tpu_torch/ops/kernels/quant_matmul.py.
//
// Pass 1, one block of 4 warps per (chunk of MT activation rows, tile of
// 512 output columns, split of the contraction). Each lane owns 16
// neighbouring columns and reads 16 bytes of one code row at a time
// (neighbouring lanes on neighbouring columns: a warp reads 512 contiguous
// bytes); the 4 warps take interleaved code rows of each 128-row scale
// block, 8 loads in flight per lane. A code becomes a float by the
// magic-number trick (byte into the mantissa of 2^23, one subtract), is
// multiplied by its fp32 scale, and is used for the chunk's MT rows. The
// warps' partial sums meet in shared memory in a fixed order; a block
// writes its tile to `out` (one split) or to the fp32 `partial` buffer.
// Pass 2 (split > 1) adds the splits in order and rounds once. No atomics:
// the result depends on the shapes alone and repeats bit for bit.
#include "common.cuh"

namespace {

using ptt::Elt;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 32 * 16;  // output columns per block
constexpr int QB = 128;        // code rows per scale (QUANT_BLOCK)
constexpr int UNROLL = 8;      // code-row loads in flight per lane

// bytes -> floats: b is 4 offset-binary bytes (value + bias); the byte
// goes into the low mantissa of 2^23 and the subtract removes 2^23 + bias
template <int BIAS>
__device__ inline void bytes_to_floats(uint32_t b, float* f) {
  constexpr float MAGIC = 8388608.f + BIAS;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + j)) - MAGIC;
}

template <typename T, int BITS, int MT>
__global__ void __launch_bounds__(THREADS)
    qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
               const __nv_bfloat16* __restrict__ scales, T* __restrict__ out,
               float* __restrict__ partial, int m, int din, int dout,
               int splits) {
  constexpr int PACK = 8 / BITS;             // code rows per byte row
  constexpr int PROWS = QB / PACK;           // byte rows per scale block
  constexpr int PER_WARP = PROWS / WARPS;    // byte rows per warp and block
  static_assert(PER_WARP % UNROLL == 0, "rows must split into the unroll");
  const int row0 = blockIdx.x * MT;
  const int rows = min(MT, m - row0);
  const int tile0 = blockIdx.y * COLS;
  const int split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = tile0 + lane * 16;
  const bool live = col < dout;
  const int nkb = din / QB;
  const int kb0 = (int)((long long)split * nkb / splits);
  const int kb1 = (int)((long long)(split + 1) * nkb / splits);

  __shared__ float xs[MT][QB];                       // this block's x, fp32
  __shared__ __align__(16) float red[MT][COLS];      // warps' sums

  float acc[MT][16];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    __syncthreads();  // the previous block's xs reads are done
    for (int i = threadIdx.x; i < MT * QB; i += THREADS) {
      const int r = i / QB, k = i % QB;
      xs[r][k] = r < rows ? Elt<T>::to_float(
                                x[(size_t)(row0 + r) * din + kb * QB + k])
                          : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    float sc[16];
    ptt::load_floats<__nv_bfloat16, 16>(scales + (size_t)kb * dout + col, sc);
    const int8_t* base = qw + (size_t)kb * PROWS * dout + col;
#pragma unroll 1
    for (int j0 = 0; j0 < PER_WARP; j0 += UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            base + (size_t)(warp + (j0 + u) * WARPS) * dout));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int pr = warp + (j0 + u) * WARPS;  // byte row in the block
        const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int half = 0; half < PACK; ++half) {
          // int4: half 0 is the low nibble (even code row), half 1 the
          // high nibble (odd code row), both sign-extended
          const int k = pr * PACK + half;
          float xk[MT];
#pragma unroll
          for (int r = 0; r < MT; ++r) xk[r] = xs[r][k];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            float f[4];
            if constexpr (BITS == 8) {
              bytes_to_floats<128>(words[w] ^ 0x80808080u, f);
            } else {
              const uint32_t nib = half ? (words[w] >> 4) : words[w];
              bytes_to_floats<8>((nib & 0x0F0F0F0Fu) ^ 0x08080808u, f);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float wv = f[j] * sc[4 * w + j];
#pragma unroll
              for (int r = 0; r < MT; ++r)
                acc[r][4 * w + j] = fmaf(xk[r], wv, acc[r][4 * w + j]);
            }
          }
        }
      }
    }
  }

  // the warps' sums, added in the order 0, 1, 2, 3
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && live) {
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        float4* dst = reinterpret_cast<float4*>(&red[r][lane * 16]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float4 a = make_float4(acc[r][4 * c], acc[r][4 * c + 1],
                                 acc[r][4 * c + 2], acc[r][4 * c + 3]);
          if (w) {
            const float4 o = dst[c];
            a = make_float4(o.x + a.x, o.y + a.y, o.z + a.z, o.w + a.w);
          }
          dst[c] = a;
        }
      }
    }
    __syncthreads();
  }

  // write the tile: 4 columns a thread, rows of the chunk in turn
  const int c4 = threadIdx.x * 4;
  if (tile0 + c4 >= dout) return;
  for (int r = 0; r < rows; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(&red[r][c4]);
    const size_t o = (size_t)(row0 + r) * dout + tile0 + c4;
    if (splits == 1) {
      out[o] = Elt<T>::from_float(a.x);
      out[o + 1] = Elt<T>::from_float(a.y);
      out[o + 2] = Elt<T>::from_float(a.z);
      out[o + 3] = Elt<T>::from_float(a.w);
    } else {
      *reinterpret_cast<float4*>(partial + (size_t)split * m * dout + o) = a;
    }
  }
}

// out = sum of the splits' partials in the order 0 .. splits-1, rounded once
template <typename T>
__global__ void __launch_bounds__(256)
    qmm_reduce(const float* __restrict__ partial, T* __restrict__ out,
               int total, int splits) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= (size_t)total) return;
  float4 s = *reinterpret_cast<const float4*>(partial + i);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 p =
        *reinterpret_cast<const float4*>(partial + (size_t)sp * total + i);
    s = make_float4(s.x + p.x, s.y + p.y, s.z + p.z, s.w + p.w);
  }
  out[i] = Elt<T>::from_float(s.x);
  out[i + 1] = Elt<T>::from_float(s.y);
  out[i + 2] = Elt<T>::from_float(s.z);
  out[i + 3] = Elt<T>::from_float(s.w);
}

template <typename T, int BITS, int MT>
cudaError_t launch(const void* x, const void* qw, const void* scales,
                   void* out, void* partial, int m, int din, int dout,
                   int splits, cudaStream_t stream) {
  const dim3 grid((m + MT - 1) / MT, (dout + COLS - 1) / COLS, splits);
  qmm_kernel<T, BITS, MT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales), static_cast<T*>(out),
      static_cast<float*>(partial), m, din, dout, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int total = m * dout;
  qmm_reduce<T><<<(total / 4 + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), total,
      splits);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t dispatch_mt(int mt, const void* x, const void* qw,
                        const void* scales, void* out, void* partial, int m,
                        int din, int dout, int splits, cudaStream_t stream) {
  switch (mt) {
    case 1:
      return launch<T, BITS, 1>(x, qw, scales, out, partial, m, din, dout,
                                splits, stream);
    case 2:
      return launch<T, BITS, 2>(x, qw, scales, out, partial, m, din, dout,
                                splits, stream);
    case 4:
      return launch<T, BITS, 4>(x, qw, scales, out, partial, m, din, dout,
                                splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bits(int bits, int mt, const void* x, const void* qw,
                          const void* scales, void* out, void* partial, int m,
                          int din, int dout, int splits,
                          cudaStream_t stream) {
  if (bits == 8)
    return dispatch_mt<T, 8>(mt, x, qw, scales, out, partial, m, din, dout,
                             splits, stream);
  if (bits == 4)
    return dispatch_mt<T, 4>(mt, x, qw, scales, out, partial, m, din, dout,
                             splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype of x and out: 0 = fp32, 1 = bf16, 2 = fp16 (the scales are bf16
// whatever x is). mt: activation rows per block (1, 2 or 4).
// partial: fp32 [splits, m, dout] scratch, unused when splits == 1.
extern "C" int quant_matmul_fwd(const void* x, const void* qw,
                                const void* scales, void* out, void* partial,
                                int m, int din, int dout, int bits, int mt,
                                int splits, int dtype, void* stream) {
  if (m < 1 || din < QB || din % QB != 0 || dout < 16 || dout % 16 != 0 ||
      splits < 1 || splits > din / QB)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_dtype(dtype, [&](auto tag) {
    return dispatch_bits<typename decltype(tag)::type>(
        bits, mt, x, qw, scales, out, partial, m, din, dout, splits, st);
  });
}
