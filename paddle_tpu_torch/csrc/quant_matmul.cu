// Fused weight-only dequant-matmul for Hopper (sm_90a): x [m, din] (fp32,
// bf16 or fp16) times int8 [din, dout] or int4 [din/2, dout] codes with
// bf16 scales [din/128, dout], fp32 sums, out [m, dout] in x's type
// (rounded once). What it replaces, what bounds it and how the design
// answers that: see paddle_tpu_torch/ops/kernels/quant_matmul.py.
//
// Two kernels, chosen by the wrapper from x's type alone.
//
// mma (bf16, fp16): tensor cores with the operands swapped, so that the
// weight is the 16-row operand and all m <= 64 activation rows ride the
// n side of mma.sync m16n8k16 as 1, 2, 4 or 8 tiles of 8. One block of 4
// warps takes 128 output columns (32 a warp) and a range of 128-row scale
// blocks (a split of the contraction); grid (column tiles, splits, groups
// of 64 activation rows). Each scale block's codes, x rows and scales are
// staged into shared memory with cp.async, three stages deep. An int8
// code becomes a float by the byte-into-mantissa trick and then x's type,
// exactly (|q| <= 128); two int4 codes go straight into a pair of x's type
// by the same trick in 16 bits. The tensor cores sum code x activation
// products of
// the scale block in fp32, and the block's 128-row scale multiplies that
// fp32 partial afterwards (fma into the running sum), so no rounding is
// added that the plain version lacks. Every code byte crosses from device
// memory and is converted once per call, whatever m is.
//   The contraction order inside a k16 step is free as long as A and B
// agree: lane (r, c) takes code rows 4c .. 4c + 3 of the step (rows r and
// r + 8 of the A tile are output columns 4r + 2t and 4r + 2t + 1 of the
// warp's 32, t the m16 tile), so it reads one 32-bit word of 4 columns per
// code row, and 8 contiguous bytes of x per activation row. The code and
// x tiles are XOR-swizzled by 16-byte chunk so that those reads hit 32
// distinct banks.
//   Splits merge in the same launch: with one split a block writes the
// output; otherwise it writes its fp32 partial to a per-card workspace,
// and the last block of its column tile to arrive at the tile's counter
// adds the splits' partials in split order, rounds once, and resets the
// counter. The result depends on the shapes alone and repeats bit for
// bit; one launch a call, no allocation.
//
// simt (fp32, the design of the first port): one block of 4 warps per
// (chunk of MT activation rows, tile of 512 output columns, split of the
// contraction). Each lane owns 16 neighbouring columns and reads 16 bytes
// of one code row at a time (neighbouring lanes on neighbouring columns:
// a warp reads 512 contiguous bytes); the 4 warps take interleaved code
// rows of each 128-row scale block, 8 loads in flight per lane. A code is
// multiplied by its fp32 scale and used for the chunk's MT rows on
// CUDA-core FMAs. The warps' partial sums meet in shared memory in a fixed
// order; a block writes its tile to `out` (one split) or to the fp32
// `partial` buffer, and a second pass (split > 1) adds the splits in
// order and rounds once. No atomics.
#include "mma.cuh"

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

// -------------------------------------------------------------- simt route
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

// --------------------------------------------------------------- mma route
constexpr int BCOLS = WARPS * 32;  // output columns per block, 32 a warp
constexpr int STAGES = 3;          // scale blocks in flight
constexpr int GROUP_ROWS = 64;     // activation rows per block, at most

template <int BITS, int NT>
struct MmaGeo {
  static constexpr int CODE_ROWS = QB * BITS / 8;  // byte rows a stage
  static constexpr int CODE_BYTES = CODE_ROWS * BCOLS;
  static constexpr int X_ROWS = NT * 8;            // activation rows held
  static constexpr int X_BYTES = X_ROWS * QB * 2;  // 256 bytes a row
  static constexpr int SC_BYTES = BCOLS * 2;
  static constexpr int STAGE = CODE_BYTES + X_BYTES + SC_BYTES;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE;
};

// The 16-byte chunk slot of chunk `ch` of code byte row k: the rows a
// k16 step's lanes read together (4c + q for int8, 2c + q for int4, c =
// lane % 4) land on distinct slots, so a warp's 32 words hit 32 banks.
template <int BITS>
__device__ inline int code_slot(int k, int ch) {
  return ch ^ (((BITS == 8 ? k >> 2 : k >> 1) & 3) << 1);
}
// The same for chunk `ch` of staged activation row n (16 chunks a row).
__device__ inline int x_slot(int n, int ch) { return ch ^ ((n & 3) << 1); }

// Two offset-binary nibbles (bits 0-3 and 16-19 of v, each the code + 8)
// -> the two codes as a T pair, exactly: the nibble goes into the low
// mantissa of 128 (bf16) or 1024 (fp16), and one paired subtract removes
// the magic and the offset.
template <typename T>
struct Nibbles;
template <>
struct Nibbles<__nv_bfloat16> {
  __device__ static inline uint32_t pair(uint32_t v) {
    uint32_t m = v | 0x43004300u;  // 128 + n in each half
    const __nv_bfloat162 r = __hsub2(
        *reinterpret_cast<__nv_bfloat162*>(&m), __float2bfloat162_rn(136.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
};
template <>
struct Nibbles<__half> {
  __device__ static inline uint32_t pair(uint32_t v) {
    uint32_t m = v | 0x64006400u;  // 1024 + n in each half
    const __half2 r =
        __hsub2(*reinterpret_cast<__half2*>(&m), __float2half2_rn(1032.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
};

template <typename T, int BITS, int NT>
__global__ void __launch_bounds__(THREADS)
    qmm_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                   const __nv_bfloat16* __restrict__ scales,
                   T* __restrict__ out, float* __restrict__ work,
                   int* __restrict__ arrivals, int m, int din, int dout,
                   int splits) {
  using Geo = MmaGeo<BITS, NT>;
  constexpr int XR = Geo::X_ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_in;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, c = lane & 3;
  const int tile0 = blockIdx.x * BCOLS;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * GROUP_ROWS;
  const int rows = min(XR, m - row0);
  const int nkb = din / QB;
  const int kb0 = (int)((long long)split * nkb / splits);
  const int kb1 = (int)((long long)(split + 1) * nkb / splits);
  const int nk = kb1 - kb0;

  // stage scale block kb into slot st: codes, x rows (zeros past m), scales
  auto load = [&](int kb, int st) {
    unsigned char* base = smem + st * Geo::STAGE;
    unsigned char* xs = base + Geo::CODE_BYTES;
    unsigned char* ss = xs + Geo::X_BYTES;
    for (int i = tid; i < Geo::CODE_ROWS * 8; i += THREADS) {
      const int k = i >> 3, ch = i & 7;
      const int col = tile0 + ch * 16;
      const bool ok = col < dout;
      ptt::cp_async16(base + k * BCOLS + code_slot<BITS>(k, ch) * 16,
                      qw + ((size_t)kb * Geo::CODE_ROWS + k) * dout +
                          (ok ? col : 0),
                      ok);
    }
    for (int i = tid; i < XR * 16; i += THREADS) {
      const int n = i >> 4, ch = i & 15;
      const bool ok = row0 + n < m;
      ptt::cp_async16(xs + n * 256 + x_slot(n, ch) * 16,
                      x + (size_t)(ok ? row0 + n : 0) * din + kb * QB +
                          ch * 8,
                      ok);
    }
    if (tid < BCOLS / 8) {
      const int col = tile0 + tid * 8;
      const bool ok = col < dout;
      ptt::cp_async16(ss + tid * 16,
                      scales + (size_t)kb * dout + (ok ? col : 0), ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(kb0 + s, s);
    ptt::cp_async_commit();
  }

  // tot[t][nt]: output columns 4r + 2t (elements 0, 1) and 4r + 2t + 1
  // (2, 3) of the warp's 32, activation rows 8 nt + 2c (0, 2) and
  // 8 nt + 2c + 1 (1, 3)
  float tot[2][NT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[t][nt][e] = 0.f;
  const int cw = 2 * warp + (r >> 2);  // the lane's code chunk in a row
  const int cb = 4 * (r & 3);          // its word in the chunk

  for (int i = 0; i < nk; ++i) {
    ptt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; slot (i - 1) % STAGES is free
    const int ahead = i + STAGES - 1;
    if (ahead < nk) load(kb0 + ahead, ahead % STAGES);
    ptt::cp_async_commit();
    const unsigned char* cs = smem + (i % STAGES) * Geo::STAGE;
    const unsigned char* xs = cs + Geo::CODE_BYTES;
    const unsigned char* ss = xs + Geo::X_BYTES;

    float blk[2][NT][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) blk[t][nt][e] = 0.f;
#pragma unroll
    for (int s = 0; s < QB / 16; ++s) {
      // A (the weight, rows = output columns): rows r, r + 8 of tile t are
      // columns 4r + 2t, 4r + 2t + 1 of the warp's 32
      uint32_t a[2][4];
      if constexpr (BITS == 8) {
        // f[q][j]: code row 16 s + 4c + q, column 4r + j; logical k 2c,
        // 2c + 1 are code rows 4c, 4c + 1 and k 2c + 8, 2c + 9 are
        // 4c + 2, 4c + 3
        float f[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 16 * s + 4 * c + q;
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              cs + k * BCOLS + code_slot<8>(k, cw) * 16 + cb);
          bytes_to_floats<128>(w ^ 0x80808080u, f[q]);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          a[t][0] = ptt::pack2<T>(f[0][2 * t], f[1][2 * t]);
          a[t][1] = ptt::pack2<T>(f[0][2 * t + 1], f[1][2 * t + 1]);
          a[t][2] = ptt::pack2<T>(f[2][2 * t], f[3][2 * t]);
          a[t][3] = ptt::pack2<T>(f[2][2 * t + 1], f[3][2 * t + 1]);
        }
      } else {
        // byte rows 8 s + 2c (w[0]) and + 1 (w[1]) hold code rows 4c, 4c + 1
        // and 4c + 2, 4c + 3 (low nibble first); logical k 2c, 2c + 1 are
        // the low nibbles (code rows 4c, 4c + 2), k 2c + 8, 2c + 9 the high
        // ones (4c + 1, 4c + 3). A nibble pair goes straight into a T pair
        // by the magic-number trick, exactly (x's rows are permuted to match
        // below)
        uint32_t w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 8 * s + 2 * c + h;
          w[h] = *reinterpret_cast<const uint32_t*>(
                     cs + k * BCOLS + code_slot<4>(k, cw) * 16 + cb) ^
                 0x88888888u;
        }
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t t =
              __byte_perm(w[0], w[1], j | (j << 4) | ((4 + j) << 8) |
                                          ((4 + j) << 12));
          lo[j] = Nibbles<T>::pair(t & 0x000F000Fu);
          hi[j] = Nibbles<T>::pair((t >> 4) & 0x000F000Fu);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          a[t][0] = lo[2 * t];
          a[t][1] = lo[2 * t + 1];
          a[t][2] = hi[2 * t];
          a[t][3] = hi[2 * t + 1];
        }
      }
      // B (x^T, columns = activation rows): row 8 nt + r at code rows
      // 16 s + 4c .. 4c + 3, one 8-byte read
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + r;
        const uint2 bv = *reinterpret_cast<const uint2*>(
            xs + n * 256 + x_slot(n, 2 * s + (c >> 1)) * 16 + 8 * (c & 1));
        // int4: code rows (4c, 4c + 2) and (4c + 1, 4c + 3), as A has them
        const uint32_t b[2] = {
            BITS == 8 ? bv.x : __byte_perm(bv.x, bv.y, 0x5410),
            BITS == 8 ? bv.y : __byte_perm(bv.x, bv.y, 0x7632)};
        ptt::mma16816<T>(blk[0][nt], a[0], b);
        ptt::mma16816<T>(blk[1][nt], a[1], b);
      }
    }
    // the scale block's fp32 partial times its scales, into the sum
    float sc[4];
    ptt::load_floats<__nv_bfloat16, 4>(
        reinterpret_cast<const __nv_bfloat16*>(ss) + warp * 32 + 4 * r, sc);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        tot[t][nt][0] = fmaf(blk[t][nt][0], sc[2 * t], tot[t][nt][0]);
        tot[t][nt][1] = fmaf(blk[t][nt][1], sc[2 * t], tot[t][nt][1]);
        tot[t][nt][2] = fmaf(blk[t][nt][2], sc[2 * t + 1], tot[t][nt][2]);
        tot[t][nt][3] = fmaf(blk[t][nt][3], sc[2 * t + 1], tot[t][nt][3]);
      }
  }
  ptt::cp_async_wait<0>();

  // the lane's 4 neighbouring columns for activation rows 8 nt + 2c + e
  const int col = tile0 + warp * 32 + 4 * r;
  const bool live = col < dout;
  const int tile_id = blockIdx.z * gridDim.x + blockIdx.x;
  float* part = work + ((size_t)tile_id * splits + split) * XR * BCOLS;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nt + 2 * c + e;
      if (!live || n >= rows) continue;
      const float v[4] = {tot[0][nt][e], tot[0][nt][2 + e], tot[1][nt][e],
                          tot[1][nt][2 + e]};
      if (splits == 1) {
        *reinterpret_cast<uint2*>(out + (size_t)(row0 + n) * dout + col) =
            make_uint2(ptt::pack2<T>(v[0], v[1]), ptt::pack2<T>(v[2], v[3]));
      } else {
        *reinterpret_cast<float4*>(part + n * BCOLS + warp * 32 + 4 * r) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  if (splits == 1) return;
  if (!ptt::arrive_last(arrivals + tile_id, splits, &last_in)) return;

  // the last block of the tile: the splits' partials added in split order
  const float* parts = work + (size_t)tile_id * splits * XR * BCOLS;
  constexpr int CH = 4;  // splits whose loads are issued together
  for (int idx = tid; idx < rows * (BCOLS / 4); idx += THREADS) {
    const int n = idx / (BCOLS / 4), c4 = idx % (BCOLS / 4);
    const int j = tile0 + 4 * c4;
    if (j >= dout) continue;
    const float* p = parts + n * BCOLS + 4 * c4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += CH) {
      float4 v[CH];
#pragma unroll
      for (int u = 0; u < CH; ++u)
        v[u] = s0 + u < splits
                   ? __ldcg(reinterpret_cast<const float4*>(
                         p + (size_t)(s0 + u) * XR * BCOLS))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < CH; ++u)
        if (s0 + u < splits) {
          acc.x += v[u].x;
          acc.y += v[u].y;
          acc.z += v[u].z;
          acc.w += v[u].w;
        }
    }
    *reinterpret_cast<uint2*>(out + (size_t)(row0 + n) * dout + j) =
        make_uint2(ptt::pack2<T>(acc.x, acc.y), ptt::pack2<T>(acc.z, acc.w));
  }
  if (tid == 0) arrivals[tile_id] = 0;  // ready for the next launch
}

template <typename T, int BITS, int NT>
int launch_mma(const void* x, const void* qw, const void* scales, void* out,
               void* work, void* arrivals, int m, int din, int dout,
               int splits, cudaStream_t stream) {
  auto kernel = qmm_mma_kernel<T, BITS, NT>;
  const size_t smem = MmaGeo<BITS, NT>::SMEM;
  const cudaError_t attr = ptt::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((dout + BCOLS - 1) / BCOLS, splits,
                  (m + GROUP_ROWS - 1) / GROUP_ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw),
      static_cast<const __nv_bfloat16*>(scales), static_cast<T*>(out),
      static_cast<float*>(work), static_cast<int*>(arrivals), m, din, dout,
      splits);
  return cudaGetLastError();
}

// the instance for m rows: 1, 2, 4 or 8 n-tiles of 8 (8 past 64 rows,
// which take one block row per 64)
template <typename T, int BITS>
int dispatch_mma(const void* x, const void* qw, const void* scales, void* out,
                 void* work, void* arrivals, int m, int din, int dout,
                 int splits, cudaStream_t stream) {
  if (m <= 8)
    return launch_mma<T, BITS, 1>(x, qw, scales, out, work, arrivals, m, din,
                                  dout, splits, stream);
  if (m <= 16)
    return launch_mma<T, BITS, 2>(x, qw, scales, out, work, arrivals, m, din,
                                  dout, splits, stream);
  if (m <= 32)
    return launch_mma<T, BITS, 4>(x, qw, scales, out, work, arrivals, m, din,
                                  dout, splits, stream);
  return launch_mma<T, BITS, 8>(x, qw, scales, out, work, arrivals, m, din,
                                dout, splits, stream);
}

}  // namespace

// The two routes. dtype of x and out: 0 = fp32, 1 = bf16, 2 = fp16 (the
// scales are bf16 whatever x is).
//
// simt (any dtype; the wrapper sends fp32): mt activation rows per block
// (1, 2 or 4); partial: fp32 [splits, m, dout] scratch, unused when
// splits == 1.
extern "C" int quant_matmul_fwd_simt(const void* x, const void* qw,
                                     const void* scales, void* out,
                                     void* partial, int m, int din, int dout,
                                     int bits, int mt, int splits, int dtype,
                                     void* stream) {
  if (m < 1 || din < QB || din % QB != 0 || dout < 16 || dout % 16 != 0 ||
      splits < 1 || splits > din / QB)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_dtype(dtype, [&](auto tag) {
    return dispatch_bits<typename decltype(tag)::type>(
        bits, mt, x, qw, scales, out, partial, m, din, dout, splits, st);
  });
}

// mma (dtype 1 or 2): work: fp32 scratch of at least ceil(m / 64) x
// ceil(dout / 128) x splits x 64 x 128 floats (8 x ceil(min(m, 64) / 8)
// rows a block, rounded up to 8, 16, 32 or 64); arrivals: int32
// [ceil(m / 64) x ceil(dout / 128)], all 0 (the kernel leaves them 0
// again). Both are unused when splits == 1.
extern "C" int quant_matmul_fwd_mma(const void* x, const void* qw,
                                    const void* scales, void* out, void* work,
                                    void* arrivals, int m, int din, int dout,
                                    int bits, int splits, int dtype,
                                    void* stream) {
  if (m < 1 || din < QB || din % QB != 0 || dout < 16 || dout % 16 != 0 ||
      splits < 1 || splits > din / QB || (bits != 8 && bits != 4))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_half_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return bits == 8 ? dispatch_mma<T, 8>(x, qw, scales, out, work, arrivals,
                                          m, din, dout, splits, st)
                     : dispatch_mma<T, 4>(x, qw, scales, out, work, arrivals,
                                          m, din, dout, splits, st);
  });
}
