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
// Two kernels, chosen by the wrapper from the dtype and head_dim alone.
//
// mma (bf16, fp16 at d 64 and 128): split-KV on the tensor cores over the
// TPU kernel's fixed grid. The (R, kvh, M) grid becomes chunks x R x
// kv-head groups blocks: chunk j of row r covers the row's table slots
// [j C, (j + 1) C), and a row's chunks form one thread-block cluster. A
// block reads seq_lens[r] itself and streams only the positions of its
// chunk that the query attends (the TPU kernel's `run` predicate and
// index-map clamp, at chunk granularity); a chunk with none of them
// streams nothing. Inside a chunk a warp per kv head streams 16-position
// tiles of K and V, gathered through the block table by 16-byte cp.async,
// two stages deep, and runs S^T = K Q^T and O^T += V^T P^T with mma.sync
// m16n8k16: the positions are the 16-row side (K by ldmatrix, V by
// ldmatrix.trans) and the head's query rows the 8-wide n side, so a group
// of up to 8 query heads wastes half a tile, not three quarters, and a
// tile costs half the products and exponentials of the query-rows-as-A
// layout. P^T reaches the B operand from the S^T accumulator by movmatrix.
// Each live chunk leaves its (acc, m, l) per query row in its own shared
// memory; after a cluster barrier every block of the cluster merges a
// slice of the row's (head, query row, dims) over the row's live chunks,
// in chunk order, reading its peers' partials through distributed shared
// memory, and writes the output; a second barrier keeps every block's
// shared memory alive until its peers have read it. Nothing goes through
// device memory but the inputs and the output, the launch shape depends
// on the static shapes and the card alone, and the result repeats bit for
// bit.
//
// simt (fp32, and head_dim 256; the design of the first port): the
// TPU kernel's fixed (R, kvh, M) grid becomes one block of 8 warps per
// (kv head, row); its third axis, the row's table slots, becomes a loop
// inside the block from the first in-window slot to the last live one (the
// TPU kernel's index-map clamp, written as the loop's bounds), so a slot
// past the live count is never read. The loop runs in tiles of KT
// positions: each tile's K and V rows are fetched into registers one tile
// ahead, stored to shared memory as fp32, and each physical K/V row is
// read once for the head's whole query group. Per tile: scores [group, KT]
// (one thread per pair, float4 dot products), an online softmax per query
// row (one warp per row), and the PV product (one thread per output
// element) -- the ragged simt kernel's order of sums, so without a window
// (the loop then starts at position 0 in both) the two kernels agree bit
// for bit.
#include <cooperative_groups.h>

#include "mma.cuh"

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

// --------------------------------------------------------------- mma route
namespace cg = cooperative_groups;

constexpr int TILE = 16;        // positions a warp stages and scores at once
constexpr int MAX_HPB = 4;      // kv heads a block takes, one warp each
constexpr int KV_STAGES = 2;    // tiles of K and V a warp has staged
constexpr int MAX_CLUSTER = 16;  // chunks a row, at most (non-portable > 8)

constexpr float LOG2E = 1.4426950408889634f;

template <int D, int NT>
struct MmaGeo {
  // a staged row: d elements and 16 bytes more, so that the 8 rows an
  // ldmatrix reads fall on distinct banks
  static constexpr int RS = D * 2 + 16;
  static constexpr int TILE_BYTES = TILE * RS;
  // Q^T's B fragments stay in registers unless they and O^T would not fit
  // beside each other (d 128 at 32 query rows): then Q sits in shared
  // memory and comes by ldmatrix
  static constexpr bool Q_SMEM = NT * D > 256;
  static constexpr int Q_BYTES = Q_SMEM ? 8 * NT * RS : 0;
  // Q, then K and V of each stage
  static constexpr int WARP_BYTES = Q_BYTES + 2 * KV_STAGES * TILE_BYTES;
  // after the loop the same bytes hold the head's partial: acc [8 NT][PD]
  // (4 floats of padding a row keep the fragment stores on distinct
  // banks), then m [8 NT] and l [8 NT]
  static constexpr int ROWS = 8 * NT;
  static constexpr int PD = D + 4;
  static constexpr int STATS = ROWS * PD;
  static_assert(4 * (STATS + 2 * ROWS) <= WARP_BYTES,
                "a partial must fit its warp's stages");
};

// An 8x8 matrix of 16-bit pairs, one 32-bit register a lane (row lane / 4,
// columns 2 (lane % 4) and + 1), transposed across the warp.
__device__ inline uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// Grid (chunks, R, kv-head groups), one cluster per (row, group) along the
// chunk axis; a block of one warp per kv head of its group. Chunk j covers
// positions [j C B, (j + 1) C B) of its row; the positions the query
// attends are [lo, hi), so the chunk streams [p0, p1), their overlap, and
// is live when that is not empty.
//
// Positions are the 16-row side of mma.sync m16n8k16 and the head's query
// rows its n side, NT tiles of 8 (row i is query head hk * group + i; rows
// past group are zeros): S^T = K Q^T takes K by ldmatrix as A and Q^T as B
// (from registers, or by ldmatrix where Q sits in shared memory); O^T +=
// V^T P^T takes V by ldmatrix.trans as A and P^T as
// B, moved from the S^T accumulator's layout by movmatrix. Lane l (r =
// l / 4, c = l % 4) holds the scores of positions r and r + 8 for query
// rows 8 nt + 2c and + 1, and O^T for dims 16 dt + r and + 8 of the same
// rows.
template <typename T, int D, int NT>
__global__ void __launch_bounds__(MAX_HPB * 32)
    grid_mma_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int h,
                    int kvh, int M, int B, float scale, int window, int C) {
  using Geo = MmaGeo<D, NT>;
  constexpr int RS = Geo::RS, PD = Geo::PD, ROWS = Geo::ROWS;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int hpb = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, c = lane & 3;
  const int chunk = blockIdx.x, row = blockIdx.y;
  const int group = h / kvh;
  const int hk = blockIdx.z * hpb + warp;
  const int span = C * B;  // positions a chunk covers
  const int len = lens[row];
  const int lo = window > 0 ? max(0, len + 1 - window) : 0;
  const int hi = min(len + 1, M * B);
  const int p0 = max(lo, chunk * span), p1 = min(hi, (chunk + 1) * span);

  if (p0 < p1) {
    // the table entries of the blocks [p0, p1) touches, and no other
    const int b_lo = p0 / B;
    int* tb = reinterpret_cast<int*>(smem + hpb * Geo::WARP_BYTES);
    for (int i = b_lo + tid; i <= (p1 - 1) / B; i += blockDim.x)
      tb[i - b_lo] = tables[(size_t)row * M + i];
    __syncthreads();

    if (hk < kvh) {
      unsigned char* qs = smem + warp * Geo::WARP_BYTES;
      unsigned char* kv0 = qs + Geo::Q_BYTES;  // K0 V0 K1 V1
      const T* qh = q + ((size_t)row * h + hk * group) * D;
      // Q^T as B fragments: query row 8 nt + r at dims 16 ks + 2c, + 1
      // (b0) and 16 ks + 8 + 2c, + 1 (b1); or Q's rows in shared memory
      uint32_t qb[Geo::Q_SMEM ? 1 : NT][D / 16][2];
      if constexpr (Geo::Q_SMEM) {
        for (int i = lane; i < 8 * NT * CH; i += 32) {
          const int qi = i / CH, ch = i % CH;
          const bool ok = qi < group;
          ptt::cp_async16(qs + qi * RS + ch * 16,
                          qh + (ok ? qi : 0) * D + ch * 8, ok);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int qi = 8 * nt + r;
          const bool ok = qi < group;
          const uint32_t* qrow =
              reinterpret_cast<const uint32_t*>(qh + (ok ? qi : 0) * D);
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            qb[nt][ks][0] = ok ? qrow[8 * ks + c] : 0u;
            qb[nt][ks][1] = ok ? qrow[8 * ks + 4 + c] : 0u;
          }
        }
      }
      // stage positions t0 .. t0 + 15 (zeros at or past p1), each row
      // gathered through the block table
      auto stage = [&](int t0, int st) {
        unsigned char* kt = kv0 + st * 2 * Geo::TILE_BYTES;
        unsigned char* vt = kt + Geo::TILE_BYTES;
        const int b0 = t0 / B, o0 = t0 - b0 * B;
#pragma unroll
        for (int i = lane; i < TILE * CH; i += 32) {
          const int rw = i / CH, ch = i % CH;
          const bool ok = t0 + rw < p1;
          // the row's block and offset, without a division where B >= 16
          int blk = b0, off = o0 + rw;
          if (B >= TILE) {
            if (off >= B) {
              ++blk;
              off -= B;
            }
          } else {
            blk += off / B;
            off %= B;
          }
          const size_t at =
              ok ? (((size_t)tb[blk - b_lo] * B + off) * kvh + hk) * D +
                       ch * 8
                 : 0;
          ptt::cp_async16(kt + rw * RS + ch * 16, kp + at, ok);
          ptt::cp_async16(vt + rw * RS + ch * 16, vp + at, ok);
        }
      };
      int t0 = p0;
#pragma unroll
      for (int st = 0; st < KV_STAGES - 1; ++st) {
        if (t0 + st * TILE < p1) stage(t0 + st * TILE, st);
        ptt::cp_async_commit();  // (the query rows go with the first)
      }

      // O^T [dims 16 dt + r (+ 8)][rows 8 nt + 2c (+ 1)]; m and l of this
      // lane's rows 8 nt + 2c + e
      float o[D / 16][NT][4], m[NT][2], l[NT][2];
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          o[dt][nt][0] = o[dt][nt][1] = o[dt][nt][2] = o[dt][nt][3] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        m[nt][0] = m[nt][1] = NEG_INF;
        l[nt][0] = l[nt][1] = 0.f;
      }
      const int mi = lane / 8;  // the 8x8 matrix this lane points at
      const float scale2 = scale * LOG2E;
      for (int st = 0; t0 < p1; t0 += TILE, st = (st + 1) % KV_STAGES) {
        ptt::cp_async_wait<KV_STAGES - 2>();
        __syncwarp();
        // the stage KV_STAGES - 1 tiles on goes into the slot freed last
        // turn
        const int ahead = t0 + (KV_STAGES - 1) * TILE;
        if (ahead < p1) stage(ahead, (st + KV_STAGES - 1) % KV_STAGES);
        ptt::cp_async_commit();
        const unsigned char* kt = kv0 + st * 2 * Geo::TILE_BYTES;
        const unsigned char* vt = kt + Geo::TILE_BYTES;

        // S^T = K Q^T over the dims, even and odd k steps in two sums so
        // the products do not wait on each other; matrices (positions 0-7,
        // 8-15) x (dims 16 ks, + 8)
        float s[2][NT][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            s[u][nt][0] = s[u][nt][1] = s[u][nt][2] = s[u][nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ks += 2) {
          // Q^T for k steps ks and ks + 1: (b0, b1) of each
          uint32_t qf[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if constexpr (Geo::Q_SMEM) {
              ptt::ldmatrix_x4(qf[nt], qs + (8 * nt + lane % 8) * RS +
                                           (16 * ks + 8 * mi) * 2);
            } else {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                qf[nt][2 * u] = qb[nt][ks + u][0];
                qf[nt][2 * u + 1] = qb[nt][ks + u][1];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t ka[4];
            ptt::ldmatrix_x4(ka, kt + (8 * (mi % 2) + lane % 8) * RS +
                                     (16 * (ks + u) + 8 * (mi / 2)) * 2);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              ptt::mma16816<T>(s[u][nt], ka, qf[nt] + 2 * u);
          }
        }

        // online softmax of each query row over the tile's positions in
        // [t0, p1); scores, maxima and sums in fp32, exp as exp2 of the
        // scaled difference (0 where it is -inf-like: the finite mask)
        const bool ok0 = t0 + r < p1, ok1 = t0 + r + 8 < p1;
        uint32_t pb[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float pv[2][2];  // [position r, r + 8][row 2c + e]
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x0 = (s[0][nt][e] + s[1][nt][e]) * scale2;
            const float x1 = (s[0][nt][2 + e] + s[1][nt][2 + e]) * scale2;
            float mx = m[nt][e];
            if (ok0) mx = fmaxf(mx, x0);
            if (ok1) mx = fmaxf(mx, x1);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
            const float alpha = exp2f(m[nt][e] - mx);
            m[nt][e] = mx;
            pv[0][e] = ok0 ? exp2f(x0 - mx) : 0.f;
            pv[1][e] = ok1 ? exp2f(x1 - mx) : 0.f;
            l[nt][e] = l[nt][e] * alpha + (pv[0][e] + pv[1][e]);
#pragma unroll
            for (int dt = 0; dt < D / 16; ++dt) {
              o[dt][nt][e] *= alpha;
              o[dt][nt][2 + e] *= alpha;
            }
          }
          // p through V's type before the PV product, as on the TPU, then
          // from (position, row pair) to P^T's B layout (position pair, row)
          pb[nt][0] = movmatrix_trans(ptt::pack2<T>(pv[0][0], pv[0][1]));
          pb[nt][1] = movmatrix_trans(ptt::pack2<T>(pv[1][0], pv[1][1]));
        }

        // O^T += V^T P^T: V^T as A (m = dims, k = positions) by
        // ldmatrix.trans; matrices (dims 16 dt, + 8) x (positions 0-7, 8-15)
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          uint32_t va[4];
          ptt::ldmatrix_x4_trans(va, vt + (8 * (mi / 2) + lane % 8) * RS +
                                         (16 * dt + 8 * (mi % 2)) * 2);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            ptt::mma16816<T>(o[dt][nt], va, pb[nt]);
        }
        __syncwarp();  // this slot is restaged next turn
      }
      ptt::cp_async_wait<0>();
      __syncwarp();  // the stages are free: the partial goes there

      // this chunk's partial for the head, in its warp's shared memory: m
      // in log2 units, l summed over the lanes' positions
      float* part = reinterpret_cast<float*>(qs);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float lt = l[nt][e];
          lt += __shfl_xor_sync(0xffffffffu, lt, 4);
          lt += __shfl_xor_sync(0xffffffffu, lt, 8);
          lt += __shfl_xor_sync(0xffffffffu, lt, 16);
          const int i = 8 * nt + 2 * c + e;
          if (i >= group) continue;
          if (r == 0) {
            part[Geo::STATS + i] = m[nt][e];
            part[Geo::STATS + ROWS + i] = lt;
          }
#pragma unroll
          for (int dt = 0; dt < D / 16; ++dt) {
            part[i * PD + 16 * dt + r] = o[dt][nt][e];
            part[i * PD + 16 * dt + r + 8] = o[dt][nt][2 + e];
          }
        }
    }
  }
  cluster.sync();  // every live chunk's partial is in place

  // the merge: the cluster's threads share the (head, query row, 4 dims)
  // units of the row's output; each runs the online softmax merge over the
  // row's live chunks in chunk order (a dead chunk would be its identity),
  // KG chunks' loads issued together; the maxima are in log2 units
  constexpr int KG = 4, Q4 = D / 4;
  const int c_lo = lo / span, c_hi = (hi - 1) / span;
  const int units = hpb * group * Q4;
  const int nthreads = gridDim.x * blockDim.x;
  for (int u = chunk * blockDim.x + tid; u < units; u += nthreads) {
    const int hw = u / (group * Q4), i = u / Q4 % group, q4 = u % Q4;
    const int head = blockIdx.z * hpb + hw;
    if (head >= kvh) continue;
    float* mine = reinterpret_cast<float*>(smem + hw * Geo::WARP_BYTES);
    float mx = NEG_INF, lt = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = c_lo; k0 <= c_hi; k0 += KG) {
      float mk[KG], lk[KG];
      float4 v[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float* pp = cluster.map_shared_rank(mine, min(k0 + g, c_hi));
        mk[g] = pp[Geo::STATS + i];
        lk[g] = pp[Geo::STATS + ROWS + i];
        v[g] = *reinterpret_cast<const float4*>(pp + i * PD + 4 * q4);
      }
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (k0 + g > c_hi) break;
        const float mn = fmaxf(mx, mk[g]);
        const float a = exp2f(mx - mn), b = exp2f(mk[g] - mn);
        mx = mn;
        lt = lt * a + lk[g] * b;
        acc.x = acc.x * a + v[g].x * b;
        acc.y = acc.y * a + v[g].y * b;
        acc.z = acc.z * a + v[g].z * b;
        acc.w = acc.w * a + v[g].w * b;
      }
    }
    const float inv_l = 1.f / fmaxf(lt, 1e-30f);
    *reinterpret_cast<uint2*>(out + ((size_t)row * h + head * group + i) * D +
                              4 * q4) =
        make_uint2(ptt::pack2<T>(acc.x * inv_l, acc.y * inv_l),
                   ptt::pack2<T>(acc.z * inv_l, acc.w * inv_l));
  }
  cluster.sync();  // no block leaves while a peer may read its partials
}

struct MmaArgs {
  const void *q, *kp, *vp, *tables, *lens;
  void* out;
  int R, h, kvh, M, B;
  float scale;
  int window, chunks, chunk_blocks, hpb;
  cudaStream_t stream;
};

template <typename T, int D, int NT>
int launch_mma(const MmaArgs& a) {
  auto kernel = grid_mma_kernel<T, D, NT>;
  // clusters of more than 8 blocks need the kernel's consent, given once
  static const cudaError_t wide = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (wide != cudaSuccess) return wide;
  const size_t smem = (size_t)a.hpb * MmaGeo<D, NT>::WARP_BYTES +
                      sizeof(int) * a.chunk_blocks;
  const cudaError_t attr = ptt::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.chunks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.chunks, a.R, (a.kvh + a.hpb - 1) / a.hpb);
  cfg.blockDim = dim3(a.hpb * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lens), static_cast<T*>(a.out), a.h, a.kvh,
      a.M, a.B, a.scale, a.window, a.chunk_blocks);
}

// query rows on the n side in tiles of 8: 1, 2 or 4 tiles
template <typename T, int D>
int dispatch_rows(const MmaArgs& a) {
  const int group = a.h / a.kvh;
  if (group <= 8) return launch_mma<T, D, 1>(a);
  if (group <= 16) return launch_mma<T, D, 2>(a);
  return launch_mma<T, D, 4>(a);
}

}  // namespace

// The two routes. window <= 0 means none.
//
// simt (dtype 0 = fp32, 1 = bf16, 2 = fp16; the wrapper sends fp32 and
// head_dim 256): one block of 8 warps per (kv head, row).
extern "C" int paged_attention_fwd_simt(const void* q, const void* kp,
                                        const void* vp, const void* tables,
                                        const void* lens, void* out, int R,
                                        int h, int kvh, int d, int M, int B,
                                        float scale, int window, int dtype,
                                        void* stream) {
  if (R < 1 || kvh < 1 || h % kvh != 0 || h / kvh > MAX_GROUP || M < 1 ||
      B < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_dtype(dtype, [&](auto tag) {
    return dispatch_d<typename decltype(tag)::type>(
        d, q, kp, vp, tables, lens, out, R, h, kvh, M, B, scale, window, st);
  });
}

// mma (dtype 1 = bf16 or 2 = fp16, head_dim 64 or 128): `chunks` blocks a
// row (one cluster, at most 16) of `chunk_blocks` table slots each, with
// chunks x chunk_blocks >= M, and `hpb` kv heads a block (1, 2 or 4).
extern "C" int paged_attention_fwd_mma(const void* q, const void* kp,
                                       const void* vp, const void* tables,
                                       const void* lens, void* out, int R,
                                       int h, int kvh, int d, int M, int B,
                                       float scale, int window, int chunks,
                                       int chunk_blocks, int hpb, int dtype,
                                       void* stream) {
  if (R < 1 || R > 65535 || kvh < 1 || h % kvh != 0 ||
      h / kvh > MAX_GROUP || M < 1 || B < 1 || chunks < 1 ||
      chunks > MAX_CLUSTER || chunk_blocks < 1 ||
      (long long)chunks * chunk_blocks < M || hpb < 1 || hpb > MAX_HPB)
    return cudaErrorInvalidValue;
  const MmaArgs a{q, kp, vp, tables, lens, out, R, h, kvh, M, B, scale,
                  window, chunks, chunk_blocks, hpb,
                  static_cast<cudaStream_t>(stream)};
  return ptt::by_half_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (d == 64) return dispatch_rows<T, 64>(a);
    if (d == 128) return dispatch_rows<T, 128>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
