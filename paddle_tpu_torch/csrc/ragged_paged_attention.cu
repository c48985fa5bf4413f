// Ragged paged attention for Hopper (sm_90a), fp32, bf16 or fp16 in, fp32
// accumulate. What it replaces, what bounds it and how the design answers
// that: see paddle_tpu_torch/ops/kernels/ragged_paged_attention.py.
//
// Layout: q [R, T, h, d] (T = 1 for the single-query decode tick), pools
// [P, B, kvh, d], block_tables [R, M] int32, seq_lens [R] int32, out like
// q. Query t of row r sits at position seq_lens[r] + t and attends
// positions 0 .. seq_lens[r] + t (only the trailing `window` of them when
// window > 0). Logical position p of row r lives in physical block
// block_tables[r, p / B] at offset p % B.
//
// Two kernels, chosen by the wrapper from the dtype and head_dim alone.
//
// mma (bf16, fp16 at d 64 and 128): split-KV on the tensor cores. A row's
// live positions are cut into chunks of C table blocks, and a flat list of
// live (row, chunk) items, built by every block from seq_lens (a prefix
// sum over the rows), takes one block per item and group of up to 4 kv
// heads: R x ceil(M / C) x ceil(kvh / 4) blocks, a shape fixed by the
// static shapes, so a call replays in a CUDA graph after seq_lens and the
// tables change. Inside a chunk a warp streams 16-position tiles of its
// kv head's K and V rows, gathered through the block table with one
// 16-byte cp.async per piece of a row, two stages deep, and runs S = Q K^T
// and O += P V with mma.sync m16n8k16: the head's T x group query rows are
// the A operand (1 or 2 tiles of 16, from ldmatrix), K comes by ldmatrix,
// V by ldmatrix.trans, O stays in registers. Each query row has its own
// causal and window edge. A row with one live chunk writes its output;
// otherwise each chunk writes its (m, l, acc) per query row to a
// workspace, and the last chunk of the row to arrive at its counter merges
// them in chunk order and resets the counter: the result depends on the
// shapes and seq_lens alone and repeats bit for bit.
//
// simt (fp32, and head_dim 256; the design of the first port): one block
// of 8 warps per (kv head, row). It reads seq_lens[r] and the row's table
// entries itself, holds that head's T x group query rows in shared memory,
// and walks the row's live positions in tiles of KT: each tile's K and V
// rows are fetched into registers one tile ahead, stored to shared memory
// as fp32, and each physical K/V row is read once for all the head's query
// rows. Per tile: scores [rows, KT] (one thread per pair, float4 dot
// products), an online softmax per query row (one warp per row), and the
// PV product (one thread per output element).
#include "mma.cuh"

namespace {

using ptt::Elt;
using ptt::NEG_INF;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 32;  // T x group query rows per (row, kv head)

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
inline __host__ __device__ Smem layout(int rows) {
  constexpr int KT = Tile<D>::KT, LD = Tile<D>::LD;
  Smem o;
  o.q = 0;                   // q_s [rows][LD]
  o.k = o.q + rows * LD;     // k_s [KT][LD]
  o.v = o.k + KT * LD;       // v_s [KT][D]
  o.s = o.v + KT * D;        // s_s [rows][KT]: scores, then rounded p
  o.m = o.s + rows * KT;     // running max per query row
  o.l = o.m + MAX_ROWS;      // running sum per query row
  o.a = o.l + MAX_ROWS;      // this tile's rescale factor per query row
  o.total = o.a + MAX_ROWS;
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
    ragged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ tables,
                  const int* __restrict__ lens, T* __restrict__ out, int qlen,
                  int h, int kvh, int M, int B, float scale, int window) {
  using Ld = Loader<T, D>;
  constexpr int KT = Tile<D>::KT, LD = Tile<D>::LD;
  constexpr int NACC = MAX_ROWS * D / THREADS;  // outputs per thread, at most
  const int hk = blockIdx.x, r = blockIdx.y;
  const int group = h / kvh;
  const int rows = qlen * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float sm[];
  const Smem L = layout<D>(rows);
  float* q_s = sm + L.q;
  float* k_s = sm + L.k;
  float* v_s = sm + L.v;
  float* s_s = sm + L.s;
  float* m_s = sm + L.m;
  float* l_s = sm + L.l;
  float* a_s = sm + L.a;

  // query row i = t * group + g is query head hk*group + g at position
  // seq_len + t (position-major, as the TPU kernel packs its sublanes)
  for (int idx = tid; idx < rows * Ld::CPR; idx += THREADS) {
    const int i = idx / Ld::CPR, c = idx % Ld::CPR;
    const int t = i / group, g = i % group;
    float f[Ld::EPC];
    ptt::load_floats<T, Ld::EPC>(
        q + (((size_t)r * qlen + t) * h + hk * group + g) * D + c * Ld::EPC,
        f);
#pragma unroll
    for (int e = 0; e < Ld::EPC; ++e) q_s[i * LD + c * Ld::EPC + e] = f[e];
  }
  if (tid < MAX_ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int len = lens[r];
  // live positions: from the first query's window start to the last
  // query's position; positions outside are masked for every query row
  const int lo = window > 0 ? max(0, len + 1 - window) : 0;
  const int hi = min(len + qlen, M * B);
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
    for (int pidx = tid; pidx < rows * KT; pidx += THREADS) {
      const int i = pidx / KT, j = pidx % KT;
      const int p = base + j;
      const int qpos = len + i / group;
      float s = NEG_INF;
      if (p < hi && p <= qpos && (window <= 0 || p > qpos - window)) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + i * LD);
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
      s_s[i * KT + j] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int i = warp; i < rows; i += WARPS) {
      const float m_old = m_s[i];
      float mx = NEG_INF;
      for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, s_s[i * KT + j]);
      mx = ptt::warp_max(mx);
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < KT; j += 32) {
        const float p = expf(s_s[i * KT + j] - m_new);
        sum += p;
        // p goes through V's type before the PV product, as on the TPU
        s_s[i * KT + j] = Elt<T>::round(p);
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[i] = a;
        l_s[i] = l_s[i] * a + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int k = 0; k < NACC; ++k) {
      const int o = tid + k * THREADS;
      if (o < rows * D) {
        const int i = o / D, dd = o % D;
        const float* prow = s_s + i * KT;
        float a = acc[k] * a_s[i];
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
    if (o < rows * D) {
      const int i = o / D, dd = o % D;
      const int t = i / group, g = i % group;
      out[(((size_t)r * qlen + t) * h + hk * group + g) * D + dd] =
          Elt<T>::from_float(acc[k] / fmaxf(l_s[i], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lens, void* out, int R,
                   int qlen, int h, int kvh, int M, int B, float scale,
                   int window, cudaStream_t stream) {
  auto kernel = ragged_kernel<T, D>;
  // opt in once, for the largest row count, at the first (uncaptured)
  // call: a launch inside a CUDA graph capture then sets no attribute
  static const cudaError_t attr = ptt::allow_smem(
      kernel, sizeof(float) * layout<D>(MAX_ROWS).total);
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(float) * layout<D>(qlen * (h / kvh)).total;
  kernel<<<dim3(kvh, R), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), qlen, h, kvh, M, B,
      scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kp, const void* vp,
                       const void* tables, const void* lens, void* out, int R,
                       int qlen, int h, int kvh, int M, int B, float scale,
                       int window, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, kp, vp, tables, lens, out, R, qlen, h, kvh, M,
                           B, scale, window, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, tables, lens, out, R, qlen, h, kvh, M,
                            B, scale, window, stream);
    case 256:
      return launch<T, 256>(q, kp, vp, tables, lens, out, R, qlen, h, kvh, M,
                            B, scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------------- mma route
constexpr int TILE = 16;       // positions a warp stages and scores at once
constexpr int MAX_HPB = 4;     // kv heads a block takes, one warp each
constexpr int KV_STAGES = 2;   // tiles of K and V a warp has staged

// Floats of one chunk's partial: acc [rows][d], m [rows], l [rows],
// rounded up to a multiple of 4 so every partial starts on 16 bytes.
__host__ __device__ inline int partial_span(int rows, int d) {
  return (rows * (d + 2) + 3) / 4 * 4;
}

template <int D, int MT>
struct MmaGeo {
  // a staged row: d elements and 16 bytes more, so that the 8 rows an
  // ldmatrix reads fall on distinct banks
  static constexpr int RS = D * 2 + 16;
  static constexpr int TILE_BYTES = TILE * RS;
  // the head's query rows in shared memory for two m16 tiles (one tile
  // lives in registers)
  static constexpr int Q_BYTES = MT == 1 ? 0 : 16 * MT * RS;
  // Q, then K and V of each stage
  static constexpr int WARP_BYTES = Q_BYTES + 2 * KV_STAGES * TILE_BYTES;
};

// One block per (work item, group of up to 4 kv heads), one warp per kv
// head. Work item w is the w-th live (row, chunk) pair, rows in order and
// a row's chunks in order: chunk j of a row covers its logical blocks
// [j C, (j + 1) C), and the live chunks are those that hold a position
// some query of the row attends (build_schedule's live blocks, grouped C
// at a time). Items past the last live one return at once.
//
// Fragments of mma.sync m16n8k16 (lane l, r = l / 4, c = l % 4): MT tiles
// of 16 query rows (row i = t * group + g is query head hk * group + g at
// position seq_len + t; rows past T x group are zeros), positions as the
// n side of S = Q K^T and the k side of O += P V. Row 16 mt + r + 8 hh of
// the accumulators belongs to this lane's (mt, hh).
template <typename T, int D, int MT>
__global__ void __launch_bounds__(MAX_HPB * 32)
    ragged_mma_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp,
                      const int* __restrict__ tables,
                      const int* __restrict__ lens, T* __restrict__ out,
                      float* __restrict__ work, int* __restrict__ arrivals,
                      int R, int qlen, int h, int kvh, int M, int B,
                      float scale, int window, int C) {
  using Geo = MmaGeo<D, MT>;
  constexpr int RS = Geo::RS;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  // row, chunk, the row's live chunks, the chunk's place, the row's len
  __shared__ int item[5];
  __shared__ int last_in;
  const int hpb = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane >> 2, c = lane & 3;
  const int w = blockIdx.y;
  const int nc = (M + C - 1) / C;

  // the work list, from seq_lens alone: a prefix sum of the rows' live
  // chunk counts, 32 rows at a time
  if (warp == 0) {
    if (lane == 0) item[0] = -1;
    __syncwarp();
    int base = 0;
    for (int r0 = 0; r0 < R && base <= w; r0 += 32) {
      const int rr = r0 + lane;
      int cnt = 0, c0 = 0, len = 0;
      if (rr < R) {
        len = lens[rr];
        const int nb = min(max((len + qlen + B - 1) / B, 1), M);
        c0 = (window > 0 ? max(len + 1 - window, 0) / B : 0) / C;
        cnt = max((nb - 1) / C - c0 + 1, 1);
      }
      int inc = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int start = base + inc - cnt;
      if (rr < R && w >= start && w < start + cnt) {
        item[0] = rr;
        item[1] = c0 + w - start;
        item[2] = cnt;
        item[3] = w - start;
        item[4] = len;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
  const int row = item[0];
  if (row < 0) return;  // past the live work: the whole block
  const int chunk = item[1], cnt = item[2], kidx = item[3], len = item[4];
  // positions outside [lo, hi) are masked for every query of the row
  const int lo = window > 0 ? max(0, len + 1 - window) : 0;
  const int hi = min(len + qlen, M * B);
  const int p0 = max(lo, chunk * C * B), p1 = min(hi, (chunk + 1) * C * B);
  int* tb = reinterpret_cast<int*>(smem + hpb * Geo::WARP_BYTES);
  for (int i = tid; i < C && chunk * C + i < M; i += blockDim.x)
    tb[i] = tables[(size_t)row * M + chunk * C + i];
  __syncthreads();

  const int group = h / kvh, rows = qlen * group;
  const int hk = blockIdx.x * hpb + warp;
  const bool active = hk < kvh;
  float o[MT][D / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }

  if (active) {
    unsigned char* qs = smem + warp * Geo::WARP_BYTES;
    unsigned char* kv0 = qs + Geo::Q_BYTES;  // K0 V0 K1 V1
    // the query rows as A fragments: in registers for one m16 tile (rows
    // r and r + 8 at k 2c, 2c + 1 and 2c + 8, 2c + 9), else in shared
    // memory for ldmatrix
    uint32_t qreg[MT == 1 ? D / 16 : 1][4];
    if constexpr (MT == 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = r + 8 * hh;
        const bool ok = qi < rows;
        const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
            q + (((size_t)row * qlen + (ok ? qi / group : 0)) * h +
                 hk * group + (ok ? qi % group : 0)) * D);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          qreg[ks][hh] = ok ? qrow[8 * ks + c] : 0u;
          qreg[ks][2 + hh] = ok ? qrow[8 * ks + 4 + c] : 0u;
        }
      }
    } else {
      for (int i = lane; i < 16 * MT * CH; i += 32) {
        const int qi = i / CH, ch = i % CH;
        const bool ok = qi < rows;
        const int t = ok ? qi / group : 0, g = ok ? qi % group : 0;
        ptt::cp_async16(
            qs + qi * RS + ch * 16,
            q + (((size_t)row * qlen + t) * h + hk * group + g) * D + ch * 8,
            ok);
      }
    }
    // stage positions t0 .. t0 + 15 (zeros at or past p1), each row
    // gathered through the chunk's block-table entries
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
            ok ? (((size_t)tb[blk - chunk * C] * B + off) * kvh + hk) * D +
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

    // the lane's query rows: live, and their positions
    int qpos[MT][2];
    bool qlive[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * mt + r + 8 * hh;
        qlive[mt][hh] = i < rows;
        qpos[mt][hh] = len + (i < rows ? i / group : 0);
      }
    auto attends = [&](int mt, int hh, int p) {
      return qlive[mt][hh] && p < p1 && p <= qpos[mt][hh] &&
             (window <= 0 || p > qpos[mt][hh] - window);
    };
    // positions every query row attends: a tile inside them needs no mask
    // (rows past T x group are padding, whatever they compute)
    const int all_lo = window > 0 ? max(p0, len + qlen - window) : p0;
    const int all_hi = min(p1, len + 1);

    const int mi = lane / 8;  // the 8x8 matrix whose row this lane points at
    for (int st = 0; t0 < p1; t0 += TILE, st = (st + 1) % KV_STAGES) {
      ptt::cp_async_wait<KV_STAGES - 2>();
      __syncwarp();
      // the stage KV_STAGES - 1 tiles on goes into the slot freed last turn
      const int ahead = t0 + (KV_STAGES - 1) * TILE;
      if (ahead < p1) stage(ahead, (st + KV_STAGES - 1) % KV_STAGES);
      ptt::cp_async_commit();
      const bool full = t0 >= all_lo && t0 + TILE <= all_hi;
      const unsigned char* kt = kv0 + st * 2 * Geo::TILE_BYTES;
      const unsigned char* vt = kt + Geo::TILE_BYTES;

      // S = Q K^T: 16 positions as two n8 blocks; K rows are positions
      float s[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          s[mt][nb][0] = s[mt][nb][1] = s[mt][nb][2] = s[mt][nb][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        uint32_t qa[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if constexpr (MT == 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) qa[mt][u][e] = qreg[ks + u][e];
            } else {
              ptt::ldmatrix_x4(qa[mt][u],
                               qs + (16 * mt + 8 * (mi % 2) + lane % 8) * RS +
                                   (16 * (ks + u) + 8 * (mi / 2)) * 2);
            }
          }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          // matrices: (k step ks, ks + 1) x (k half 0, 1)
          uint32_t kf[4];
          ptt::ldmatrix_x4(kf, kt + (8 * nb + lane % 8) * RS +
                                   (16 * (ks + mi / 2) + 8 * (mi % 2)) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ptt::mma16816<T>(s[mt][nb], qa[mt][0], kf);
            ptt::mma16816<T>(s[mt][nb], qa[mt][1], kf + 2);
          }
        }
      }

      // online softmax of each query row over the positions it attends;
      // scores, maxima and sums in fp32
      float p[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = m[mt][hh];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s[mt][nb][2 * hh + e] *= scale;
              if (full || attends(mt, hh, t0 + 8 * nb + 2 * c + e))
                mx = fmaxf(mx, s[mt][nb][2 * hh + e]);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float alpha = expf(m[mt][hh] - mx);
          m[mt][hh] = mx;
          l[mt][hh] *= alpha;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pv = full || attends(mt, hh, t0 + 8 * nb + 2 * c + e)
                                   ? expf(s[mt][nb][2 * hh + e] - mx)
                                   : 0.f;
              p[mt][nb][2 * hh + e] = pv;
              l[mt][hh] += pv;
            }
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[mt][j][2 * hh] *= alpha;
            o[mt][j][2 * hh + 1] *= alpha;
          }
        }
      // p through V's type before the PV product, as on the TPU: the
      // accumulator's positions are already the A operand's k
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = ptt::pack2<T>(p[mt][0][0], p[mt][0][1]);
        pa[mt][1] = ptt::pack2<T>(p[mt][0][2], p[mt][0][3]);
        pa[mt][2] = ptt::pack2<T>(p[mt][1][0], p[mt][1][1]);
        pa[mt][3] = ptt::pack2<T>(p[mt][1][2], p[mt][1][3]);
      }
      // O += P V: V as B (k = positions, n = dims) by ldmatrix.trans;
      // matrices (positions 0-7, 8-15) x (dims 8j, 8j + 8)
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t vf[4];
        ptt::ldmatrix_x4_trans(vf, vt + (8 * (mi % 2) + lane % 8) * RS +
                                       (8 * (j + mi / 2)) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ptt::mma16816<T>(o[mt][j], pa[mt], vf);
          ptt::mma16816<T>(o[mt][j + 1], pa[mt], vf + 2);
        }
      }
      __syncwarp();  // this slot is restaged next turn
    }
    ptt::cp_async_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[mt][hh] += __shfl_xor_sync(0xffffffffu, l[mt][hh], 1);
        l[mt][hh] += __shfl_xor_sync(0xffffffffu, l[mt][hh], 2);
      }
  }

  // one chunk: the output; else this chunk's partial: acc [rows][D], then
  // m [rows] and l [rows], the span rounded up to 16 bytes
  const int span = partial_span(rows, D);
  if (active) {
    float* part = work + (((size_t)row * kvh + hk) * nc + kidx) * span;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * mt + r + 8 * hh;
        if (i >= rows) continue;
        if (cnt == 1) {
          const float inv_l = 1.f / fmaxf(l[mt][hh], 1e-30f);
          T* dst = out + (((size_t)row * qlen + i / group) * h + hk * group +
                          i % group) * D;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * c) =
                ptt::pack2<T>(o[mt][j][2 * hh] * inv_l,
                              o[mt][j][2 * hh + 1] * inv_l);
        } else {
          if (c == 0) {
            part[rows * D + i] = m[mt][hh];
            part[rows * D + rows + i] = l[mt][hh];
          }
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(part + i * D + 8 * j + 2 * c) =
                make_float2(o[mt][j][2 * hh], o[mt][j][2 * hh + 1]);
        }
      }
  }
  if (cnt == 1) return;
  int* counter = arrivals + (size_t)row * gridDim.x + blockIdx.x;
  if (!ptt::arrive_last(counter, cnt, &last_in)) return;

  // the last chunk of the row to arrive merges the row's chunks, in chunk
  // order, for every kv head of the block: a thread takes 16 neighbouring
  // dims of one (head, query row) and runs the online softmax merge over
  // the chunks, KG chunks' loads issued together
  constexpr int KG = 4, PER = D / 16;
  const float* base =
      work + ((size_t)row * kvh + blockIdx.x * hpb) * nc * span;
  for (int g = tid; g < hpb * rows * PER; g += blockDim.x) {
    const int hw = g / (rows * PER), i = g / PER % rows, q4 = g % PER;
    const int head = blockIdx.x * hpb + hw;
    if (head >= kvh) continue;
    const float* p0 = base + (size_t)hw * nc * span;
    float mx = NEG_INF, lt = 0.f;
    float4 acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < cnt; k0 += KG) {
      float mk[KG], lk[KG];
      float4 v[KG][4];
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        const float* p = p0 + (size_t)min(k0 + u, cnt - 1) * span;
        mk[u] = __ldcg(p + rows * D + i);
        lk[u] = __ldcg(p + rows * D + rows + i);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[u][j] = __ldcg(reinterpret_cast<const float4*>(
                               p + i * D + 16 * q4) + j);
      }
#pragma unroll
      for (int u = 0; u < KG; ++u) {
        if (k0 + u >= cnt) break;
        const float mn = fmaxf(mx, mk[u]);
        const float a = expf(mx - mn), b = expf(mk[u] - mn);
        mx = mn;
        lt = lt * a + lk[u] * b;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j].x = acc[j].x * a + v[u][j].x * b;
          acc[j].y = acc[j].y * a + v[u][j].y * b;
          acc[j].z = acc[j].z * a + v[u][j].z * b;
          acc[j].w = acc[j].w * a + v[u][j].w * b;
        }
      }
    }
    const float inv_l = 1.f / fmaxf(lt, 1e-30f);
    T* dst = out + (((size_t)row * qlen + i / group) * h + head * group +
                    i % group) * D + 16 * q4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint2*>(dst + 4 * j) =
          make_uint2(ptt::pack2<T>(acc[j].x * inv_l, acc[j].y * inv_l),
                     ptt::pack2<T>(acc[j].z * inv_l, acc[j].w * inv_l));
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

struct MmaArgs {
  const void *q, *kp, *vp, *tables, *lens;
  void *out, *work, *arrivals;
  int R, qlen, h, kvh, M, B;
  float scale;
  int window, chunk;
  cudaStream_t stream;
};

template <typename T, int D, int MT>
int launch_mma(const MmaArgs& a) {
  auto kernel = ragged_mma_kernel<T, D, MT>;
  const int hpb = a.kvh < MAX_HPB ? a.kvh : MAX_HPB;
  const int nc = (a.M + a.chunk - 1) / a.chunk;
  const size_t smem = (size_t)hpb * MmaGeo<D, MT>::WARP_BYTES +
                      sizeof(int) * a.chunk;
  const cudaError_t attr = ptt::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((a.kvh + hpb - 1) / hpb, a.R * nc), hpb * 32, smem,
           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lens), static_cast<T*>(a.out),
      static_cast<float*>(a.work), static_cast<int*>(a.arrivals), a.R,
      a.qlen, a.h, a.kvh, a.M, a.B, a.scale, a.window, a.chunk);
  return cudaGetLastError();
}

template <typename T, int D>
int dispatch_rows(const MmaArgs& a) {
  return a.qlen * (a.h / a.kvh) <= 16 ? launch_mma<T, D, 1>(a)
                                      : launch_mma<T, D, 2>(a);
}

}  // namespace

// The two routes. window <= 0 means none.
//
// simt (dtype 0 = fp32, 1 = bf16, 2 = fp16; the wrapper sends fp32 and
// head_dim 256): one block of 8 warps per (kv head, row).
extern "C" int ragged_paged_attention_fwd_simt(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* lens, void* out, int R, int qlen, int h, int kvh, int d,
    int M, int B, float scale, int window, int dtype, void* stream) {
  if (R < 1 || qlen < 1 || kvh < 1 || h % kvh != 0 ||
      qlen * (h / kvh) > MAX_ROWS || M < 1 || B < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ptt::by_dtype(dtype, [&](auto tag) {
    return dispatch_d<typename decltype(tag)::type>(
        d, q, kp, vp, tables, lens, out, R, qlen, h, kvh, M, B, scale, window,
        st);
  });
}

// mma (dtype 1 = bf16 or 2 = fp16, head_dim 64 or 128): split-KV over
// chunks of `chunk` table blocks. work: fp32 scratch of at least R x kvh x
// ceil(M / chunk) x partial_span(T x (h / kvh), d) floats; arrivals: int32
// [R x ceil(kvh / min(kvh, 4))], all 0 (the kernel leaves them 0 again).
extern "C" int ragged_paged_attention_fwd_mma(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* lens, void* out, void* work, void* arrivals, int R, int qlen,
    int h, int kvh, int d, int M, int B, float scale, int window, int chunk,
    int dtype, void* stream) {
  if (R < 1 || qlen < 1 || kvh < 1 || h % kvh != 0 ||
      qlen * (h / kvh) > MAX_ROWS || M < 1 || B < 1 || chunk < 1 ||
      chunk > M)
    return cudaErrorInvalidValue;
  const MmaArgs a{q, kp, vp, tables, lens, out, work, arrivals, R, qlen, h,
                  kvh, M, B, scale, window, chunk,
                  static_cast<cudaStream_t>(stream)};
  return ptt::by_half_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (d == 64) return dispatch_rows<T, 64>(a);
    if (d == 128) return dispatch_rows<T, 128>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
