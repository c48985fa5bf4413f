// Single-query decode attention over a static KV cache for Hopper
// (sm_90a), split along T, fp32 accumulate. What it replaces, what bounds
// it and how the design answers that: see
// paddle_tpu_torch/ops/kernels/decode_attention.py.
//
// Layout: q [b, h, d], caches [b, T, kv, d], out [b, h, d]. Positions
// 0..cache_index attend (only the trailing `window` of them when
// window > 0). Query head kvh*G + g reads kv head kvh, G = h / kv.
// cache_index is a host int, or is read by every block from an int32
// array on the device (the TPU kernel's scalar-prefetch operand): one
// index for all rows (stride 0) or one a row (stride 1). A CUDA graph of
// a decode step then replays at whatever index the step wrote there. The
// device value is clamped into [0, T); the caller keeps it in range.
//
// Grid (splits, kv, b): split s of (row, kv head) covers cache positions
// [s * chunk, (s + 1) * chunk), chunk = ceil(T / splits), with `splits`
// chosen by the wrapper from T, b * kv and the SM count, never from
// cache_index, so the launch shape is the same at every decode step. A
// split with no attended position returns at once. Each block has 4
// warps; every K/V row is read once for all G query heads of its kv head.
//
// mma (bf16, fp16): each warp takes 16-position tiles of the split in
// turn and stages each tile's K and V rows in its own shared memory with
// cp.async (two stages: the next tile loads while this one is used). The
// group's queries are the A operand of mma.sync m16n8k16 (heads as rows,
// padded to 16), K the B operand (ldmatrix), so S = Q K^T over 16
// positions is d/8 tensor-core products; the online softmax runs on the
// fp32 accumulator (a row's max over the 4 lanes of a quad), and p rounded
// to V's type is already the A operand of O += P V, whose B = V comes from
// ldmatrix.trans. O stays in registers.
//
// simt (fp32): a K/V row of d elements is read by d / 4 lanes (at most 32)
// with 16-byte loads, so a warp reads several neighbouring rows at once;
// each lane holds its slice of the group's queries, scores its rows
// against them (a sum over the row's lanes) and keeps one online softmax
// per query head, with the next pass's rows in flight.
//
// The warps (or row streams) of a block merge in a fixed order through
// shared memory. The splits merge in the same launch: with one live split
// the block writes the output; otherwise each live block writes its
// (m, l, acc) per query head to the workspace, and the last one to arrive
// at its (row, kv head) counter merges the live splits in split order and
// resets the counter. The order of every sum is fixed by the shapes and
// cache_index alone, so two runs give the same bits. Scores, maxima and
// sums stay in fp32, so fp16's range never meets the softmax; two empty
// partial softmaxes (m = -1e30, l = 0) merge to l = 0, not NaN.
#include <type_traits>

#include "mma.cuh"

namespace {

using ptt::Elt;
using ptt::NEG_INF;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GROUP = 8;     // query heads per kv head
constexpr int MAX_SPLITS = 64;   // blocks along T per (row, kv head)

// ------------------------------------------------------------- the merge
// What a block's streams leave in shared memory, and the merge's scratch.
template <int D, int G, int STREAMS>
struct Merge {
  float ms[STREAMS][G], ls[STREAMS][G], mb[G], lb[G];
  __align__(16) float as[STREAMS][G][D];
  float cx[MAX_SPLITS][G], lx[MAX_SPLITS][G];
  int last_in;
};

// After every stream has written its (m, l, acc) to sm and the block has
// synchronised: merge the streams in stream order; with one live split
// write the output, else this split's partial, and let the last live
// split to arrive merge all partials in split order.
template <typename T, int D, int G, int STREAMS>
__device__ void merge_and_store(Merge<D, G, STREAMS>& sm, T* out, float* work,
                                int* arrivals, int b, int h, int kv, int kvh,
                                int group, int split, int splits, int first,
                                int last) {
  const int tid = threadIdx.x;
  if (tid < group) {
    float mx = NEG_INF, lsum = 0.f;
    for (int s = 0; s < STREAMS; ++s) mx = fmaxf(mx, sm.ms[s][tid]);
    for (int s = 0; s < STREAMS; ++s) {
      const float c = expf(sm.ms[s][tid] - mx);
      sm.ms[s][tid] = c;
      lsum += sm.ls[s][tid] * c;
    }
    sm.mb[tid] = mx;
    sm.lb[tid] = lsum;
  }
  __syncthreads();
  const int live = last - first + 1;
  const int pair = b * kv + kvh;
  T* o_row = out + ((size_t)b * h + kvh * group) * D;
  // a split's partial: m [group], l [group], acc [group][D]
  const size_t span = (size_t)group * (D + 2);
  float* part = work + ((size_t)pair * splits + split) * span;
  for (int idx = tid; idx < group * D; idx += THREADS) {
    const int g = idx / D, dd = idx % D;
    float o = 0.f;
    for (int s = 0; s < STREAMS; ++s) o += sm.as[s][g][dd] * sm.ms[s][g];
    if (live == 1) {
      o_row[idx] = Elt<T>::from_float(o / fmaxf(sm.lb[g], 1e-30f));
    } else {
      if (dd == 0) {
        part[g] = sm.mb[g];
        part[group + g] = sm.lb[g];
      }
      part[2 * group + idx] = o;
    }
  }
  if (live == 1) return;

  if (!ptt::arrive_last(arrivals + pair, live, &sm.last_in)) return;
  // the live splits in split order: each thread's output elements of the
  // first CH splits and every split's m and l are loaded together; then
  // each head's factors and sum once, then the elements' sums, CH splits
  // at a time
  constexpr int PER = (G * D + THREADS - 1) / THREADS;  // elements a thread
  constexpr int CH = PER >= 4 ? 32 / PER : 8;           // splits a chunk
  const float* parts = work + ((size_t)pair * splits + first) * span;
  float a[CH][PER];
  auto load_chunk = [&](int s0) {
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = tid + k * THREADS;
        a[j][k] = s0 + j < live && idx < group * D
                      ? __ldcg(parts + (s0 + j) * span + 2 * group + idx)
                      : 0.f;
      }
  };
  load_chunk(0);
  for (int i = tid; i < live * group; i += THREADS) {
    const int s = i / group, g = i % group;
    sm.cx[s][g] = __ldcg(parts + s * span + g);
    sm.lx[s][g] = __ldcg(parts + s * span + group + g);
  }
  __syncthreads();
  if (tid < group) {
    float mx = NEG_INF, lsum = 0.f;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, sm.cx[s][tid]);
    for (int s = 0; s < live; ++s) {
      const float c = expf(sm.cx[s][tid] - mx);
      sm.cx[s][tid] = c;
      lsum += sm.lx[s][tid] * c;
    }
    sm.lb[tid] = lsum;
  }
  __syncthreads();
  float o[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) o[k] = 0.f;
  for (int s0 = 0;;) {
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int idx = tid + k * THREADS;
        if (s0 + j < live && idx < group * D)
          o[k] += a[j][k] * sm.cx[s0 + j][idx / D];
      }
    s0 += CH;
    if (s0 >= live) break;
    load_chunk(s0);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * THREADS;
    if (idx < group * D)
      o_row[idx] = Elt<T>::from_float(o[k] / fmaxf(sm.lb[idx / D], 1e-30f));
  }
  if (tid == 0) arrivals[pair] = 0;  // ready for the next launch
}

// Row b's cache index: from the device array when the caller passed one
// (clamped into the cache), else the host value.
__device__ inline int row_cache_index(const int* ci_dev, int stride, int b,
                                      int host, int tlen) {
  if (ci_dev == nullptr) return host;
  return min(max(ci_dev[(size_t)b * stride], 0), tlen - 1);
}

// The positions split `split` covers: [p0, p1), with the live splits
// first .. last; false when this split has none.
__device__ inline bool split_range(int cache_index, int window, int chunk,
                                   int split, int& first, int& last, int& p0,
                                   int& p1) {
  const int valid = cache_index + 1;
  const int lo = window > 0 ? max(0, valid - window) : 0;
  first = lo / chunk;
  last = (valid - 1) / chunk;
  if (split < first || split > last) return false;
  p0 = max(lo, split * chunk);
  p1 = min(valid, (split + 1) * chunk);
  return true;
}

// --------------------------------------------------------------- mma route
constexpr int TILE = 16;  // positions a warp stages and scores at once

template <int D>
struct MmaGeo {
  // a staged row: d elements and 16 bytes more, so that the 8 rows an
  // ldmatrix reads fall on distinct banks
  static constexpr int RS = D * 2 + 16;
  static constexpr int TILE_BYTES = TILE * RS;
  static constexpr int WARP_BYTES = 2 * 2 * TILE_BYTES;  // K, V x 2 stages
  static constexpr size_t SMEM = (size_t)WARPS * WARP_BYTES;
};

using ptt::cp_async16;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::ldmatrix_x4;
using ptt::ldmatrix_x4_trans;
using ptt::mma16816;

// Fragments (lane l, r = l / 4, c = l % 4): the m16n8 accumulator holds
// rows r and r + 8 at columns 2c and 2c + 1; the A operand of an m16k16
// step holds rows r and r + 8 at k 2c, 2c + 1 and 2c + 8, 2c + 9. Rows are
// query heads (r < group live; r + 8 never is), columns positions or dims.
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
    decode_mma_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, T* __restrict__ out,
                      float* __restrict__ work, int* __restrict__ arrivals,
                      int tlen, int h, int kv, int cache_index,
                      const int* __restrict__ ci_dev, int ci_stride,
                      float scale, int window, int chunk) {
  using Geo = MmaGeo<D>;
  constexpr int RS = Geo::RS;
  __shared__ Merge<D, G, WARPS> sm;
  extern __shared__ __align__(128) unsigned char stage_raw[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane / 4, c = lane % 4;
  const int ci = row_cache_index(ci_dev, ci_stride, b, cache_index, tlen);
  int first, last, p0, p1;
  if (!split_range(ci, window, chunk, split, first, last, p0, p1)) return;

  unsigned char* my = stage_raw + warp * Geo::WARP_BYTES;  // K0 V0 K1 V1
  const size_t rstride = (size_t)kv * D;
  const T* kb = kc + ((size_t)b * tlen * kv + kvh) * D;
  const T* vb = vc + ((size_t)b * tlen * kv + kvh) * D;
  // stage the tile of positions t0 .. t0 + 15 (rows at or past p1 are
  // zeros): 16 rows of d elements, 16 bytes a lane at a time
  auto stage = [&](int t0, int st) {
    unsigned char* kt = my + st * 2 * Geo::TILE_BYTES;
    unsigned char* vt = kt + Geo::TILE_BYTES;
    constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = lane; i < TILE * CHUNKS; i += 32) {
      const int row = i / CHUNKS, ch = i % CHUNKS;
      const int t = t0 + row;
      const bool ok = t < p1;
      const size_t at = (size_t)(ok ? t : p0) * rstride + ch * 8;
      cp_async16(kt + row * RS + ch * 16, kb + at, ok);
      cp_async16(vt + row * RS + ch * 16, vb + at, ok);
    }
  };

  // this warp's tiles start at p0 + 16 (warp + 4 i)
  int t0 = p0 + TILE * warp;
  if (t0 < p1) stage(t0, 0);
  cp_async_commit();

  // the group's queries as A fragments: a0 (row r, k 2c), a2 (k 2c + 8);
  // rows r + 8 are zeros
  uint32_t qa[D / 16][2];
  const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
      q + ((size_t)b * h + kvh * group + min(r, group - 1)) * D);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][0] = r < group ? qrow[8 * ks + c] : 0u;
    qa[ks][1] = r < group ? qrow[8 * ks + 4 + c] : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m = NEG_INF, l = 0.f;  // row r's running max and this lane's sum

  for (int st = 0; t0 < p1; t0 += TILE * WARPS, st ^= 1) {
    const int next = t0 + TILE * WARPS;
    if (next < p1) stage(next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* kt = my + st * 2 * Geo::TILE_BYTES;
    const unsigned char* vt = kt + Geo::TILE_BYTES;
    const int mi = lane / 8;  // the 8x8 matrix whose row this lane points at

    // S = Q K^T: 16 positions as two n8 blocks; K rows are positions
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int ks = 0; ks < D / 16; ks += 2) {
        // matrices: (k step ks, ks + 1) x (k half 0, 1)
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (8 * nb + lane % 8) * RS +
                            (16 * (ks + mi / 2) + 8 * (mi % 2)) * 2);
        const uint32_t a0[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        const uint32_t a1[4] = {qa[ks + 1][0], 0u, qa[ks + 1][1], 0u};
        mma16816<T>(s[nb], a0, kf);
        mma16816<T>(s[nb], a1, kf + 2);
      }

    // online softmax of row r over the tile's live positions
    float mx = m;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nb][e] *= scale;
        if (t0 + 8 * nb + 2 * c + e < p1) mx = fmaxf(mx, s[nb][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
    float p[2][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nb][e] = t0 + 8 * nb + 2 * c + e < p1 ? expf(s[nb][e] - mx) : 0.f;
        l += p[nb][e];
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
    // p through V's type before the PV product, as on the TPU: positions
    // 2c, 2c + 1 (n block 0) and 2c + 8, 2c + 9 (n block 1) of row r
    const uint32_t pa[4] = {ptt::pack2<T>(p[0][0], p[0][1]), 0u,
                            ptt::pack2<T>(p[1][0], p[1][1]), 0u};
    // O += P V: V as B (k = positions, n = dims) by ldmatrix.trans;
    // matrices (positions 0-7, 8-15) x (dims 8j, 8j + 8)
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vt + (8 * (mi % 2) + lane % 8) * RS +
                                (8 * (j + mi / 2)) * 2);
      mma16816<T>(o[j], pa, vf);
      mma16816<T>(o[j + 1], pa, vf + 2);
    }
    __syncwarp();  // this stage is restaged two tiles on
  }
  cp_async_wait<0>();

  // the warp's row r: its sum over the quad, into the block's merge
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (r < group) {
    if (c == 0) {
      sm.ms[warp][r] = m;
      sm.ls[warp][r] = l;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      sm.as[warp][r][8 * j + 2 * c] = o[j][0];
      sm.as[warp][r][8 * j + 2 * c + 1] = o[j][1];
    }
  }
  __syncthreads();
  merge_and_store<T, D, G, WARPS>(sm, out, work, arrivals, b, h, kv, kvh,
                                  group, split, gridDim.x, first, last);
}

// -------------------------------------------------------------- simt route
constexpr int U = 4;  // rows a stream loads before using any

template <int D>
struct SimtGeo {
  static constexpr int LPR = D / 4 < 32 ? D / 4 : 32;  // lanes a row
  static constexpr int EPL = D / LPR;                  // elements a lane
  static constexpr int RPW = 32 / LPR;                 // rows a warp
  static constexpr int W = EPL / 4;                    // 16-byte words
  static constexpr int STREAMS = WARPS * RPW;          // streams a block
};

template <int W>
__device__ inline void unpack4(const float4 (&w)[W], float* f) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    f[4 * i] = w[i].x;
    f[4 * i + 1] = w[i].y;
    f[4 * i + 2] = w[i].z;
    f[4 * i + 3] = w[i].w;
  }
}

// G: the most query heads per kv head this instance holds (2, 4 or 8).
template <int D, int G>
__global__ void __launch_bounds__(THREADS)
    decode_simt_kernel(const float* __restrict__ q,
                       const float* __restrict__ kc,
                       const float* __restrict__ vc, float* __restrict__ out,
                       float* __restrict__ work, int* __restrict__ arrivals,
                       int tlen, int h, int kv, int cache_index,
                       const int* __restrict__ ci_dev, int ci_stride,
                       float scale, int window, int chunk) {
  using Geo = SimtGeo<D>;
  constexpr int LPR = Geo::LPR, EPL = Geo::EPL, RPW = Geo::RPW, W = Geo::W;
  constexpr int STREAMS = Geo::STREAMS;
  __shared__ Merge<D, G, STREAMS> sm;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPR, sl = lane % LPR;
  const int stream = warp * RPW + sub;
  const int ci = row_cache_index(ci_dev, ci_stride, b, cache_index, tlen);
  int first, last, p0, p1;
  if (!split_range(ci, window, chunk, split, first, last, p0, p1)) return;

  // stream (warp, sub) takes positions base + u * RPW + sub, u < U, and
  // holds the next pass's rows in flight while it works on this pass's
  const size_t rstride = (size_t)kv * D;
  const float* kb = kc + ((size_t)b * tlen * kv + kvh) * D + sl * EPL;
  const float* vb = vc + ((size_t)b * tlen * kv + kvh) * D + sl * EPL;
  constexpr int PASS = WARPS * U * RPW;  // positions a block pass covers
  auto fetch = [&](int base, float4 (&kw)[U][W], float4 (&vw)[U][W]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * RPW + sub;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        kw[u][i] = vw[u][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < p1) {
          kw[u][i] = reinterpret_cast<const float4*>(kb + t * rstride)[i];
          vw[u][i] = reinterpret_cast<const float4*>(vb + t * rstride)[i];
        }
      }
    }
  };
  int base = p0 + warp * U * RPW;
  float4 kw[U][W], vw[U][W];
  fetch(base, kw, vw);

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = acc[g][e] = 0.f;
    if (g < group)
      ptt::load_floats<float, EPL>(
          q + ((size_t)b * h + kvh * group + g) * D + sl * EPL, qr[g]);
  }

  for (; base < p1; base += PASS) {
    float4 nk[U][W], nv[U][W];
    fetch(base + PASS, nk, nv);
    float sc[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack4<W>(kw[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= group) break;
        // every lane of the warp takes part in the sums over each row's
        // LPR lanes, whether its rows are live or not
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kf[e], part);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        sc[g][u] = part * scale;
      }
    }
    float pr[G][U];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * RPW + sub < p1) m_new = fmaxf(m_new, sc[g][u]);
      const float alpha = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pr[g][u] = base + u * RPW + sub < p1 ? expf(sc[g][u] - m_new) : 0.f;
        psum += pr[g][u];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      unpack4<W>(vw[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= group) break;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(pr[g][u], vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        kw[u][i] = nk[u][i];
        vw[u][i] = nv[u][i];
      }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= group) break;
    if (sl == 0) {
      sm.ms[stream][g] = m[g];
      sm.ls[stream][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm.as[stream][g][sl * EPL + e] = acc[g][e];
  }
  __syncthreads();
  merge_and_store<float, D, G, STREAMS>(sm, out, work, arrivals, b, h, kv,
                                        kvh, group, split, gridDim.x, first,
                                        last);
}

// ----------------------------------------------------------------- launch
struct Args {
  const void *q, *kc, *vc;
  void *out, *work, *arrivals;
  int b, tlen, h, kv, cache_index;
  const int* ci_dev;
  int ci_stride;
  float scale;
  int window, splits;
  cudaStream_t stream;
};

template <typename T, int D, int G>
int launch_mma(const Args& a) {
  const size_t smem = MmaGeo<D>::SMEM;
  auto kernel = decode_mma_kernel<T, D, G>;
  cudaError_t err = ptt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int chunk = (a.tlen + a.splits - 1) / a.splits;
  kernel<<<dim3(a.splits, a.kv, a.b), THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), static_cast<T*>(a.out),
      static_cast<float*>(a.work), static_cast<int*>(a.arrivals), a.tlen,
      a.h, a.kv, a.cache_index, a.ci_dev, a.ci_stride, a.scale, a.window,
      chunk);
  return cudaGetLastError();
}

template <int D, int G>
int launch_simt(const Args& a) {
  const int chunk = (a.tlen + a.splits - 1) / a.splits;
  decode_simt_kernel<D, G>
      <<<dim3(a.splits, a.kv, a.b), THREADS, 0, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.kc),
          static_cast<const float*>(a.vc), static_cast<float*>(a.out),
          static_cast<float*>(a.work), static_cast<int*>(a.arrivals), a.tlen,
          a.h, a.kv, a.cache_index, a.ci_dev, a.ci_stride, a.scale, a.window,
      chunk);
  return cudaGetLastError();
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(head dim, most heads per kv head) for the instance that takes d and
// the group h / kv (held as 2, 4 or 8)
template <typename F>
int by_shape(int d, int group, F&& f) {
  auto by_group = [&](auto dim) -> int {
    if (group <= 2) return f(dim, Int<2>{});
    if (group <= 4) return f(dim, Int<4>{});
    return f(dim, Int<8>{});
  };
  if (d == 64) return by_group(Int<64>{});
  if (d == 128) return by_group(Int<128>{});
  if (d == 256) return by_group(Int<256>{});
  return cudaErrorInvalidValue;
}

int checked(const Args& a, int d) {
  if (a.kv < 1 || a.h % a.kv != 0 || a.h / a.kv > MAX_GROUP ||
      (a.ci_dev == nullptr &&
       (a.cache_index < 0 || a.cache_index >= a.tlen)) ||
      (a.ci_dev != nullptr && a.ci_stride != 0 && a.ci_stride != 1) ||
      a.splits < 1 ||
      a.splits > MAX_SPLITS || a.splits > a.tlen ||
      (d != 64 && d != 128 && d != 256))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// The two routes: mma takes dtype 1 (bf16) or 2 (fp16), simt dtype 0
// (fp32). window <= 0 means none. cache_index_dev: null (take
// cache_index), or an int32 array on the device with one index (stride
// 0) or one a row (stride 1); cache_index is then unused. work: fp32
// [b, kv, splits, h / kv, d + 2] scratch; arrivals: int32 [b * kv], all
// 0 (the kernel leaves them 0 again). Both are unused when one split is
// live.
extern "C" int decode_attention_fwd_mma(const void* q, const void* k_cache,
                                        const void* v_cache, void* out,
                                        void* work, void* arrivals, int b,
                                        int tlen, int h, int kv, int d,
                                        int cache_index,
                                        const void* cache_index_dev,
                                        int cache_index_stride, float scale,
                                        int window, int splits, int dtype,
                                        void* stream) {
  const Args a{q, k_cache, v_cache, out, work, arrivals, b, tlen, h, kv,
               cache_index, static_cast<const int*>(cache_index_dev),
               cache_index_stride, scale, window, splits,
               static_cast<cudaStream_t>(stream)};
  if (const int rc = checked(a, d)) return rc;
  return ptt::by_half_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return by_shape(d, h / kv, [&](auto dim, auto grp) {
      return launch_mma<T, decltype(dim)::value, decltype(grp)::value>(a);
    });
  });
}

extern "C" int decode_attention_fwd_simt(const void* q, const void* k_cache,
                                         const void* v_cache, void* out,
                                         void* work, void* arrivals, int b,
                                         int tlen, int h, int kv, int d,
                                         int cache_index,
                                         const void* cache_index_dev,
                                         int cache_index_stride, float scale,
                                         int window, int splits, int dtype,
                                         void* stream) {
  const Args a{q, k_cache, v_cache, out, work, arrivals, b, tlen, h, kv,
               cache_index, static_cast<const int*>(cache_index_dev),
               cache_index_stride, scale, window, splits,
               static_cast<cudaStream_t>(stream)};
  if (const int rc = checked(a, d)) return rc;
  if (dtype != 0) return cudaErrorInvalidValue;
  return by_shape(d, h / kv, [&](auto dim, auto grp) {
    return launch_simt<decltype(dim)::value, decltype(grp)::value>(a);
  });
}
