// Chunked-prefill GQA attention on explicit positions, reading the keys
// from two sources: the prior KV cache and the chunk's own keys.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_prefill (body _prefill_kernel).
//
// What bounds it on an H100: operations.  Each live (query, key) pair
// costs 4·D flops (the score and its share of P·V); a 256-token chunk
// against a cache of ~1000 positions does ~300 flops per K/V byte, at the
// card's ridge, so only the tensor cores can approach the bound.
//
// Semantics, on both routes: key index j < Sc reads the cache
// (B, Hkv, Sc, D) and j >= Sc the chunk (B, Hkv, Sn, D), so the caller
// never concatenates cache and chunk (one cache-sized copy per layer per
// chunk); the mask is the reference's, q_pos >= k_pos >= 0 plus
// q_pos - k_pos < window (sliding) or the same q_pos // chunk (chunked);
// out = acc / max(l, 1e-30), so a query row with no live key comes out 0
// (the plain version gives mean(V); such rows are padding and both sides
// discard them); softmax statistics and accumulators in f32.
//
// Two routes by dtype:
//  * bfloat16 (serving): every product on the tensor cores, built from
//    tc_common.cuh (mma.sync m16n8k16 fed by ldmatrix, S and P in
//    registers, a one-pass online softmax in the log2 domain, a two-stage
//    cp.async ring, one barrier a tile, 16-byte epilogue stores).  What it
//    adds for prefill (section "bf16 on the tensor cores" below):
//      - the G query heads of a KV head share each K/V tile: a block holds
//        128 rows, HB heads (the largest of 8, 4, 2, 1 dividing G) x
//        128 / HB queries, a warp per 16 queries of one head, so a tile is
//        read once per HB heads;
//      - a tile's rows come from whichever source holds them, and hole
//        rows (k_pos < 0) and rows past Sc + Sn are zero-filled by
//        cp.async's src-size form instead of read;
//      - masks from positions: a query row's live keys are those whose
//        position lies in one interval [lo, q_pos] (lo = 0, q_pos - window
//        + 1 or the start of q_pos's chunk), computed once per row.  Each
//        key tile's min and max position and hole bits are taken once per
//        block; a (warp, tile) pair is "empty" (skipped), "full" (no
//        per-element test) or "partial" (three integer compares a score),
//        and a tile that no row of the block reaches is never loaded;
//      - blocks start heaviest first: batch rows by their last query's
//        position, query tiles from the last;
//  * float32 (the smoke configs, checks): f32 FMAs on the CUDA cores, one
//    block per (16 query rows, query head, batch row), a per-element mask
//    test; not redesigned.
//
// Plain C interface (loaded with ctypes): prefill_attention_launch returns
// cudaGetLastError() after the launch; prefill_attention_smem_bytes the
// dynamic shared memory the bf16 kernel takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "tc_common.cuh"

namespace {

constexpr int NT = 128;         // threads per block
constexpr int BQ = 16;          // query rows per block
constexpr int BK = 32;          // keys per tile (one per lane)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// kind: 0 causal, 1 sliding, 2 chunked
__device__ __forceinline__ bool live_pair(int qp, int kp, int kind, int window,
                                          int chunk) {
  bool m = (qp >= kp) && (kp >= 0);
  if (kind == 1) m = m && (qp - kp < window);
  else if (kind == 2) m = m && (floordiv(qp, chunk) == floordiv(kp, chunk));
  return m;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) prefill_kernel(
    const T* __restrict__ q,         // (B, Hq, Sq, D)
    const T* __restrict__ kc,        // (B, Hc, Sc, D)  prior cache, from the first head read
    const T* __restrict__ vc,
    const T* __restrict__ kn,        // (B, Hc, Sn, D)  chunk keys
    const T* __restrict__ vn,
    const int* __restrict__ q_pos,   // (B, Sq)
    const int* __restrict__ k_pos,   // (B, Sc + Sn)
    T* __restrict__ out,             // (B, Hq, Sq, D)
    int Hq, int Hkv, int Hc, int Sq, int Sc, int Sn, int kind, int window, int chunk,
    float scale) {
  constexpr int KP = D + (sizeof(T) == 2 ? 2 : 1);   // padded K row
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TILE_LOADS = BK * D / VEC;           // 16-byte loads per array
  constexpr int NLOAD = (TILE_LOADS + NT - 1) / NT;  // ... per thread
  constexpr int SGROUPS = NT / BK;                   // row groups, score phase
  constexpr int SROWS = BQ / SGROUPS;
  constexpr int CGROUPS = NT / D;                    // row groups, PV phase
  constexpr int CROWS = BQ / CGROUPS;
  static_assert(BK == 32 && NT % D == 0 && BQ % CGROUPS == 0 && D % VEC == 0,
                "tile shape");

  __shared__ float q_s[BQ][D];
  __shared__ T k_s[BK][KP];
  __shared__ T v_s[BK][D];
  __shared__ float p_s[BQ][BK];
  __shared__ int qp_s[BQ], kp_s[BK];
  __shared__ float m_s[BQ], l_s[BQ], c_s[BQ];

  const int i0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int hk = hq / G;
  const int Sk = Sc + Sn;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const T* qb = q + ((size_t)b * Hq + hq) * (size_t)Sq * D;
  const T* kcb = kc + ((size_t)b * Hc + hk) * (size_t)Sc * D;
  const T* vcb = vc + ((size_t)b * Hc + hk) * (size_t)Sc * D;
  const T* knb = kn + ((size_t)b * Hc + hk) * (size_t)Sn * D;
  const T* vnb = vn + ((size_t)b * Hc + hk) * (size_t)Sn * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int i = e / D;
    q_s[i][e % D] = i0 + i < Sq ? to_f(qb[(size_t)(i0 + i) * D + e % D]) * scale : 0.f;
  }
  if (tid < BQ) {
    // rows past Sq get position -1: never live against a key at k_pos >= 0
    qp_s[tid] = i0 + tid < Sq ? q_pos[(size_t)b * Sq + i0 + tid] : -1;
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int d = tid % D;
  const int cg = tid / D;
  float acc[CROWS];
#pragma unroll
  for (int r = 0; r < CROWS; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < Sk; j0 += BK) {
    __syncthreads();  // previous tile consumed; q_s/qp_s visible
    if (tid < BK) kp_s[tid] = j0 + tid < Sk ? k_pos[(size_t)b * Sk + j0 + tid] : -1;
    __syncthreads();
    bool any = false;
    for (int e = tid; e < BQ * BK; e += NT)
      any |= live_pair(qp_s[e / BK], kp_s[e % BK], kind, window, chunk);
    if (!__syncthreads_or(any)) continue;   // no live pair: skip the tile

    // stage K/V from whichever source holds key j0 + j; holes zero-filled.
    // Every load of the tile is issued before the first store.
    uint4 kr[NLOAD], vr[NLOAD];
#pragma unroll
    for (int u = 0; u < NLOAD; ++u) {
      const int e = tid + u * NT, j = (e * VEC) / D, d0 = (e * VEC) % D;
      const int key = j0 + j;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (e < TILE_LOADS && key < Sk && kp_s[j] >= 0) {
        const T* ks = key < Sc ? kcb + (size_t)key * D : knb + (size_t)(key - Sc) * D;
        const T* vs = key < Sc ? vcb + (size_t)key * D : vnb + (size_t)(key - Sc) * D;
        kr[u] = *reinterpret_cast<const uint4*>(ks + d0);
        vr[u] = *reinterpret_cast<const uint4*>(vs + d0);
      }
    }
#pragma unroll
    for (int u = 0; u < NLOAD; ++u) {
      const int e = tid + u * NT, j = (e * VEC) / D, d0 = (e * VEC) % D;
      if (e < TILE_LOADS) {
        const T* kt = reinterpret_cast<const T*>(&kr[u]);
        const T* vt = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
        for (int w = 0; w < VEC; ++w) {
          k_s[j][d0 + w] = kt[w];
          v_s[j][d0 + w] = vt[w];
        }
      }
    }
    __syncthreads();

    // scores: lane owns key j, warp owns rows i = warp + r * SGROUPS
    {
      const int j = lane;
      float s[SROWS];
#pragma unroll
      for (int r = 0; r < SROWS; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float kd = to_f(k_s[j][dd]);
#pragma unroll
        for (int r = 0; r < SROWS; ++r) s[r] += q_s[warp + r * SGROUPS][dd] * kd;
      }
      const int kp = kp_s[j];
#pragma unroll
      for (int r = 0; r < SROWS; ++r) {
        const int i = warp + r * SGROUPS;
        p_s[i][j] = live_pair(qp_s[i], kp, kind, window, chunk) ? s[r] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per row, one key per lane
    for (int i = warp; i < BQ; i += NT / 32) {
      const float x = p_s[i][lane];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = expf(x - m_new);
      p_s[i][lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        c_s[i] = c;
        l_s[i] = l_s[i] * c + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v; keys outer, rows inner: CROWS independent
    // accumulator chains instead of one long one per row
#pragma unroll
    for (int r = 0; r < CROWS; ++r) acc[r] *= c_s[cg + r * CGROUPS];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float vj = to_f(v_s[j][d]);
#pragma unroll
      for (int r = 0; r < CROWS; ++r) acc[r] += p_s[cg + r * CGROUPS][j] * vj;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < CROWS; ++r) {
    const int i = cg + r * CGROUPS;
    if (i0 + i < Sq) {
      out[(((size_t)b * Hq + hq) * Sq + i0 + i) * D + d] =
          from_f<T>(acc[r] / fmaxf(l_s[i], 1e-30f));
    }
  }
}

template <typename T>
void launch_t(const void* q, const void* kc, const void* vc, const void* kn,
              const void* vn, const void* q_pos, const void* k_pos, void* out,
              int B, int Hq, int Hkv, int Hc, int Sq, int Sc, int Sn, int D, int kind,
              int window, int chunk, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const T* q_ = static_cast<const T*>(q);
  const T* kc_ = static_cast<const T*>(kc);
  const T* vc_ = static_cast<const T*>(vc);
  const T* kn_ = static_cast<const T*>(kn);
  const T* vn_ = static_cast<const T*>(vn);
  const int* qp_ = static_cast<const int*>(q_pos);
  const int* kp_ = static_cast<const int*>(k_pos);
  T* o_ = static_cast<T*>(out);
#define REPRO_PREFILL_LAUNCH(DD)                                              \
  prefill_kernel<T, DD><<<grid, NT, 0, stream>>>(q_, kc_, vc_, kn_, vn_, qp_, \
                                                 kp_, o_, Hq, Hkv, Hc, Sq, Sc, Sn, \
                                                 kind, window, chunk, scale)
  switch (D) {
    case 16: REPRO_PREFILL_LAUNCH(16); break;
    case 32: REPRO_PREFILL_LAUNCH(32); break;
    case 64: REPRO_PREFILL_LAUNCH(64); break;
    case 128: REPRO_PREFILL_LAUNCH(128); break;
  }
#undef REPRO_PREFILL_LAUNCH
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
//
// A block holds 128 query rows: HB query heads of one KV head x QB = 128 /
// HB chunk queries, a warp per 16 queries of one head.  The block first
// reads every key position of its batch row once and keeps, per 64-key
// tile, the min and max of its non-hole positions and one bit per key
// (k_pos >= 0 and inside Sc + Sn); it then lists, in order, the tiles that
// some row of the block can reach, and streams only those through the ring.
//
// A query row with position qp reaches exactly the keys whose position kp
// lies in [lo, qp]: lo = 0 (causal), max(0, qp - window + 1) (sliding) or
// max(0, floor(qp / chunk) chunk) (chunked).  lo >= 0 excludes the holes,
// and a row with lo > qp (qp < 0, a window <= 0, or a row past Sq, given
// lo = INT_MAX and hi = -1) reaches nothing.  Per warp and tile:
//  * empty — the tile's min position is past every row's hi, or its max
//    before every row's lo (a tile with no valid key has min INT_MAX and
//    max -1): the warp skips the tile's products;
//  * full — every key valid, and min >= the largest lo and max <= the
//    smallest hi of the warp's rows: every pair is live, no test;
//  * otherwise partial: the exact test lo <= kp <= hi and key < Sc + Sn on
//    each score, kp read from the tile's positions in shared memory.
// Only a provable verdict is empty or full; anything else takes the exact
// test, whatever order the positions are in (a ring cache wraps).

constexpr float LOG2E = 1.4426950408889634f;
constexpr int T_ROWS = 128;    // query rows a block
constexpr int T_NT = 256;      // a warp per 16 rows
constexpr int T_BK = 64;       // keys a tile
constexpr int T_ST = 2;        // ring depth
constexpr size_t SMEM_MAX = 232448;   // 227 KB: the most one block may use

// Dynamic shared memory of the bf16 kernel: the block's Q rows, the K/V
// ring, each stage's key positions, the warps' position extremes and the
// list length, then five ints a key tile (min, max, two words of valid
// bits, the list of reachable tiles).
template <int D>
struct PfSmem {
  static constexpr int RB = TcRow<D>::RB;
  static constexpr size_t kv_off = (size_t)T_ROWS * RB;
  static constexpr size_t kp_off = kv_off + (size_t)T_ST * 2 * T_BK * RB;
  static constexpr size_t blk_off = kp_off + (size_t)T_ST * T_BK * 4;
  static constexpr size_t tiles_off = blk_off + 20 * 4;
  static constexpr size_t bytes(int n_tiles) { return tiles_off + (size_t)n_tiles * 5 * 4; }
};

// the live key positions [lo, hi] of a query row at position qp
__device__ __forceinline__ void row_interval(bool in, int qp, int kind, int window,
                                             int chunk, int& lo, int& hi) {
  long long l = 0;
  if (kind == 1) l = (long long)qp - window + 1;
  else if (kind == 2) l = (long long)floordiv(qp, chunk) * chunk;
  l = l < 0 ? 0 : l;
  if (!in || qp < 0 || l > qp) {
    lo = INT_MAX;
    hi = -1;
  } else {
    lo = (int)l;
    hi = qp;
  }
}

// The batch row this block works on: with B <= 32, rows in descending order
// of their last query's position (ties by index), so the rows with the most
// keys start first; otherwise blockIdx.z.
__device__ __forceinline__ int batch_row(const int* __restrict__ q_pos, int B, int Sq) {
  if (B > 32) return blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int v = lane < B ? q_pos[(size_t)lane * Sq + Sq - 1] : INT_MIN;
  int rank = 0;
  for (int u = 0; u < B; ++u) {
    const int w = __shfl_sync(0xffffffffu, v, u);
    rank += (w > v) || (w == v && u < lane);
  }
  const unsigned hit = __ballot_sync(0xffffffffu, lane < B && rank == (int)blockIdx.z);
  return __ffs(hit) - 1;
}

template <int D>
__global__ void __launch_bounds__(T_NT, 2) prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kc, const bf16* __restrict__ vc,
    const bf16* __restrict__ kn, const bf16* __restrict__ vn,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos, bf16* __restrict__ out,
    int B, int Hq, int Hkv, int Hc, int HB, int Sq, int Sc, int Sn, int kind, int window,
    int chunk, float scale) {
  using L = PfSmem<D>;
  constexpr int RB = L::RB, BK = T_BK, ST = T_ST, NB = BK / 8, NT = T_NT, PER_ROW = D / 8;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_addr = smem_addr(smem);
  const uint32_t kv_addr = q_addr + (uint32_t)L::kv_off;   // stage s: K, then V, of BK rows
  const uint32_t kp_addr = q_addr + (uint32_t)L::kp_off;
  const int* kp_s = reinterpret_cast<const int*>(smem + L::kp_off);
  int* blk_s = reinterpret_cast<int*>(smem + L::blk_off);
  const int Sk = Sc + Sn, n_tiles = (Sk + BK - 1) / BK;
  int* t_min = reinterpret_cast<int*>(smem + L::tiles_off);
  int* t_max = t_min + n_tiles;
  unsigned* t_lo = reinterpret_cast<unsigned*>(t_max + n_tiles);
  unsigned* t_hi = t_lo + n_tiles;
  int* list = reinterpret_cast<int*>(t_hi + n_tiles);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;

  const int b = batch_row(q_pos, B, Sq);
  const int G = Hq / Hkv, wph = 8 / HB, QB = 16 * wph;   // warps a head, queries a block
  const int hk = blockIdx.y / (G / HB);
  const int hq0 = hk * G + (blockIdx.y % (G / HB)) * HB;
  const int hq = hq0 + warp / wph;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * QB;
  const int iw = i0 + (warp % wph) * 16;                  // this warp's first query
  const bf16* kcb = kc + ((size_t)b * Hc + hk) * (size_t)Sc * D;
  const bf16* vcb = vc + ((size_t)b * Hc + hk) * (size_t)Sc * D;
  const bf16* knb = kn + ((size_t)b * Hc + hk) * (size_t)Sn * D;
  const bf16* vnb = vn + ((size_t)b * Hc + hk) * (size_t)Sn * D;
  const int* kpb = k_pos + (size_t)b * Sk;

  // the block's Q rows: row r belongs to warp r / 16
  for (int e = tid; e < T_ROWS * PER_ROW; e += NT) {
    const int r = e / PER_ROW, c = e % PER_ROW, wr = r >> 4;
    const int h = hq0 + wr / wph, i = i0 + (wr % wph) * 16 + (r & 15);
    const bool in = i < Sq;
    cp_async16(q_addr + r * RB + c * 16,
               q + (((size_t)b * Hq + h) * Sq + (in ? i : 0)) * D + c * 8, in);
  }
  cp_async_commit();

  // the lane's rows g and g + 8, and the warp's extremes of lo and hi
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + g + 8 * r;
    row_interval(i < Sq, i < Sq ? q_pos[(size_t)b * Sq + i] : -1, kind, window, chunk,
                 lo[r], hi[r]);
  }
  const int lo_min = __reduce_min_sync(FULL, min(lo[0], lo[1]));
  const int lo_max = __reduce_max_sync(FULL, max(lo[0], lo[1]));
  const int hi_min = __reduce_min_sync(FULL, min(hi[0], hi[1]));
  const int hi_max = __reduce_max_sync(FULL, max(hi[0], hi[1]));
  if (lane == 0) {
    blk_s[warp] = lo_min;
    blk_s[8 + warp] = hi_max;
  }

  // every key tile's valid bits and position range, a warp per tile
  for (int t = warp; t < n_tiles; t += NT / 32) {
    int mn = INT_MAX, mx = -1;
    unsigned bits[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = t * BK + 32 * h + lane;
      const int kp = key < Sk ? kpb[key] : -1;
      bits[h] = __ballot_sync(FULL, kp >= 0);
      if (kp >= 0) {
        mn = min(mn, kp);
        mx = max(mx, kp);
      }
    }
    mn = __reduce_min_sync(FULL, mn);
    mx = __reduce_max_sync(FULL, mx);
    if (lane == 0) {
      t_min[t] = mn;
      t_max[t] = mx;
      t_lo[t] = bits[0];
      t_hi[t] = bits[1];
    }
  }
  __syncthreads();
  // warp 0 lists, in order, the tiles some row of the block reaches
  if (warp == 0) {
    int b_lo = INT_MAX, b_hi = -1;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      b_lo = min(b_lo, blk_s[w]);
      b_hi = max(b_hi, blk_s[8 + w]);
    }
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool reach = t < n_tiles && t_max[t] >= b_lo && t_min[t] <= b_hi;
      const unsigned bal = __ballot_sync(FULL, reach);
      if (reach) list[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    if (lane == 0) blk_s[16] = n;
  }
  __syncthreads();
  const int n_list = blk_s[16];

  // list entry t goes to stage t % ST: K and V rows from their source, hole
  // rows and rows past Sk zero-filled, and the tile's key positions (keys
  // past Sk read as 0 and are masked by index)
  auto load_kv = [&](int t) {
    const int tl = list[t], j0 = tl * BK, s = t % ST;
    const unsigned bits_lo = t_lo[tl], bits_hi = t_hi[tl];
    const uint32_t st = kv_addr + s * 2 * BK * RB;
    constexpr int N = BK * PER_ROW;
#pragma unroll
    for (int u = 0; u < (N + NT - 1) / NT; ++u) {
      const int e = tid + u * NT;
      if (N % NT == 0 || e < N) {
        const int r = e / PER_ROW, c = e % PER_ROW, key = j0 + r;
        const bool ok = ((r < 32 ? bits_lo >> r : bits_hi >> (r - 32)) & 1u) != 0;
        const bf16* ks = q;
        const bf16* vs = q;
        if (ok) {
          const size_t off = (size_t)(key < Sc ? key : key - Sc) * D + c * 8;
          ks = (key < Sc ? kcb : knb) + off;
          vs = (key < Sc ? vcb : vnb) + off;
        }
        cp_async16(st + r * RB + c * 16, ks, ok);
        cp_async16(st + (BK + r) * RB + c * 16, vs, ok);
      }
    }
    if (tid < BK) {
      const bool in = j0 + tid < Sk;
      cp_async4(kp_addr + (s * BK + tid) * 4, kpb + (in ? j0 + tid : 0), in);
    }
  };
  if (n_list > 0) load_kv(0);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float c = scale * LOG2E;

  for (int t = 0; t < n_list; ++t) {
    // tile t has landed, and every warp is done with tile t - 1, whose stage
    // now takes tile t + 1 while this one is multiplied
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_list) load_kv(t + 1);
    cp_async_commit();
    const int tl = list[t], j0 = tl * BK;
    const int k_min = t_min[tl], k_max = t_max[tl];
    if (k_min > hi_max || k_max < lo_min) continue;          // empty for this warp
    const bool full =
        (t_lo[tl] & t_hi[tl]) == FULL && k_min >= lo_max && k_max <= hi_min;
    const uint32_t st = kv_addr + (t % ST) * 2 * BK * RB;
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    mma_abt<D, NB>(s, q_addr + warp * 16 * RB, st);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= c;
    }
    if (!full) {
      const int* kps = kp_s + (t % ST) * BK;
      const int k_end = Sk - j0;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int col = nb * 8 + 2 * tq;
        const int2 kp2 = *reinterpret_cast<const int2*>(kps + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = (e & 1) ? kp2.y : kp2.x, r = e >> 1;
          if (col + (e & 1) >= k_end || kp < lo[r] || kp > hi[r]) s[nb][e] = NEG_INF;
        }
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    }
    // a masked score gets p = exp2(NEG_INF - m) = 0 exactly; a row with no
    // live key yet subtracts 0, so its p are 0 and l stays 0
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_use[r] = m_new == NEG_INF ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m_use[e >> 1]);
        s[nb][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
    }
    uint32_t pa[NB / 2][4];
    pack_a<NB>(pa, s);
    mma_pm<D, NB / 2>(o, pa, st + BK * RB);
  }
  cp_async_wait<0>();
  __syncthreads();             // Q has landed even when no tile ran

  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) f[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  store_rows<D>(out + ((size_t)b * Hq + hq) * Sq * D, o, f, q_s + warp * 16 * TcRow<D>::LD,
                iw, Sq);
}

// query heads a bf16 block holds: the largest of 8, 4, 2, 1 that divides G
int heads_per_block(int G) {
  int hb = 8;
  while (G % hb) hb >>= 1;
  return hb;
}

template <int D>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc, const void* kn,
                       const void* vn, const void* q_pos, const void* k_pos, void* out,
                       int B, int Hq, int Hkv, int Hc, int Sq, int Sc, int Sn, int kind,
                       int window, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = PfSmem<D>::bytes((Sc + Sn + T_BK - 1) / T_BK);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;   // too many key tiles to list
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int hb = heads_per_block(Hq / Hkv), qb = T_ROWS / hb;
  prefill_mma_kernel<D><<<dim3((Sq + qb - 1) / qb, Hq / hb, B), T_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<const bf16*>(kn), static_cast<const bf16*>(vn),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<bf16*>(out),
      B, Hq, Hkv, Hc, hb, Sq, Sc, Sn, kind, window, chunk, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* kc, const void* vc, const void* kn,
                        const void* vn, const void* q_pos, const void* k_pos, void* out,
                        int B, int Hq, int Hkv, int Hc, int Sq, int Sc, int Sn, int D,
                        int kind, int window, int chunk, float scale, cudaStream_t stream) {
  switch (D) {
#define REPRO_PREFILL_MMA(DD)                                                            \
  case DD:                                                                             \
    return launch_mma<DD>(q, kc, vc, kn, vn, q_pos, k_pos, out, B, Hq, Hkv, Hc, Sq, Sc,  \
                          Sn, kind, window, chunk, scale, stream);
    REPRO_PREFILL_MMA(16)
    REPRO_PREFILL_MMA(32)
    REPRO_PREFILL_MMA(64)
    REPRO_PREFILL_MMA(128)
#undef REPRO_PREFILL_MMA
  }
  return cudaErrorInvalidValue;
}

size_t smem_bytes(int D, int Sk) {
  const int n_tiles = (Sk + T_BK - 1) / T_BK;
  switch (D) {
    case 16: return PfSmem<16>::bytes(n_tiles);
    case 32: return PfSmem<32>::bytes(n_tiles);
    case 64: return PfSmem<64>::bytes(n_tiles);
    case 128: return PfSmem<128>::bytes(n_tiles);
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; kind: 0 causal, 1 sliding, 2 chunked.
// kc/vc/kn/vn point at the first KV head read of row 0; a row of each
// source holds Hc >= Hkv heads (Hc > Hkv: the kernel reads Hkv of them in
// place, a head slice of a cache whose heads are replicated over a model
// axis).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int prefill_attention_launch(const void* q, const void* kc, const void* vc,
                             const void* kn, const void* vn, const void* q_pos,
                             const void* k_pos, void* out, int B, int Hq,
                             int Hkv, int Hc, int Sq, int Sc, int Sn, int D, int dtype,
                             int kind, int window, int chunk, float scale,
                             void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hc < Hkv || Sq <= 0 || Sc < 0 || Sn < 0 ||
      Sc + Sn <= 0 || (D != 16 && D != 32 && D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || kind < 0 || kind > 2 ||
      (kind == 2 && chunk <= 0) || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_bf16(q, kc, vc, kn, vn, q_pos, k_pos, out, B, Hq, Hkv, Hc, Sq, Sc, Sn,
                            D, kind, window, chunk, scale, s);
  launch_t<float>(q, kc, vc, kn, vn, q_pos, k_pos, out, B, Hq, Hkv, Hc, Sq, Sc, Sn, D, kind,
                  window, chunk, scale, s);
  return (int)cudaGetLastError();
}

// The dynamic shared memory the bf16 kernel launches with for head dim D
// and Sk = Sc + Sn keys (more than 227 KB: the launch is refused); 0 for a
// head dim it does not take.
int prefill_attention_smem_bytes(int D, int Sk) { return (int)smem_bytes(D, Sk); }

const char* prefill_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
