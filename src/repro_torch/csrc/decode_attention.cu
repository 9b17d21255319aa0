// Single-token GQA decode attention against a padded KV cache.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:
// flash_decode (body _decode_kernel).
//
// What bounds it on an H100: bytes.  Each (batch row, KV head) reads
// lengths[b] keys and values of D elements once and does 4·G·D flops per
// key, about G flops per byte in bf16 — far below the ~295 flops/byte at
// which the tensor cores would become the limit.  The only lever is to
// read the live part of the cache once, with many loads in flight on
// every SM, and to add as little fixed cost per call as possible.
//
// What the design does about it:
//  * B·Hkv alone is too few blocks for 132 SMs (32 at yi-6b with 8 slots),
//    so the live keys of each (row, KV head) are split over NS blocks, grid
//    NS x Hkv x B.  The host picks NS from B·Hkv and the SM count
//    (kernels/decode_attention.py: num_splits); each block cuts its row's
//    own live length into NS near-equal runs of whole key tiles
//    (split_tiles), so short rows do not leave blocks idle on long ones;
//  * the NS blocks of a (row, KV head) form one thread-block cluster
//    (NS <= 8, the portable cluster size).  Each block leaves its partial
//    (m, l, acc) in its own shared memory; after a cluster barrier every
//    block combines a slice of the G x D outputs, each thread loading its
//    element's NS partials from its peers through distributed shared
//    memory at once and summing them in split order, so the
//    combine needs no second launch, no scratch in device memory, no
//    counters and no atomics: reruns are bit-identical, and nothing
//    persists between calls, so a CUDA graph can replay it;
//  * bfloat16 (serving): both products on the tensor cores, built from
//    tc_common.cuh.  The G query rows of the KV head (padded to 16 with
//    zero rows) are the A operand of S = Q·Kᵀ; each of the 4 warps takes 16
//    keys of a 64-key tile, runs the online softmax on its own rows in
//    registers (log2 domain), repacks P into the A operand of P·V and keeps
//    its own (m, l, acc), merged with the other warps' in shared memory
//    before the cluster combine.  K/V tiles stream through a 2-stage
//    cp.async ring: the next tile's loads are in flight while one is
//    multiplied, and a block takes 74 KB at D = 128, so three blocks fit an
//    SM and all the clusters of the serving shape (32 of 8 blocks) are
//    resident at once — with a third stage (109 KB) a GPC holds fewer
//    clusters and some wait for a second wave.  Keys at or past the length
//    are zero-filled, never read, and masked;
//  * float32 (smoke parity only): f32 FMAs on the CUDA cores, 32-key tiles
//    staged through registers into shared memory, the same split and the
//    same cluster combine;
//  * m, l and acc stay in f32; out = acc / max(l, 1e-30), so a row of
//    length 0 comes out 0, as the Pallas kernel's does.
//
// Plain C interface (loaded with ctypes): decode_attention_launch runs the
// one kernel and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 128;         // threads per block
constexpr int MAXG = 16;        // largest query-group size G supported
constexpr int MAX_SPLITS = 8;   // blocks per (row, KV head): one cluster
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Tile {
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;   // keys per tile
};

__device__ __forceinline__ float to_f(float x) { return x; }

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

// Key tiles [t_lo, t_hi) of split s of ns over a row of L live keys: the
// row's ceil(L / bk) tiles cut into ns near-equal runs (some may be empty).
// kernels/decode_attention.py: split_ranges mirrors this.
__device__ __forceinline__ void split_tiles(int L, int bk, int s, int ns, int& t_lo,
                                            int& t_hi) {
  const int nt = (L + bk - 1) / bk;
  t_lo = (int)((long long)s * nt / ns);
  t_hi = (int)((long long)(s + 1) * nt / ns);
}

// The cluster's NS blocks each hold one partial of up to MAXG rows: acc
// at po[g D + d], m (log2 domain) at pm[g], l at pl[g].  Block `rank`
// writes outputs rank·NT + tid, stepping by NS·NT, of the G x D rows at
// out: each thread loads its element's NS partials from the peers' shared
// memory at once, then sums them in split order.
template <typename T, int D>
__device__ __forceinline__ void cluster_combine(const float* po, const float* pm,
                                                const float* pl, T* __restrict__ out,
                                                int G) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's partial is in its shared memory
  const int ns = gridDim.x, rank = blockIdx.x;   // the cluster spans grid x
  for (int e = rank * NT + threadIdx.x; e < G * D; e += ns * NT) {
    const int g = e / D;
    float ms[MAX_SPLITS], ls[MAX_SPLITS], as[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < ns) {
        ms[s] = cluster.map_shared_rank(pm, s)[g];
        ls[s] = cluster.map_shared_rank(pl, s)[g];
        as[s] = cluster.map_shared_rank(po, s)[e];
      }
    }
    float m = NEG_INF, l = 0.f, a = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < ns) m = fmaxf(m, ms[s]);
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < ns) {
        const float f = exp2f(ms[s] - m);
        l += f * ls[s];
        a += f * as[s];
      }
    }
    out[e] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();   // no block leaves while a peer may still read it
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

// One tile's 16-byte loads for this thread, all issued before any is used.
template <typename T, int D, int LOADS>
__device__ __forceinline__ void fetch_tile(uint4 (&kr)[LOADS], uint4 (&vr)[LOADS],
                                           const T* kb, const T* vb, int j0,
                                           int L, int tid) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = tid + u * NT, j = (e * VEC) / D, d0 = (e * VEC) % D;
    kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
    if (j0 + j < L) {
      kr[u] = *reinterpret_cast<const uint4*>(kb + (size_t)(j0 + j) * D + d0);
      vr[u] = *reinterpret_cast<const uint4*>(vb + (size_t)(j0 + j) * D + d0);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_fma_kernel(
    const T* __restrict__ q,          // (B, Hq, D)
    const T* __restrict__ k,          // (B, Hc, Smax, D), from the first head read
    const T* __restrict__ v,          // (B, Hc, Smax, D)
    const int* __restrict__ lengths,  // (B,)
    T* __restrict__ out,              // (B, Hq, D)
    int Hq, int Hkv, int Hc, int Smax, float scale) {
  constexpr int BK = Tile<T>::BK;
  constexpr int KP = D + (sizeof(T) == 2 ? 2 : 1);   // padded K row: no bank conflicts
  constexpr int VEC = 16 / sizeof(T);                // elements per 16-byte load
  constexpr int LOADS = BK * D / VEC / NT;           // loads per thread per array
  constexpr int SGROUPS = NT / BK;                   // row groups, score phase
  constexpr int CGROUPS = NT / D;                    // row groups, PV phase
  constexpr int SROWS = (MAXG + SGROUPS - 1) / SGROUPS;
  constexpr int CROWS = (MAXG + CGROUPS - 1) / CGROUPS;
  static_assert(NT % BK == 0 && NT % D == 0 && (BK * D / VEC) % NT == 0,
                "tile shape");

  __shared__ float q_s[MAXG][D];     // the scaled queries; then this block's acc
  __shared__ T k_s[BK][KP];
  __shared__ T v_s[BK][D];
  __shared__ float p_s[MAXG][BK];
  __shared__ float m_s[MAXG], l_s[MAXG], c_s[MAXG];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int L = min(max(lengths[b], 0), Smax);
  int t_lo, t_hi;
  split_tiles(L, BK, s, gridDim.x, t_lo, t_hi);

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  const T* kb = k + ((size_t)b * Hc + h) * (size_t)Smax * D;
  const T* vb = v + ((size_t)b * Hc + h) * (size_t)Smax * D;

  for (int e = tid; e < G * D; e += NT) q_s[e / D][e % D] = to_f(qb[e]) * scale;
  if (tid < MAXG) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int d = tid % D;             // PV phase: this thread's column ...
  const int cg_ = tid / D;           // ... and row group
  float acc[CROWS];
#pragma unroll
  for (int r = 0; r < CROWS; ++r) acc[r] = 0.f;

  // registers holding the next tile; keys at or past L are zeros, never read
  uint4 kr[LOADS], vr[LOADS];
  if (t_lo < t_hi) fetch_tile<T, D, LOADS>(kr, vr, kb, vb, t_lo * BK, L, tid);
  __syncthreads();

  for (int t = t_lo; t < t_hi; ++t) {
    const int j0 = t * BK;
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = tid + u * NT, j = (e * VEC) / D, d0 = (e * VEC) % D;
      const T* kt = reinterpret_cast<const T*>(&kr[u]);
      const T* vt = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int w = 0; w < VEC; ++w) {
        k_s[j][d0 + w] = kt[w];
        v_s[j][d0 + w] = vt[w];
      }
    }
    __syncthreads();
    // the next tile's loads are in flight while this one is computed
    if (t + 1 < t_hi) fetch_tile<T, D, LOADS>(kr, vr, kb, vb, j0 + BK, L, tid);

    // scores: thread owns key j for rows g = sg, sg + SGROUPS, ...
    {
      const int j = tid % BK, sg = tid / BK;
      float sc[SROWS];
#pragma unroll
      for (int r = 0; r < SROWS; ++r) sc[r] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float kd = to_f(k_s[j][dd]);
#pragma unroll
        for (int r = 0; r < SROWS; ++r) {
          const int g = sg + r * SGROUPS;
          if (g < G) sc[r] += q_s[g][dd] * kd;
        }
      }
      const bool live = j0 + j < L;
#pragma unroll
      for (int r = 0; r < SROWS; ++r) {
        const int g = sg + r * SGROUPS;
        if (g < G) p_s[g][j] = live ? sc[r] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int g = warp; g < G; g += NT / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, p_s[g][j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(p_s[g][j] - m_new);
        p_s[g][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        c_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v; keys outer, rows inner: CROWS independent
    // accumulator chains instead of one long one per row
#pragma unroll
    for (int r = 0; r < CROWS; ++r) {
      const int g = cg_ + r * CGROUPS;
      if (g < G) acc[r] *= c_s[g];
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float vj = to_f(v_s[j][d]);
#pragma unroll
      for (int r = 0; r < CROWS; ++r) {
        const int g = cg_ + r * CGROUPS;
        if (g < G) acc[r] += p_s[g][j] * vj;
      }
    }
    __syncthreads();
  }

  // this block's partial over q_s; an empty split leaves m = NEG_INF,
  // l = acc = 0.  m moves to the log2 domain of the combine.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < CROWS; ++r) {
    const int g = cg_ + r * CGROUPS;
    if (g < G) q_s[g][d] = acc[r];
  }
  if (tid < MAXG) m_s[tid] *= LOG2E;
  cluster_combine<T, D>(&q_s[0][0], m_s, l_s,
                              out + ((size_t)b * Hq + (size_t)h * G) * D, G);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int ST = 2;           // ring depth (tiles in flight)

// Dynamic shared memory of the bf16 kernel: 16 padded Q rows, then the
// ring of ST stages, each a tile's K rows and V rows.  Once every tile is
// done the four warps' partials, and then the block's, are written over
// the ring.
template <int D>
struct DecSmem {
  static constexpr int RB = TcRow<D>::RB;
  static constexpr int BK = Tile<bf16>::BK;
  static constexpr int kv_off = 16 * RB;
  static constexpr int bytes = kv_off + ST * 2 * BK * RB;
  static constexpr int LDO = D + 4;                  // a partial's acc row, floats
  static constexpr int po_off = kv_off;
  static constexpr int pm_off = po_off + 4 * MAXG * LDO * 4;
  static constexpr int pl_off = pm_off + 4 * MAXG * 4;
  static constexpr int bo_off = pl_off + 4 * MAXG * 4;   // the block's: acc [MAXG][D],
  static constexpr int bm_off = bo_off + MAXG * D * 4;   // m and l
  static constexpr int bl_off = bm_off + MAXG * 4;
  static_assert(bl_off + MAXG * 4 <= bytes, "the partials fit over the ring");
};

template <int D>
__global__ void __launch_bounds__(NT) decode_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, bf16* __restrict__ out, int Hq, int Hkv, int Hc,
    int Smax, float scale) {
  using S = DecSmem<D>;
  constexpr int RB = S::RB, BK = S::BK, NB = 2;      // a warp: 16 keys, two n-blocks
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_addr = smem_addr(smem);
  const uint32_t kv_addr = q_addr + S::kv_off;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  // the G query rows, rows G..15 zero: the A operand of every score tile
  load_rows_async<D, 16, NT>(q_addr, q + ((size_t)b * Hq + (size_t)h * G) * D, 0, G);
  const int L = min(max(lengths[b], 0), Smax);
  int t_lo, t_hi;
  split_tiles(L, BK, s, gridDim.x, t_lo, t_hi);
  const int n = t_hi - t_lo;
  const bf16* kb = k + ((size_t)b * Hc + h) * (size_t)Smax * D;
  const bf16* vb = v + ((size_t)b * Hc + h) * (size_t)Smax * D;
  // tile t_lo + i into stage i % ST; keys at or past L zero-filled
  auto load_kv = [&](int i) {
    const uint32_t st = kv_addr + (i % ST) * 2 * BK * RB;
    const int j0 = (t_lo + i) * BK;
    load_rows_async<D, BK, NT>(st, kb + (size_t)j0 * D, 0, L - j0);
    load_rows_async<D, BK, NT>(st + BK * RB, vb + (size_t)j0 * D, 0, L - j0);
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n) load_kv(i);
    cp_async_commit();   // group 0 also holds Q
  }

  float o[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float c = scale * LOG2E;

  for (int i = 0; i < n; ++i) {
    // tile i has landed and every warp is done with tile i - 1, whose
    // stage now takes tile i + ST - 1
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (i + ST - 1 < n) load_kv(i + ST - 1);
    cp_async_commit();
    const int j0 = (t_lo + i) * BK + warp * 16;      // this warp's first key
    if (j0 >= L) continue;
    const uint32_t st = kv_addr + (i % ST) * 2 * BK * RB + warp * 16 * RB;
    float sc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    mma_abt<D, NB>(sc, q_addr, st);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + nb * 8 + 2 * tq + (e & 1);
        sc[nb][e] = key < L ? sc[nb][e] * c : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nb][e]);
      }
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
        const float p = exp2f(sc[nb][e] - m_use[e >> 1]);
        sc[nb][e] = p;
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
    pack_a<NB>(pa, sc);
    mma_pm<D, NB / 2>(o, pa, st + BK * RB);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free (and Q has landed even when no tile ran)

  // this warp's partial: rows g and g + 8 of its accumulators
  const int g = lane >> 2;
  float* po = reinterpret_cast<float*>(smem + S::po_off);
  float* pm = reinterpret_cast<float*>(smem + S::pm_off);
  float* pl = reinterpret_cast<float*>(smem + S::pl_off);
  float* pw = po + warp * MAXG * S::LDO;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    *reinterpret_cast<float2*>(pw + g * S::LDO + nb * 8 + 2 * tq) =
        make_float2(o[nb][0], o[nb][1]);
    *reinterpret_cast<float2*>(pw + (g + 8) * S::LDO + nb * 8 + 2 * tq) =
        make_float2(o[nb][2], o[nb][3]);
  }
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  if (tq == 0) {
    pm[warp * MAXG + g] = m[0];
    pm[warp * MAXG + g + 8] = m[1];
    pl[warp * MAXG + g] = l0;
    pl[warp * MAXG + g + 8] = l1;
  }
  __syncthreads();
  // the block's partial: its four warps merged in warp order
  float* bo = reinterpret_cast<float*>(smem + S::bo_off);
  float* bm = reinterpret_cast<float*>(smem + S::bm_off);
  float* bl = reinterpret_cast<float*>(smem + S::bl_off);
  for (int e = threadIdx.x; e < G * D; e += NT) {
    const int r = e / D, d = e % D;
    float mx = NEG_INF, a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, pm[w * MAXG + r]);
#pragma unroll
    for (int w = 0; w < 4; ++w) a += exp2f(pm[w * MAXG + r] - mx) * po[(w * MAXG + r) * S::LDO + d];
    bo[e] = a;
    if (d == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += exp2f(pm[w * MAXG + r] - mx) * pl[w * MAXG + r];
      bm[r] = mx;
      bl[r] = sum;
    }
  }
  cluster_combine<bf16, D>(bo, bm, bl, out + ((size_t)b * Hq + (size_t)h * G) * D, G);
}

// One launch of `kernel` on an NS x Hkv x B grid whose NS blocks of a
// (row, KV head) form one cluster.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int ns, int Hkv, int B, int smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ns, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* lengths,
                     void* out, int B, int Hq, int Hkv, int Hc, int Smax, int NS,
                     int dtype, float scale, cudaStream_t st) {
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 0) {
    return launch_cluster(decode_fma_kernel<float, D>, NS, Hkv, B, 0, st,
                          static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), len, static_cast<float*>(out), Hq,
                          Hkv, Hc, Smax, scale);
  }
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, DecSmem<D>::bytes);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  return launch_cluster(decode_mma_kernel<D>, NS, Hkv, B, DecSmem<D>::bytes, st,
                        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), len, static_cast<bf16*>(out), Hq, Hkv,
                        Hc, Smax, scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  NS blocks (one cluster, 1..8) share
// each (row, KV head).  k and v point at the first KV head read of row 0;
// a row of the cache holds Hc >= Hkv heads (Hc > Hkv: the kernel reads Hkv
// of them in place, a head slice of a cache whose heads are replicated
// over a model axis).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, int B, int Hq, int Hkv,
                            int Hc, int Smax, int D, int NS, int dtype, float scale,
                            void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || Hc < Hkv || Smax <= 0 ||
      NS <= 0 || NS > MAX_SPLITS || B > 65535 || Hkv > 65535 ||
      (D != 16 && D != 32 && D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_d<16>(q, k, v, lengths, out, B, Hq, Hkv, Hc, Smax, NS, dtype, scale, st);
    case 32: return (int)launch_d<32>(q, k, v, lengths, out, B, Hq, Hkv, Hc, Smax, NS, dtype, scale, st);
    case 64: return (int)launch_d<64>(q, k, v, lengths, out, B, Hq, Hkv, Hc, Smax, NS, dtype, scale, st);
    default: return (int)launch_d<128>(q, k, v, lengths, out, B, Hq, Hkv, Hc, Smax, NS, dtype, scale, st);
  }
}

// The dynamic shared memory the bf16 kernel launches with at head dim D;
// 0 for a head dim it does not take.
int decode_attention_smem_bytes(int D) {
  switch (D) {
    case 16: return DecSmem<16>::bytes;
    case 32: return DecSmem<32>::bytes;
    case 64: return DecSmem<64>::bytes;
    case 128: return DecSmem<128>::bytes;
  }
  return 0;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
