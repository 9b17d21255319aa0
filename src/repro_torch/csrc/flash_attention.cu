// Full-sequence blocked GQA attention for training: a forward kernel that
// also writes each row's log-sum-exp, and a FlashAttention-2 style backward.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _fa_kernel, tile skip _block_reachable).  The
// reference's backward recomputes through its plain version
// (src/repro/kernels/ops.py: _pallas_attention_bwd); here the backward is a
// kernel too, so nothing on the card's training path runs the plain version.
//
// What bounds it on an H100: operations.  At olmo-1b training shapes
// (B 4, 16 heads, S 2048, D 128, causal) there are 134 M live (q, k) pairs
// per layer: 4·D flops a pair forward and 10·D backward (S and dP, dV, dK,
// dQ products), against 2·S·D bytes per head of Q/K/V/O — some 300 flops a
// byte, at the card's ridge, so only the tensor cores can approach the bound.
//
// Two routes by dtype:
//  * bfloat16 (training): every product on the tensor cores through
//    mma.sync m16n8k16 (bf16 in, f32 accumulators), whose accumulator
//    layout the PTX ISA documents: lane l holds rows l/4 and l/4 + 8 of
//    each 16 x 8 tile.  That makes a one-pass online softmax possible —
//    row max and sum with two quad shuffles, the O accumulator rescaled
//    per row in registers — and lets S, P, dP and dS stay in registers: P
//    and dS are repacked from the accumulator straight into the A operand
//    of the next product, with no shared-memory round trip (section
//    "bf16 on the tensor cores" below);
//  * float32 (the smoke configs, checks): f32 FMAs on the CUDA cores
//    (67 TFLOP/s), small tiles, exact to f32 rounding.
//
// What the design does about it, on both routes:
//  * forward: one block per (query tile, query head, batch row).  It loops
//    only over the key tiles its rows can reach — the key range of the
//    tile's first and last query under the mask (causal, sliding window,
//    chunked or bidirectional; q_offset shifts the queries), the
//    counterpart of _block_reachable's pl.when.  Softmax statistics in f32;
//    out = acc / max(l, 1e-30), so a row with no live key comes out 0;
//    masked scores contribute exactly 0 to l.  It also writes lse = m +
//    log(max(l, 1e-30)) per row;
//  * backward: one dK/dV block per (key tile, KV head, batch row) that
//    loops over the G query heads of its KV head and over the query tiles
//    that reach its keys, so the GQA sum over G is taken inside one block,
//    in a fixed order, with no atomics; one dQ block per (query tile, query
//    head, batch row) that loops over the key tiles its rows reach.  Each
//    recomputes P = exp(s - lse) from the saved lse, accumulates in f32
//    registers and writes in the operands' dtype.  delta = sum_j P dP per
//    query row: on the f32 route rowsum(dO * O) of the f32 output (three
//    launches: delta, dK/dV, dQ); on the bf16 route the dQ kernel sums it
//    exactly in a first pass and writes it for the dK/dV kernel (two
//    launches: dQ, then dK/dV);
//  * ragged tails: rows past Sq and keys past Sk are zero-filled in shared
//    memory and masked, so no length has to be a multiple of a tile.
//
// What the bf16 route adds against the bound:
//  * tiles stream through a two-stage shared-memory ring filled with
//    16-byte cp.async copies: right after the barrier that frees a stage,
//    the next tile's copy is issued, and it lands while the current tile is
//    multiplied (one barrier a tile); rows are padded by 16 bytes so that
//    ldmatrix reads them without bank conflicts;
//  * masks cost almost nothing: under every kind the keys a query row
//    reaches (and the queries that reach a key) form one interval, which
//    each lane computes for its two rows once per block, so the
//    per-element test is two compares, with no branch or division; it runs
//    only on tiles that cross the mask's edge or a ragged tail, and a warp
//    skips tiles its 16 rows cannot reach (a per-element test with the kind
//    known only at run time puts branches and integer divisions beside
//    every score, and costs more than the products it guards);
//  * scale·log2(e) is folded into one multiply and exp2f does the rest;
//  * the forward (128 rows, 8 warps, two blocks an SM) launches the
//    heaviest causal query tiles first, as does the dQ kernel; the dQ and
//    dK/dV kernels take 64 rows in 4 warps, two blocks an SM, because their
//    accumulators leave registers for no more; epilogues write 16-byte
//    vectors through the warp's own shared-memory rows;
//  * what still bounds it: mma.sync with 16-row warp tiles reads every B
//    operand from shared memory once per 16 rows and leaves few independent
//    products in flight per warp, so the kernels run at about a quarter
//    of the tensor cores' peak, counting the products they execute (wgmma
//    with TMA is the route to the full rate); the exact delta costs the dQ kernel a second pass over its
//    key tiles (9 products of 16 x 8 x D per pair of tiles in the backward
//    against 7 without it).
//
// Head dims: q and k are D wide, v (and so out and dO) DV wide.  Both routes
// take D = DV in {16, 32, 64, 128}; the bf16 route also takes MLA's D = 192
// with DV = 128 (DeepSeek-V2: 128 no-rope + 64 rope dims, v 128), its tiles
// sized in Tc<D, DV>: the forward keeps 64 query rows a block instead of 128,
// so that two blocks still share an SM.  The float32 kernels spread D over
// their 128 threads and refuse 192.
//
// Plain C interface (loaded with ctypes): each *_launch returns
// cudaGetLastError() after its launches; each *_smem_bytes the dynamic
// shared memory a bf16 kernel takes for a head dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// forward tile
constexpr int F_NT = 128;       // threads per block
constexpr int F_BQ = 16;        // query rows per block
constexpr int F_BK = 32;        // keys per tile (one per lane)

// backward tiles (dK/dV and dQ kernels)
constexpr int B_NT = 256;
constexpr int B_BQ = 32;
constexpr int B_BK = 32;

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

__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// kind: 0 causal, 1 sliding, 2 chunked, 3 bidirectional
struct Mask {
  int kind, window, chunk, q_offset;

  // is the pair (query row i, key j) live?  positions: q_offset + i and j
  __device__ __forceinline__ bool live(int i, int j) const {
    if (kind == 3) return true;
    const int qp = q_offset + i;
    bool m = qp >= j;
    if (kind == 1) m = m && (qp - j < window);
    else if (kind == 2) m = m && (floordiv(qp, chunk) == floordiv(j, chunk));
    return m;
  }

  // keys [*kb, *ke) that query rows [i_lo, i_hi) can reach (may be empty)
  __device__ __forceinline__ void key_range(int i_lo, int i_hi, int Sk, int* kb,
                                            int* ke) const {
    int b = 0, e = Sk;
    if (kind != 3) e = min(e, q_offset + i_hi);                  // k <= q
    if (kind == 1) b = max(b, q_offset + i_lo - window + 1);     // q - k < window
    if (kind == 2) b = max(b, floordiv(q_offset + i_lo, chunk) * chunk);
    *kb = b;
    *ke = e;
  }

  // is every pair of query rows [i_lo, i_hi] and keys [j_lo, j_hi]
  // (inclusive) live?  Then a tile needs no per-element mask.
  __device__ __forceinline__ bool all_live(int i_lo, int i_hi, int j_lo, int j_hi) const {
    if (kind == 3) return true;
    const int qa = q_offset + i_lo, qb = q_offset + i_hi;
    if (qa < j_hi) return false;                                  // k <= q
    if (kind == 1) return qb - j_lo < window;                     // q - k < window
    if (kind == 2) return floordiv(j_lo, chunk) == floordiv(qb, chunk);
    return true;
  }

  // query rows [*ib, *ie) that can reach keys [k_lo, k_hi) (may be empty)
  __device__ __forceinline__ void row_range(int k_lo, int k_hi, int Sq, int* ib,
                                            int* ie) const {
    int b = 0, e = Sq;
    if (kind != 3) b = max(b, k_lo - q_offset);                  // q >= k
    if (kind == 1) e = min(e, k_hi - 1 + window - q_offset);
    if (kind == 2) e = min(e, (floordiv(k_hi - 1, chunk) + 1) * chunk - q_offset);
    *ib = b;
    *ie = e;
  }
};

// Stage rows [r0, r0 + R) of a (rows, D) matrix into a padded shared tile
// (row stride LD elements); rows past n_rows are zero-filled.  16-byte loads,
// all issued before the first store.
template <typename T, int D, int R, int NT, int LD>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src,
                                           int r0, int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LOADS = R * D / VEC;
  constexpr int NLOAD = (LOADS + NT - 1) / NT;
  const int tid = threadIdx.x;
  uint4 regs[NLOAD];
#pragma unroll
  for (int u = 0; u < NLOAD; ++u) {
    const int e = tid + u * NT, r = (e * VEC) / D, d0 = (e * VEC) % D;
    regs[u] = make_uint4(0, 0, 0, 0);
    if (e < LOADS && r0 + r < n_rows)
      regs[u] = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + d0);
  }
#pragma unroll
  for (int u = 0; u < NLOAD; ++u) {
    const int e = tid + u * NT, r = (e * VEC) / D, d0 = (e * VEC) % D;
    if (e < LOADS) {
      const T* t = reinterpret_cast<const T*>(&regs[u]);
#pragma unroll
      for (int w = 0; w < VEC; ++w) dst[r * LD + d0 + w] = t[w];
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(F_NT) fa_fwd_kernel(
    const T* __restrict__ q,    // (B, Hq, Sq, D)
    const T* __restrict__ k,    // (B, Hkv, Sk, D)
    const T* __restrict__ v,
    T* __restrict__ out,        // (B, Hq, Sq, D)
    float* __restrict__ lse,    // (B, Hq, Sq)
    int Hq, int Hkv, int Sq, int Sk, Mask mask, float scale) {
  constexpr int NT = F_NT, BQ = F_BQ, BK = F_BK;
  constexpr int KP = D + (sizeof(T) == 2 ? 2 : 1);   // padded K row
  constexpr int SGROUPS = NT / BK;                   // row groups, score phase
  constexpr int SROWS = BQ / SGROUPS;
  constexpr int CGROUPS = NT / D;                    // row groups, PV phase
  constexpr int CROWS = BQ / CGROUPS;
  static_assert(BK == 32 && NT % D == 0 && BQ % CGROUPS == 0, "tile shape");

  __shared__ float q_s[BQ][D];
  __shared__ T k_s[BK * KP];
  __shared__ T v_s[BK * D];
  __shared__ float p_s[BQ][BK];
  __shared__ float m_s[BQ], l_s[BQ], c_s[BQ];

  const int i0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  const T* qb = q + ((size_t)b * Hq + hq) * (size_t)Sq * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Sk * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int i = e / D;
    q_s[i][e % D] = i0 + i < Sq ? to_f(qb[(size_t)(i0 + i) * D + e % D]) * scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int d = tid % D;
  const int cg = tid / D;
  float acc[CROWS];
#pragma unroll
  for (int r = 0; r < CROWS; ++r) acc[r] = 0.f;

  int k_begin, k_end;
  mask.key_range(i0, min(i0 + BQ, Sq), Sk, &k_begin, &k_end);
  for (int j0 = (k_begin / BK) * BK; j0 < k_end; j0 += BK) {
    __syncthreads();  // previous tile consumed; q_s visible
    stage_tile<T, D, BK, NT, KP>(k_s, kb, j0, Sk);
    stage_tile<T, D, BK, NT, D>(v_s, vb, j0, Sk);
    __syncthreads();

    // scores: lane owns key j, warp owns rows i = warp + r * SGROUPS
    {
      const int j = lane;
      float s[SROWS];
#pragma unroll
      for (int r = 0; r < SROWS; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float kd = to_f(k_s[j * KP + dd]);
#pragma unroll
        for (int r = 0; r < SROWS; ++r) s[r] += q_s[warp + r * SGROUPS][dd] * kd;
      }
#pragma unroll
      for (int r = 0; r < SROWS; ++r) {
        const int i = warp + r * SGROUPS;
        const bool ok = i0 + i < Sq && j0 + j < Sk && mask.live(i0 + i, j0 + j);
        p_s[i][j] = ok ? s[r] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per row, one key per lane; a masked score
    // gets p = 0 exactly, so a row with no live key keeps l = 0
    for (int i = warp; i < BQ; i += NT / 32) {
      const float x = p_s[i][lane];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = x == NEG_INF ? 0.f : expf(x - m_new);
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

    // acc = acc * corr + p @ v; keys outer, rows inner
#pragma unroll
    for (int r = 0; r < CROWS; ++r) acc[r] *= c_s[cg + r * CGROUPS];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float vj = to_f(v_s[j * D + d]);
#pragma unroll
      for (int r = 0; r < CROWS; ++r) acc[r] += p_s[cg + r * CGROUPS][j] * vj;
    }
  }
  __syncthreads();

  const size_t row0 = ((size_t)b * Hq + hq) * Sq + i0;
#pragma unroll
  for (int r = 0; r < CROWS; ++r) {
    const int i = cg + r * CGROUPS;
    if (i0 + i < Sq)
      out[(row0 + i) * D + d] = from_f<T>(acc[r] / fmaxf(l_s[i], 1e-30f));
  }
  if (tid < BQ && i0 + tid < Sq)
    lse[row0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta[row] = sum_d dO[row, d] * O[row, d]; one warp per row
template <typename T>
__global__ void __launch_bounds__(128) fa_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
    long long rows, int D) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += to_f(o[row * D + d]) * to_f(dout[row * D + d]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <typename T, int D>
struct BwdSmem {
  static constexpr int LD = D + (sizeof(T) == 2 ? 2 : 1);  // padded row
  static constexpr int PLD = B_BK + 1;
  static constexpr size_t tile = (size_t)B_BQ * LD * sizeof(T);  // B_BQ == B_BK
  // q, dO, k, v tiles; P and dS (f32); lse and delta rows
  static constexpr size_t bytes =
      4 * tile + 2 * (size_t)B_BQ * PLD * sizeof(float) + 2 * B_BQ * sizeof(float);
};

// Scores and dP of a (B_BQ x B_BK) tile, then P = exp(s - lse) and
// dS = P * (dP - delta), masked; written to p_s (if non-null) and ds_s.
// lane owns key j, warp owns rows i = warp + r * 8.
template <typename T, int D>
__device__ __forceinline__ void bwd_tile_p_ds(
    const T* q_s, const T* do_s, const T* k_s, const T* v_s, const float* lse_s,
    const float* dl_s, float* p_s, float* ds_s, int i0, int j0, int Sq, int Sk,
    const Mask& mask, float scale) {
  using S = BwdSmem<T, D>;
  constexpr int LD = S::LD, PLD = S::PLD;
  constexpr int WARPS = B_NT / 32;
  constexpr int ROWS = B_BQ / WARPS;
  static_assert(B_BK == 32 && B_BQ % WARPS == 0, "tile shape");
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  float s[ROWS], dp[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    const float kd = to_f(k_s[j * LD + dd]);
    const float vd = to_f(v_s[j * LD + dd]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = warp + r * WARPS;
      s[r] += (to_f(q_s[i * LD + dd]) * scale) * kd;
      dp[r] += to_f(do_s[i * LD + dd]) * vd;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = warp + r * WARPS;
    const bool ok = i0 + i < Sq && j0 + j < Sk && mask.live(i0 + i, j0 + j);
    const float p = ok ? expf(s[r] - lse_s[i]) : 0.f;
    if (p_s) p_s[i * PLD + j] = p;
    ds_s[i * PLD + j] = p * (dp[r] - dl_s[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(B_NT) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Hq, int Hkv, int Sq, int Sk, Mask mask, float scale) {
  using S = BwdSmem<T, D>;
  constexpr int LD = S::LD, PLD = S::PLD;
  constexpr int CGROUPS = B_NT / D;
  constexpr int CROWS = B_BK / CGROUPS;
  static_assert(B_NT % D == 0 && B_BK % CGROUPS == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + S::tile);
  T* k_s = reinterpret_cast<T*>(smem + 2 * S::tile);
  T* v_s = reinterpret_cast<T*>(smem + 3 * S::tile);
  float* p_s = reinterpret_cast<float*>(smem + 4 * S::tile);
  float* ds_s = p_s + B_BQ * PLD;
  float* lse_s = ds_s + B_BQ * PLD;
  float* dl_s = lse_s + B_BQ;

  const int j0 = blockIdx.x * B_BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int d = tid % D, cg = tid / D;

  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  stage_tile<T, D, B_BK, B_NT, LD>(k_s, k + kv_off, j0, Sk);
  stage_tile<T, D, B_BK, B_NT, LD>(v_s, v + kv_off, j0, Sk);

  float dk_acc[CROWS], dv_acc[CROWS];
#pragma unroll
  for (int r = 0; r < CROWS; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  int i_begin, i_end;
  mask.row_range(j0, min(j0 + B_BK, Sk), Sq, &i_begin, &i_end);
  i_end = min(i_end, Sq);
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const size_t q_off = ((size_t)b * Hq + hq) * (size_t)Sq;
    for (int i0 = (max(i_begin, 0) / B_BQ) * B_BQ; i0 < i_end; i0 += B_BQ) {
      __syncthreads();  // previous tile consumed
      stage_tile<T, D, B_BQ, B_NT, LD>(q_s, q + q_off * D, i0, Sq);
      stage_tile<T, D, B_BQ, B_NT, LD>(do_s, dout + q_off * D, i0, Sq);
      if (tid < B_BQ) {
        const bool in = i0 + tid < Sq;
        lse_s[tid] = in ? lse[q_off + i0 + tid] : 0.f;
        dl_s[tid] = in ? delta[q_off + i0 + tid] : 0.f;
      }
      __syncthreads();
      bwd_tile_p_ds<T, D>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, i0, j0,
                          Sq, Sk, mask, scale);
      __syncthreads();
      // dV[j] += P[:, j]^T dO ; dK[j] += dS[:, j]^T Q (scaled at the end)
#pragma unroll 2
      for (int i = 0; i < B_BQ; ++i) {
        const float dov = to_f(do_s[i * LD + d]);
        const float qv = to_f(q_s[i * LD + d]);
#pragma unroll
        for (int r = 0; r < CROWS; ++r) {
          const int j = cg + r * CGROUPS;
          dv_acc[r] += p_s[i * PLD + j] * dov;
          dk_acc[r] += ds_s[i * PLD + j] * qv;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < CROWS; ++r) {
    const int j = cg + r * CGROUPS;
    if (j0 + j < Sk) {
      const size_t at = kv_off + (size_t)(j0 + j) * D + d;
      dk[at] = from_f<T>(dk_acc[r] * scale);
      dv[at] = from_f<T>(dv_acc[r]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(B_NT) fa_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    int Hq, int Hkv, int Sq, int Sk, Mask mask, float scale) {
  using S = BwdSmem<T, D>;
  constexpr int LD = S::LD, PLD = S::PLD;
  constexpr int CGROUPS = B_NT / D;
  constexpr int CROWS = B_BQ / CGROUPS;
  static_assert(B_NT % D == 0 && B_BQ % CGROUPS == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + S::tile);
  T* k_s = reinterpret_cast<T*>(smem + 2 * S::tile);
  T* v_s = reinterpret_cast<T*>(smem + 3 * S::tile);
  float* ds_s = reinterpret_cast<float*>(smem + 4 * S::tile) + B_BQ * PLD;
  float* lse_s = ds_s + B_BQ * PLD;
  float* dl_s = lse_s + B_BQ;

  const int i0 = blockIdx.x * B_BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int d = tid % D, cg = tid / D;

  const size_t q_off = ((size_t)b * Hq + hq) * (size_t)Sq;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  stage_tile<T, D, B_BQ, B_NT, LD>(q_s, q + q_off * D, i0, Sq);
  stage_tile<T, D, B_BQ, B_NT, LD>(do_s, dout + q_off * D, i0, Sq);
  if (tid < B_BQ) {
    const bool in = i0 + tid < Sq;
    lse_s[tid] = in ? lse[q_off + i0 + tid] : 0.f;
    dl_s[tid] = in ? delta[q_off + i0 + tid] : 0.f;
  }

  float acc[CROWS];
#pragma unroll
  for (int r = 0; r < CROWS; ++r) acc[r] = 0.f;

  int k_begin, k_end;
  mask.key_range(i0, min(i0 + B_BQ, Sq), Sk, &k_begin, &k_end);
  for (int j0 = (k_begin / B_BK) * B_BK; j0 < k_end; j0 += B_BK) {
    __syncthreads();  // previous tile consumed; q/dO rows visible
    stage_tile<T, D, B_BK, B_NT, LD>(k_s, k + kv_off, j0, Sk);
    stage_tile<T, D, B_BK, B_NT, LD>(v_s, v + kv_off, j0, Sk);
    __syncthreads();
    bwd_tile_p_ds<T, D>(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s, i0, j0,
                        Sq, Sk, mask, scale);
    __syncthreads();
    // dQ[i] += dS[i, :] K (scaled at the end)
#pragma unroll 4
    for (int j = 0; j < B_BK; ++j) {
      const float kv = to_f(k_s[j * LD + d]);
#pragma unroll
      for (int r = 0; r < CROWS; ++r) acc[r] += ds_s[(cg + r * CGROUPS) * PLD + j] * kv;
    }
  }

#pragma unroll
  for (int r = 0; r < CROWS; ++r) {
    const int i = cg + r * CGROUPS;
    if (i0 + i < Sq) dq[(q_off + i0 + i) * D + d] = from_f<T>(acc[r] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, ldmatrix, cp.async ring)
// ---------------------------------------------------------------------------
//
// A warp per 16 rows of a block: query rows in the forward and the dQ
// kernel, key rows in the dK/dV kernel.  Every product — S = Q K^T,
// O = P V, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K — is a chain of
// mma.sync m16n8k16 with bf16 operands and f32 accumulators.  A warp's
// 16 x 8 accumulator tile gives lane l rows g = l / 4 and g + 8, columns
// 2 (l % 4) and + 1; the same lane's A fragment of a 16 x 16 operand is
// rows g and g + 8, columns 2 (l % 4) + {0, 1, 8, 9}.  So the scores of two
// neighbouring 8-column tiles, rounded to bf16, are the A fragment of the
// next product over those 16 columns, and P (and dS) never leave
// registers.  P and dS are rounded to bf16 before they multiply (as
// FlashAttention-2 does); dS is formed from the f32 P and dP.  Softmax
// statistics and accumulators stay f32.
//
// delta is not rowsum(dO * O) over the bf16 output: O's rounding (and P's,
// in the forward's P V) shifts it by up to ~1e-2 on rows with few live keys,
// and since each row of dS = P (dP - delta) must sum to 0, that shift lands
// whole in dQ.  The dQ kernel takes delta = sum_j P dP exactly, in f32, in a
// first pass over its key tiles, and writes it for the dK/dV kernel, which
// runs after it.

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int STAGES = 2;             // shared-memory ring depth

// Tiles and shared memory of the three bf16 kernels for a q/k head dim D and
// a v head dim DV (MLA: D = 192, DV = 128; else DV = D).  Q, K and dQ rows
// are D wide, V, O and dO rows DV wide.  Every tile row is its width in
// bf16 padded by 16 bytes: the row stride is then 4 banks past a multiple
// of 32, so the eight row addresses of an ldmatrix hit eight distinct groups
// of four banks.  A block has a warp per 16 resident rows.  Mirrored by
// kernels/flash_attention.py::smem_footprint_bytes.
template <int D, int DV>
struct Tc {
  static constexpr int LD = TcRow<D>::LD, LDV = TcRow<DV>::LD;   // elements
  static constexpr int RB = TcRow<D>::RB, RBV = TcRow<DV>::RB;   // bytes
  // forward: 128 query rows (8 warps) up to D 128, 64 (4 warps) past it;
  // K and V tiles of 64 keys in the ring; two blocks share an SM (at D 192
  // 128 rows would take 137,216 bytes, and one block an SM)
  static constexpr int F_BQ = D > 128 ? 64 : 128, F_BK = 64;
  static constexpr size_t fwd_bytes = (size_t)F_BQ * RB + (size_t)STAGES * F_BK * (RB + RBV);
  // dQ: 64 query rows of Q and dO (4 warps); K and V tiles of 32 keys, so
  // S and dP take 16 registers each beside the dQ accumulator's 64 (D 128)
  // or 96 (D 192)
  static constexpr int DQ_BQ = 64, DQ_BK = 32;
  static constexpr size_t dq_bytes = (size_t)(DQ_BQ + STAGES * DQ_BK) * (RB + RBV);
  // dK/dV: 64 key rows of K and V (4 warps); Q and dO tiles of 32 queries,
  // with their lse and delta rows, in the ring
  static constexpr int KV_BK = 64, KV_BQ = 32;
  static constexpr size_t dkdv_bytes =
      (size_t)(KV_BK + STAGES * KV_BQ) * (RB + RBV) + STAGES * 2 * KV_BQ * sizeof(float);
};

// Under every mask kind the keys a query row reaches form one interval, and
// so do the query rows that reach a key.  lo / hi: the live columns of the
// lane's rows `row` and `row + 8` of a score tile (empty for rows >= Sq).
__device__ __forceinline__ void lane_row_keys(const Mask& mask, int row, int Sq, int Sk,
                                              int (&lo)[2], int (&hi)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lo[r] = hi[r] = 0;
    if (row + 8 * r < Sq) mask.key_range(row + 8 * r, row + 8 * r + 1, Sk, &lo[r], &hi[r]);
  }
}

// Set the elements of a score tile (the lane's columns start at col0:
// col0 + 8 nb + {0, 1}) outside its rows' live columns [lo, hi) to `dead`
template <int NB>
__device__ __forceinline__ void mask_tile(float (&s)[NB][4], int col0, const int (&lo)[2],
                                          const int (&hi)[2], float dead) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + nb * 8 + (e & 1), r = e >> 1;
      if (col < lo[r] || col >= hi[r]) s[nb][e] = dead;
    }
  }
}

// One block per (128 query rows, query head, batch row), launched heaviest
// causal tile first.  Online softmax in the log2 domain: x = s scale
// log2(e), p = exp2(x - m), lse = m ln 2 + log(l).
template <int D, int DV>
__global__ void __launch_bounds__(Tc<D, DV>::F_BQ * 2, 2) fa_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
    Mask mask, float scale) {
  using T = Tc<D, DV>;
  constexpr int BQ = T::F_BQ, BK = T::F_BK, ST = STAGES, NB = BK / 8, RB = T::RB;
  constexpr int KVB = BK * (RB + T::RBV);        // one ring stage
  constexpr int NT = BQ * 2;                     // a warp per 16 rows
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_addr = smem_addr(smem);
  const uint32_t kv_addr = q_addr + BQ * RB;     // stage s: K, then V, of BK rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int iw = i0 + warp * 16;                 // this warp's first row
  const size_t q_row0 = ((size_t)b * Hq + hq) * Sq;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * (size_t)Sk * DV;

  int k_begin, k_end, wk_begin, wk_end;
  mask.key_range(i0, min(i0 + BQ, Sq), Sk, &k_begin, &k_end);
  mask.key_range(iw, min(iw + 16, Sq), Sk, &wk_begin, &wk_end);
  const bool warp_live = iw < Sq;
  const int j_first = (k_begin / BK) * BK;
  const int n_tiles = k_end > j_first ? (k_end - j_first + BK - 1) / BK : 0;
  int lo[2], hi[2];
  lane_row_keys(mask, iw + g, Sq, Sk, lo, hi);

  // tile t goes to stage t % ST; tiles 0 .. ST - 2 (and Q) before the loop
  auto load_kv = [&](int t) {
    const uint32_t st = kv_addr + (t % ST) * KVB;
    load_rows_async<D, BK, NT>(st, kb, j_first + t * BK, Sk);
    load_rows_async<DV, BK, NT>(st + BK * RB, vb, j_first + t * BK, Sk);
  };
  load_rows_async<D, BQ, NT>(q_addr, q + q_row0 * D, i0, Sq);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  float o[DV / 8][4];
#pragma unroll
  for (int nb = 0; nb < DV / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float c = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warp is done with tile t - 1, whose stage
    // now takes tile t + ST - 1 while this one is multiplied
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (t + ST - 1 < n_tiles) load_kv(t + ST - 1);
    cp_async_commit();
    const int j0 = j_first + t * BK;
    if (warp_live && j0 < wk_end && j0 + BK > wk_begin) {
      const uint32_t st = kv_addr + (t % ST) * KVB;
      float s[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      mma_abt<D, NB>(s, q_addr + warp * 16 * RB, st);

      // scale; mask only a tile that crosses the mask's edge or a tail
      const bool edge =
          j0 + BK > Sk || iw + 16 > Sq || !mask.all_live(iw, iw + 15, j0, j0 + BK - 1);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= c;
      }
      if (edge) mask_tile<NB>(s, j0 + 2 * tq, lo, hi, NEG_INF);
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
      for (int nb = 0; nb < DV / 8; ++nb) {
        o[nb][0] *= alpha[0];
        o[nb][1] *= alpha[0];
        o[nb][2] *= alpha[1];
        o[nb][3] *= alpha[1];
      }
      uint32_t pa[NB / 2][4];
      pack_a<NB>(pa, s);
      mma_pm<DV, NB / 2>(o, pa, st + BK * RB);
    }
  }
  cp_async_wait<0>();
  __syncthreads();             // Q has landed even when no tile ran

  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    f[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // each warp stages in its own Q rows
  store_rows<DV>(out + q_row0 * DV, o, f, q_s + warp * 16 * T::LD, iw, Sq);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + g + 8 * r;
      if (i < Sq)
        lse[q_row0 + i] = (m[r] == NEG_INF ? NEG_INF : m[r] * LN2) + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

// One block per (64 query rows, query head, batch row), launched heaviest
// causal tile first.  Two passes over the key tiles its rows reach: the
// first takes delta = sum_j P dP for its rows and writes it; the second
// accumulates dQ = scale dS K with dS = P (dP - delta).
template <int D, int DV>
__global__ void __launch_bounds__(Tc<D, DV>::DQ_BQ * 2, 2) fa_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk,
    Mask mask, float scale) {
  using T = Tc<D, DV>;
  constexpr int BQ = T::DQ_BQ, BK = T::DQ_BK, ST = STAGES, NB = BK / 8, RB = T::RB;
  constexpr int RBV = T::RBV, KVB = BK * (RB + RBV);
  constexpr int NT = BQ * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_addr = smem_addr(smem);
  const uint32_t do_addr = q_addr + BQ * RB;
  const uint32_t kv_addr = do_addr + BQ * RBV;   // stage s: K, then V, of BK rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;

  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int iw = i0 + warp * 16;
  const size_t q_row0 = ((size_t)b * Hq + hq) * Sq;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * (size_t)Sk * DV;

  int k_begin, k_end, wk_begin, wk_end;
  mask.key_range(i0, min(i0 + BQ, Sq), Sk, &k_begin, &k_end);
  mask.key_range(iw, min(iw + 16, Sq), Sk, &wk_begin, &wk_end);
  const bool warp_live = iw < Sq;
  const int j_first = (k_begin / BK) * BK;
  const int n_tiles = k_end > j_first ? (k_end - j_first + BK - 1) / BK : 0;
  int lo[2], hi[2];
  lane_row_keys(mask, iw + g, Sq, Sk, lo, hi);

  // iteration t < 2 n_tiles visits key tile t mod n_tiles, in stage t % ST
  const int n_iter = 2 * n_tiles;
  auto load_kv = [&](int t) {
    const int j0 = j_first + (t % n_tiles) * BK;
    const uint32_t st = kv_addr + (t % ST) * KVB;
    load_rows_async<D, BK, NT>(st, kb, j0, Sk);
    load_rows_async<DV, BK, NT>(st + BK * RB, vb, j0, Sk);
  };
  load_rows_async<D, BQ, NT>(q_addr, q + q_row0 * D, i0, Sq);
  load_rows_async<DV, BQ, NT>(do_addr, dout + q_row0 * DV, i0, Sq);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_iter) load_kv(t);
    cp_async_commit();
  }

  // lse of the lane's rows g and g + 8, in the log2 domain
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + g + 8 * r;
    lse2[r] = i < Sq ? lse[q_row0 + i] * LOG2E : 0.f;
  }
  const float c = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float dl[2] = {0.f, 0.f};   // pass 1: the lane's partial sums; then delta

  auto finish_delta = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] = quad_sum(dl[r]);
      const int i = iw + g + 8 * r;
      if (tq == 0 && i < Sq) delta[q_row0 + i] = dl[r];
    }
  };

  for (int t = 0; t < n_iter; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (t + ST - 1 < n_iter) load_kv(t + ST - 1);
    cp_async_commit();
    if (t == n_tiles) finish_delta();
    const bool pass2 = t >= n_tiles;
    const int j0 = j_first + (pass2 ? t - n_tiles : t) * BK;
    if (warp_live && j0 < wk_end && j0 + BK > wk_begin) {
      const uint32_t st = kv_addr + (t % ST) * KVB;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
        dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
      }
      mma_abt<D, NB>(s, q_addr + warp * 16 * RB, st);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = s[nb][e] * c - lse2[e >> 1];
      }
      const bool edge =
          j0 + BK > Sk || iw + 16 > Sq || !mask.all_live(iw, iw + 15, j0, j0 + BK - 1);
      if (edge) mask_tile<NB>(s, j0 + 2 * tq, lo, hi, NEG_INF);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = exp2f(s[nb][e]);
      }
      mma_abt<DV, NB>(dp, do_addr + warp * 16 * RBV, st + BK * RB);
      if (!pass2) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dl[e >> 1] += s[nb][e] * dp[nb][e];
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nb][e] *= dp[nb][e] - dl[e >> 1];
        }
        uint32_t da[NB / 2][4];
        pack_a<NB>(da, s);
        mma_pm<D, NB / 2>(acc, da, st);            // dQ += dS K
      }
    }
  }
  if (n_tiles == 0) finish_delta();               // rows that reach no key: 0
  cp_async_wait<0>();
  __syncthreads();

  const float f[2] = {scale, scale};
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  store_rows<D>(dq + q_row0 * D, acc, f, q_s + warp * 16 * T::LD, iw, Sq);
}

// One block per (64 keys, KV head, batch row); each warp owns 16 keys and
// holds their dK and dV in registers.  The block streams the (query head,
// query tile) pairs that reach its keys — the G query heads of its KV head
// in order — so the GQA sum is taken in a fixed order, with no atomics.
template <int D, int DV>
__global__ void __launch_bounds__(Tc<D, DV>::KV_BK * 2, 2) fa_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
    int Hkv, int Sq, int Sk, Mask mask, float scale) {
  using T = Tc<D, DV>;
  constexpr int BKV = T::KV_BK, QT = T::KV_BQ, ST = STAGES, NB = QT / 8, RB = T::RB;
  constexpr int RBV = T::RBV, QDB = QT * (RB + RBV);
  constexpr int NT = BKV * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t k_addr = smem_addr(smem);
  const uint32_t v_addr = k_addr + BKV * RB;
  const uint32_t qd_addr = v_addr + BKV * RBV;   // stage s: Q, then dO, of QT rows
  float* stats = reinterpret_cast<float*>(smem + BKV * (RB + RBV) + ST * QDB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;

  const int j0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int jw = j0 + warp * 16;                 // this warp's first key
  const size_t kv_row0 = ((size_t)b * Hkv + hk) * (size_t)Sk;

  int i_begin, i_end, wi_begin, wi_end;
  mask.row_range(j0, min(j0 + BKV, Sk), Sq, &i_begin, &i_end);
  mask.row_range(jw, min(jw + 16, Sk), Sq, &wi_begin, &wi_end);
  i_end = min(i_end, Sq);
  const bool warp_live = jw < Sk;
  const int i_first = (max(i_begin, 0) / QT) * QT;
  int lo[2], hi[2];            // the query rows that reach the lane's keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = jw + g + 8 * r;
    lo[r] = hi[r] = 0;
    if (j < Sk) mask.row_range(j, j + 1, Sq, &lo[r], &hi[r]);
  }
  const int nq = i_end > i_first ? (i_end - i_first + QT - 1) / QT : 0;
  const int n_tiles = G * nq;

  // tile t: query head hk G + t / nq, rows from i_first + (t % nq) QT
  auto load_qt = [&](int t) {
    const int i0 = i_first + (t % nq) * QT;
    const size_t q_row0 = ((size_t)b * Hq + hk * G + t / nq) * Sq;
    const int s = t % ST;
    const uint32_t st = qd_addr + s * QDB;
    load_rows_async<D, QT, NT>(st, q + q_row0 * D, i0, Sq);
    load_rows_async<DV, QT, NT>(st + QT * RB, dout + q_row0 * DV, i0, Sq);
    if (threadIdx.x < 2 * QT) {
      const int r = threadIdx.x % QT, which = threadIdx.x / QT;
      const bool in = i0 + r < Sq;
      const float* src = (which == 0 ? lse : delta) + q_row0 + (in ? i0 + r : 0);
      cp_async4(smem_addr(stats + (s * 2 + which) * QT + r), src, in);
    }
  };
  load_rows_async<D, BKV, NT>(k_addr, k + kv_row0 * D, j0, Sk);
  load_rows_async<DV, BKV, NT>(v_addr, v + kv_row0 * DV, j0, Sk);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) load_qt(t);
    cp_async_commit();
  }

  const float c = scale * LOG2E;
  float dk_acc[D / 8][4], dv_acc[DV / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) dk_acc[nb][0] = dk_acc[nb][1] = dk_acc[nb][2] = dk_acc[nb][3] = 0.f;
#pragma unroll
  for (int nb = 0; nb < DV / 8; ++nb) dv_acc[nb][0] = dv_acc[nb][1] = dv_acc[nb][2] = dv_acc[nb][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (t + ST - 1 < n_tiles) load_qt(t + ST - 1);
    cp_async_commit();
    const int i0 = i_first + (t % nq) * QT;
    if (warp_live && i0 < wi_end && i0 + QT > wi_begin) {
      const int s_ = t % ST;
      const uint32_t qs = qd_addr + s_ * QDB, dos = qs + QT * RB;
      const float* lse_s = stats + (s_ * 2) * QT;
      const float* dl_s = lse_s + QT;
      // P^T (16 keys x QT queries) = exp2(K Q^T c - lse log2(e)), masked
      float p[NB][4], dpt[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        p[nb][0] = p[nb][1] = p[nb][2] = p[nb][3] = 0.f;
        dpt[nb][0] = dpt[nb][1] = dpt[nb][2] = dpt[nb][3] = 0.f;
      }
      mma_abt<D, NB>(p, k_addr + warp * 16 * RB, qs);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + nb * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nb][e] = p[nb][e] * c - ((e & 1) ? ls.y : ls.x) * LOG2E;
      }
      const bool edge =
          i0 + QT > Sq || jw + 16 > Sk || !mask.all_live(i0, i0 + QT - 1, jw, jw + 15);
      if (edge) mask_tile<NB>(p, i0 + 2 * tq, lo, hi, NEG_INF);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nb][e] = exp2f(p[nb][e]);
      }
      mma_abt<DV, NB>(dpt, v_addr + warp * 16 * RBV, dos);   // dP^T = V dO^T
      uint32_t pa[NB / 2][4];
      pack_a<NB>(pa, p);
      mma_pm<DV, NB / 2>(dv_acc, pa, dos);                   // dV += P^T dO
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + nb * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nb][e] *= dpt[nb][e] - ((e & 1) ? dl.y : dl.x);
      }
      pack_a<NB>(pa, p);
      mma_pm<D, NB / 2>(dk_acc, pa, qs);                     // dK += dS^T Q
    }
  }
  cp_async_wait<0>();
  __syncthreads();             // K and V have landed even when no tile ran

  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + BKV * T::LD;
  const float fk[2] = {scale, scale}, fv[2] = {1.f, 1.f};
  store_rows<D>(dk + kv_row0 * D, dk_acc, fk, k_s + warp * 16 * T::LD, jw, Sk);
  store_rows<DV>(dv + kv_row0 * DV, dv_acc, fv, v_s + warp * 16 * T::LDV, jw, Sk);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// raise a kernel's dynamic shared-memory cap (once per instantiation)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *configured = e == cudaSuccess;
  return e;
}

template <typename T, int D, int DV>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* out, void* lse,
                  int B, int Hq, int Hkv, int Sq, int Sk, Mask mask, float scale,
                  cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = Tc<D, DV>::fwd_bytes;
    static bool configured = false;
    const cudaError_t e = allow_smem(fa_fwd_mma_kernel<D, DV>, smem, &configured);
    if (e != cudaSuccess) return e;
    constexpr int BQ = Tc<D, DV>::F_BQ;
    fa_fwd_mma_kernel<D, DV><<<dim3((Sq + BQ - 1) / BQ, Hq, B), BQ * 2, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse),
        Hq, Hkv, Sq, Sk, mask, scale);
  } else {
    static_assert(D == DV, "the float32 kernels take one head dim");
    fa_fwd_kernel<T, D><<<dim3((Sq + F_BQ - 1) / F_BQ, Hq, B), F_NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), static_cast<float*>(lse), Hq, Hkv, Sq, Sk, mask, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t bwd_t(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta, void* dq,
                  void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                  Mask mask, float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* dl_ = static_cast<float*>(delta);
  cudaError_t e = cudaSuccess;
  if constexpr (std::is_same<T, bf16>::value) {
    // the dQ kernel takes delta = sum_j P dP itself and writes it for dK/dV
    using TC = Tc<D, DV>;
    static bool conf_dkdv = false, conf_dq = false;
    e = allow_smem(fa_bwd_dkdv_mma_kernel<D, DV>, TC::dkdv_bytes, &conf_dkdv);
    if (e == cudaSuccess) e = allow_smem(fa_bwd_dq_mma_kernel<D, DV>, TC::dq_bytes, &conf_dq);
    if (e != cudaSuccess) return e;
    fa_bwd_dq_mma_kernel<D, DV><<<dim3((Sq + TC::DQ_BQ - 1) / TC::DQ_BQ, Hq, B),
                                  TC::DQ_BQ * 2, TC::dq_bytes, stream>>>(
        q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, mask, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    fa_bwd_dkdv_mma_kernel<D, DV><<<dim3((Sk + TC::KV_BK - 1) / TC::KV_BK, Hkv, B),
                                    TC::KV_BK * 2, TC::dkdv_bytes, stream>>>(
        q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv,
        Sq, Sk, mask, scale);
  } else {
    static_assert(D == DV, "the float32 kernels take one head dim");
    const long long rows = (long long)B * Hq * Sq;
    fa_bwd_delta_kernel<T><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
        static_cast<const T*>(o), do_, dl_, rows, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t smem = BwdSmem<T, D>::bytes;
    static bool conf_dkdv = false, conf_dq = false;
    e = allow_smem(fa_bwd_dkdv_kernel<T, D>, smem, &conf_dkdv);
    if (e == cudaSuccess) e = allow_smem(fa_bwd_dq_kernel<T, D>, smem, &conf_dq);
    if (e != cudaSuccess) return e;
    fa_bwd_dkdv_kernel<T, D><<<dim3((Sk + B_BK - 1) / B_BK, Hkv, B), B_NT, smem, stream>>>(
        q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv,
        Sq, Sk, mask, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    fa_bwd_dq_kernel<T, D><<<dim3((Sq + B_BQ - 1) / B_BQ, Hq, B), B_NT, smem, stream>>>(
        q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, mask, scale);
  }
  return cudaGetLastError();
}

// The (q/k, v) head dims the kernels take: (16, 16), (32, 32), (64, 64) and
// (128, 128) in both dtypes; MLA's (192, 128) in bfloat16 only (the float32
// kernels take one head dim that divides their 128 threads).  Mirrored by
// kernels/flash_attention.py::FA_HEAD_DIMS.
bool takes_head_dims(int D, int DV, int dtype) {
  if (D == DV) return D == 16 || D == 32 || D == 64 || D == 128;
  return dtype == 1 && D == 192 && DV == 128;
}

bool bad_shape(int B, int Hq, int Hkv, int Sq, int Sk, int D, int DV, int dtype, int kind,
               int window, int chunk) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
         (dtype != 0 && dtype != 1) || !takes_head_dims(D, DV, dtype) ||
         kind < 0 || kind > 3 || (kind == 1 && window <= 0) ||
         (kind == 2 && chunk <= 0) || Hq > 65535 || B > 65535;
}

// the dynamic shared memory of a bf16 kernel (0: fwd, 1: dQ, 2: dK/dV) for
// head dims (D, DV); -1 for head dims the bf16 kernels do not take
template <int D, int DV>
int smem_of(int which) {
  return (int)(which == 0 ? Tc<D, DV>::fwd_bytes
                          : which == 1 ? Tc<D, DV>::dq_bytes : Tc<D, DV>::dkdv_bytes);
}
int smem_bytes(int which, int D, int DV) {
  if (!takes_head_dims(D, DV, 1)) return -1;
  switch (D) {
    case 16: return smem_of<16, 16>(which);
    case 32: return smem_of<32, 32>(which);
    case 64: return smem_of<64, 64>(which);
    case 128: return smem_of<128, 128>(which);
    case 192: return smem_of<192, 128>(which);
  }
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; kind: 0 causal, 1 sliding, 2 chunked,
// 3 bidirectional.  q and k are (.., D) wide, v (.., DV).  Writes out (B, Hq,
// Sq, DV) and lse (B, Hq, Sq) f32.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int Hq, int Hkv,
                               int Sq, int Sk, int D, int DV, int dtype, int kind,
                               int window, int chunk, int q_offset, float scale,
                               void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Sk, D, DV, dtype, kind, window, chunk))
    return (int)cudaErrorInvalidValue;
  const Mask mask{kind, window, chunk, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FA_FWD(TT, DD, VV) \
  e = fwd_t<TT, DD, VV>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, mask, scale, s)
#define REPRO_FA_FWD_D(TT)                       \
  switch (D) {                                   \
    case 16: REPRO_FA_FWD(TT, 16, 16); break;    \
    case 32: REPRO_FA_FWD(TT, 32, 32); break;    \
    case 64: REPRO_FA_FWD(TT, 64, 64); break;    \
    case 128: REPRO_FA_FWD(TT, 128, 128); break; \
  }
  if (dtype == 0) {
    REPRO_FA_FWD_D(float)
  } else if (D == 192) {
    REPRO_FA_FWD(__nv_bfloat16, 192, 128);
  } else {
    REPRO_FA_FWD_D(__nv_bfloat16)
  }
#undef REPRO_FA_FWD_D
#undef REPRO_FA_FWD
  return (int)e;
}

// Gradients of the forward above: dq (B, Hq, Sq, D), dk (B, Hkv, Sk, D) and
// dv (B, Hkv, Sk, DV) in the operands' dtype, from q, k, v, the forward's
// out and lse, and dout.  delta is (B, Hq, Sq) f32 scratch.  Two (bf16) or
// three (f32) launches on one stream.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout, const void* lse,
                               void* delta, void* dq, void* dk, void* dv, int B,
                               int Hq, int Hkv, int Sq, int Sk, int D, int DV, int dtype,
                               int kind, int window, int chunk, int q_offset,
                               float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Sk, D, DV, dtype, kind, window, chunk))
    return (int)cudaErrorInvalidValue;
  const Mask mask{kind, window, chunk, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FA_BWD(TT, DD, VV)                                                     \
  e = bwd_t<TT, DD, VV>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, \
                        Sk, mask, scale, s)
#define REPRO_FA_BWD_D(TT)                       \
  switch (D) {                                   \
    case 16: REPRO_FA_BWD(TT, 16, 16); break;    \
    case 32: REPRO_FA_BWD(TT, 32, 32); break;    \
    case 64: REPRO_FA_BWD(TT, 64, 64); break;    \
    case 128: REPRO_FA_BWD(TT, 128, 128); break; \
  }
  if (dtype == 0) {
    REPRO_FA_BWD_D(float)
  } else if (D == 192) {
    REPRO_FA_BWD(__nv_bfloat16, 192, 128);
  } else {
    REPRO_FA_BWD_D(__nv_bfloat16)
  }
#undef REPRO_FA_BWD_D
#undef REPRO_FA_BWD
  return (int)e;
}

// Dynamic shared memory, in bytes, of the bf16 kernels (which: 0 the forward,
// 1 the dQ kernel, 2 the dK/dV kernel) for head dims (D, DV); -1 for head
// dims they do not take.  The three one-argument forms take DV = D.
int flash_attention_smem_bytes(int which, int D, int DV) { return smem_bytes(which, D, DV); }
int flash_attention_fwd_smem_bytes(int D) { return smem_bytes(0, D, D); }
int flash_attention_bwd_dq_smem_bytes(int D) { return smem_bytes(1, D, D); }
int flash_attention_bwd_dkdv_smem_bytes(int D) { return smem_bytes(2, D, D); }

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
