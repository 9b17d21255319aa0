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
// dQ products), against 2·S·D bytes per head of Q/K/V/O.
//
// Two routes by dtype:
//  * bfloat16 (training): every product on the tensor cores (WMMA, bf16
//    in, f32 accumulators), blocks of 64 rows in four warps (section
//    "bf16 on the tensor cores" below);
//  * float32 (the smoke configs, checks): f32 FMAs on the CUDA cores
//    (67 TFLOP/s), small tiles, exact to f32 rounding.
//
// What the design does about it, on both routes:
//  * forward: one block per (query tile, query head, batch row).  It loops
//    only over the key tiles its rows can reach — the key range of the
//    tile's first and last query under the mask (causal, sliding window,
//    chunked or bidirectional; q_offset shifts the queries), the
//    counterpart of _block_reachable's pl.when — and masks per element
//    inside a tile.  Softmax statistics in f32; out = acc / max(l, 1e-30),
//    so a row with no live key comes out 0; masked scores contribute
//    exactly 0 to l.  It also writes lse = m + log(l) per row;
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
// Plain C interface (loaded with ctypes): each *_launch returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
// bf16 on the tensor cores (WMMA 16x16x16, f32 accumulators)
// ---------------------------------------------------------------------------
//
// Four warps per block, each owning 16 rows of the block's 64; K/V (or Q/dO)
// tiles of 64 rows are staged in shared memory with 16-byte stores.  Every
// product — S = Q K^T, O = P V, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
// dQ = dS K — is a WMMA product of bf16 tiles with f32 accumulation; P and
// dS are rounded to bf16 before they multiply (as FlashAttention-2 does),
// dS is formed from the f32 P.  Scores, softmax statistics and
// accumulators stay f32.  Unlike FlashAttention-2, delta is not
// rowsum(dO * O) over the bf16 output: O's rounding (and P's, in the
// forward's P V) shifts it by up to ~1e-2 on rows with few live keys, and
// since each row of dS = P (dP - delta) must sum to 0, that shift lands
// whole in dQ.  The dQ kernel first takes delta = sum_j P dP exactly, in
// f32, and writes it for the dK/dV kernel, which runs after it.
// The forward makes
// two passes over its key tiles: the first finds each row's max and sum,
// the second accumulates exp(s - m) V in registers, so the accumulator
// never needs a per-row rescale (WMMA does not expose which row a
// fragment element belongs to); S is computed twice, on the tensor cores.

template <int D>
struct TcSmem {
  static constexpr int LD = D + 8;          // bf16 tile row stride (16 B pad)
  static constexpr int FLD = 64 + 4;        // f32 score row stride
  static constexpr int PLD = 64 + 8;        // bf16 P / dS row stride
  static constexpr int OLD = D + 4;         // f32 epilogue row stride
  static constexpr size_t tile = (size_t)64 * LD * sizeof(__nv_bfloat16);
  static constexpr size_t fbuf = (size_t)4 * 16 * FLD * sizeof(float);
  static constexpr size_t pbuf = (size_t)4 * 16 * PLD * sizeof(__nv_bfloat16);
  // four 64-row tiles, one f32 and one bf16 16 x 64 buffer per warp, 64 +
  // 64 row statistics
  static constexpr size_t bytes = 4 * tile + fbuf + pbuf + 2 * 64 * sizeof(float);
  static_assert(4 * 16 * OLD * sizeof(float) <= 2 * tile, "epilogue fits two tiles");
};

using bf16 = __nv_bfloat16;
namespace wm = nvcuda::wmma;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBr = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// rows [r0, r0 + 64) of a (rows, D) bf16 matrix into a tile of row stride
// LD; rows past n_rows are zero-filled
template <int D, int LD>
__device__ __forceinline__ void stage64(bf16* dst, const bf16* __restrict__ src,
                                        int r0, int n_rows) {
  constexpr int PER_ROW = D / 8;                    // 16-byte chunks per row
  constexpr int LOADS = 64 * PER_ROW;
  constexpr int NLOAD = (LOADS + 127) / 128;
  uint4 regs[NLOAD];
#pragma unroll
  for (int u = 0; u < NLOAD; ++u) {
    const int e = threadIdx.x + u * 128, r = e / PER_ROW, c = e % PER_ROW;
    regs[u] = make_uint4(0, 0, 0, 0);
    if (e < LOADS && r0 + r < n_rows)
      regs[u] = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c * 8);
  }
#pragma unroll
  for (int u = 0; u < NLOAD; ++u) {
    const int e = threadIdx.x + u * 128, r = e / PER_ROW, c = e % PER_ROW;
    if (e < LOADS) *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = regs[u];
  }
}

// f_s (16 x 64, stride FLD) = A_rows (16 x D, stride LD) . B_rows^T, where
// B_rows is 64 rows of D (stride LD): the scores of 16 rows against 64.
template <int D, int LD, int FLD>
__device__ __forceinline__ void tc_scores(float* f_s, const bf16* a_rows,
                                          const bf16* b_rows) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragC c;
    wm::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBc bm;
      wm::load_matrix_sync(a, a_rows + kk * 16, LD);
      wm::load_matrix_sync(bm, b_rows + n * 16 * LD + kk * 16, LD);
      wm::mma_sync(c, a, bm, c);
    }
    wm::store_matrix_sync(f_s + n * 16, c, FLD, wm::mem_row_major);
  }
}

// acc[n] += P (16 x 64, stride PLD) . M (64 rows of D, stride LD)
template <int D, int LD, int PLD>
__device__ __forceinline__ void tc_accumulate(FragC (&acc)[D / 16], const bf16* p_s,
                                              const bf16* m_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA a;
    wm::load_matrix_sync(a, p_s + kk * 16, PLD);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBr bm;
      wm::load_matrix_sync(bm, m_rows + kk * 16 * LD + n * 16, LD);
      wm::mma_sync(acc[n], a, bm, acc[n]);
    }
  }
}

// store 16 x D accumulators (scaled) as rows [row0, row0 + 16) of a (rows, D)
// bf16 matrix, through an f32 staging area of stride OLD; rows >= n_rows
// are not written.  Each row is multiplied by `scale` and, when `row_div`
// is given, divided by max(row_div[r], 1e-30).
template <int D, int OLD>
__device__ __forceinline__ void tc_store_rows(bf16* __restrict__ dst, FragC (&acc)[D / 16],
                                              float* o_s, int row0, int n_rows,
                                              float scale, const float* row_div) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wm::store_matrix_sync(o_s + n * 16, acc[n], OLD, wm::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    if (row0 + r >= n_rows) break;
    const float f = row_div ? scale / fmaxf(row_div[r], 1e-30f) : scale;
    for (int d = lane; d < D; d += 32)
      dst[(size_t)(row0 + r) * D + d] = __float2bfloat16(o_s[r * OLD + d] * f);
  }
}

template <int D>
__global__ void __launch_bounds__(128) fa_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
    Mask mask, float scale) {
  using S = TcSmem<D>;
  constexpr int LD = S::LD, FLD = S::FLD, PLD = S::PLD, OLD = S::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + S::tile);
  bf16* v_s = reinterpret_cast<bf16*>(smem + 2 * S::tile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* f_s = reinterpret_cast<float*>(smem + 4 * S::tile) + warp * 16 * FLD;
  bf16* p_s = reinterpret_cast<bf16*>(smem + 4 * S::tile + S::fbuf) + warp * 16 * PLD;
  float* l_s = reinterpret_cast<float*>(smem + 4 * S::tile + S::fbuf + S::pbuf) +
               warp * 16;
  float* m_s = l_s + 64;

  const int i0 = blockIdx.x * 64, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int iw = i0 + warp * 16;                       // this warp's first row
  const size_t q_row0 = ((size_t)b * Hq + hq) * Sq;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  stage64<D, LD>(q_s, q + q_row0 * D, i0, Sq);

  int k_begin, k_end;
  mask.key_range(i0, min(i0 + 64, Sq), Sk, &k_begin, &k_end);
  const int j_first = (k_begin / 64) * 64;

  // softmax statistics: two lanes per row (row r = lane / 2, columns
  // [32 h, 32 h + 32) for h = lane % 2), visited from a per-lane start so
  // that the 32 lanes read 32 different shared-memory banks
  const int r = lane >> 1, h = lane & 1, i = iw + r;
  const int c_off = r + 16 * h;
  float m_r = NEG_INF, l_r = 0.f;

  // pass 1: row max m and sum l
  for (int j0 = j_first; j0 < k_end; j0 += 64) {
    __syncthreads();
    stage64<D, LD>(k_s, k + kv_off, j0, Sk);
    __syncthreads();
    tc_scores<D, LD, FLD>(f_s, q_s + warp * 16 * LD, k_s);
    __syncwarp();
    float x[32];
    float mx = NEG_INF;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int c = 32 * h + ((t + c_off) & 31), j = j0 + c;
      const bool ok = i < Sq && j < Sk && mask.live(i, j);
      x[t] = ok ? f_s[r * FLD + c] * scale : NEG_INF;
      mx = fmaxf(mx, x[t]);
    }
    const float m_new = fmaxf(m_r, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 32; ++t) sum += x[t] == NEG_INF ? 0.f : expf(x[t] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_r = l_r * expf(m_r - m_new) + sum;
    m_r = m_new;
    __syncwarp();
  }

  if (h == 0) {
    l_s[r] = l_r;
    m_s[r] = m_r;
    if (i < Sq) lse[q_row0 + i] = m_r + logf(fmaxf(l_r, 1e-30f));
  }
  __syncwarp();

  // pass 2: acc = sum_j exp(s - m) v_j; lane owns columns lane, lane + 32
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wm::fill_fragment(acc[n], 0.f);
  for (int j0 = j_first; j0 < k_end; j0 += 64) {
    __syncthreads();
    stage64<D, LD>(k_s, k + kv_off, j0, Sk);
    stage64<D, LD>(v_s, v + kv_off, j0, Sk);
    __syncthreads();
    tc_scores<D, LD, FLD>(f_s, q_s + warp * 16 * LD, k_s);
    __syncwarp();
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const float m_rr = m_s[rr];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = lane + 32 * hh, j = j0 + c;
        const bool ok = iw + rr < Sq && j < Sk && mask.live(iw + rr, j);
        p_s[rr * PLD + c] =
            __float2bfloat16(ok ? expf(f_s[rr * FLD + c] * scale - m_rr) : 0.f);
      }
    }
    __syncwarp();
    tc_accumulate<D, LD, PLD>(acc, p_s, v_s);
    __syncwarp();
  }
  __syncthreads();   // every warp is done with k_s / v_s: reuse them for staging
  float* o_s = reinterpret_cast<float*>(smem + S::tile) + warp * 16 * OLD;
  tc_store_rows<D, OLD>(out + q_row0 * D, acc, o_s, iw, Sq, 1.f, l_s);
}

template <int D>
__global__ void __launch_bounds__(128) fa_bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int Hq, int Hkv, int Sq, int Sk, Mask mask, float scale) {
  using S = TcSmem<D>;
  constexpr int LD = S::LD, FLD = S::FLD, PLD = S::PLD, OLD = S::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = reinterpret_cast<bf16*>(smem + S::tile);
  bf16* k_s = reinterpret_cast<bf16*>(smem + 2 * S::tile);
  bf16* v_s = reinterpret_cast<bf16*>(smem + 3 * S::tile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* f_s = reinterpret_cast<float*>(smem + 4 * S::tile) + warp * 16 * FLD;
  bf16* p_s = reinterpret_cast<bf16*>(smem + 4 * S::tile + S::fbuf) + warp * 16 * PLD;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * S::tile + S::fbuf + S::pbuf);
  float* dl_s = lse_s + 64;

  const int j0 = blockIdx.x * 64, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int jw = j0 + warp * 16;                       // this warp's first key
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  stage64<D, LD>(k_s, k + kv_off, j0, Sk);
  stage64<D, LD>(v_s, v + kv_off, j0, Sk);

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wm::fill_fragment(dk_acc[n], 0.f);
    wm::fill_fragment(dv_acc[n], 0.f);
  }

  int i_begin, i_end;
  mask.row_range(j0, min(j0 + 64, Sk), Sq, &i_begin, &i_end);
  i_end = min(i_end, Sq);
  for (int g = 0; g < G; ++g) {
    const size_t q_row0 = ((size_t)b * Hq + hk * G + g) * Sq;
    for (int i0 = (i_begin / 64) * 64; i0 < i_end; i0 += 64) {
      __syncthreads();
      stage64<D, LD>(q_s, q + q_row0 * D, i0, Sq);
      stage64<D, LD>(do_s, dout + q_row0 * D, i0, Sq);
      if (threadIdx.x < 64) {
        const bool in = i0 + threadIdx.x < Sq;
        lse_s[threadIdx.x] = in ? lse[q_row0 + i0 + threadIdx.x] : 0.f;
        dl_s[threadIdx.x] = in ? delta[q_row0 + i0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      // P^T (16 keys x 64 queries) = exp(K Q^T * scale - lse), masked; the
      // lane keeps its 32 entries in f32 for dS
      tc_scores<D, LD, FLD>(f_s, k_s + warp * 16 * LD, q_s);
      __syncwarp();
      float p[16][2];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h, i = i0 + c, j = jw + r;
          const bool ok = i < Sq && j < Sk && mask.live(i, j);
          p[r][h] = ok ? expf(f_s[r * FLD + c] * scale - lse_s[c]) : 0.f;
          p_s[r * PLD + c] = __float2bfloat16(p[r][h]);
        }
      }
      __syncwarp();
      tc_accumulate<D, LD, PLD>(dv_acc, p_s, do_s);        // dV += P^T dO
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in place of P^T
      tc_scores<D, LD, FLD>(f_s, v_s + warp * 16 * LD, do_s);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h;
          p_s[r * PLD + c] = __float2bfloat16(p[r][h] * (f_s[r * FLD + c] - dl_s[c]));
        }
      }
      __syncwarp();
      tc_accumulate<D, LD, PLD>(dk_acc, p_s, q_s);         // dK += dS^T Q
      __syncwarp();
    }
  }
  __syncthreads();   // every warp is done with q_s / do_s: reuse them for staging
  float* o_s = reinterpret_cast<float*>(smem) + warp * 16 * OLD;
  tc_store_rows<D, OLD>(dk + kv_off, dk_acc, o_s, jw, Sk, scale, nullptr);
  __syncwarp();
  tc_store_rows<D, OLD>(dv + kv_off, dv_acc, o_s, jw, Sk, 1.f, nullptr);
}

// For the dQ kernel's 16 query rows against keys [j0, j0 + 64): P = exp(Q K^T
// * scale - lse), masked, into f32 registers (rows r, columns lane and
// lane + 32), and dP = dO V^T into f_s.
template <int D, int LD, int FLD>
__device__ __forceinline__ void dq_tile_p_dp(float (&p)[16][2], float* f_s,
                                             const bf16* q_rows, const bf16* do_rows,
                                             const bf16* k_s, const bf16* v_s,
                                             const float* lse_rows, int iw, int j0, int Sq,
                                             int Sk, const Mask& mask, float scale) {
  const int lane = threadIdx.x % 32;
  tc_scores<D, LD, FLD>(f_s, q_rows, k_s);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int i = iw + r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h, j = j0 + c;
      const bool ok = i < Sq && j < Sk && mask.live(i, j);
      p[r][h] = ok ? expf(f_s[r * FLD + c] * scale - lse_rows[r]) : 0.f;
    }
  }
  __syncwarp();
  tc_scores<D, LD, FLD>(f_s, do_rows, v_s);
  __syncwarp();
}

// One block per (64 query rows, query head, batch row).  Pass 1 takes
// delta = sum_j P dP for its rows and writes it; pass 2 accumulates
// dQ = scale * dS K with dS = P (dP - delta).
template <int D>
__global__ void __launch_bounds__(128) fa_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk,
    Mask mask, float scale) {
  using S = TcSmem<D>;
  constexpr int LD = S::LD, FLD = S::FLD, PLD = S::PLD, OLD = S::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = reinterpret_cast<bf16*>(smem + S::tile);
  bf16* k_s = reinterpret_cast<bf16*>(smem + 2 * S::tile);
  bf16* v_s = reinterpret_cast<bf16*>(smem + 3 * S::tile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* f_s = reinterpret_cast<float*>(smem + 4 * S::tile) + warp * 16 * FLD;
  bf16* p_s = reinterpret_cast<bf16*>(smem + 4 * S::tile + S::fbuf) + warp * 16 * PLD;
  float* lse_s = reinterpret_cast<float*>(smem + 4 * S::tile + S::fbuf + S::pbuf);
  float* dl_s = lse_s + 64;

  const int i0 = blockIdx.x * 64, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int iw = i0 + warp * 16;
  const size_t q_row0 = ((size_t)b * Hq + hq) * Sq;
  const size_t kv_off = ((size_t)b * Hkv + hk) * (size_t)Sk * D;
  stage64<D, LD>(q_s, q + q_row0 * D, i0, Sq);
  stage64<D, LD>(do_s, dout + q_row0 * D, i0, Sq);
  if (threadIdx.x < 64)
    lse_s[threadIdx.x] = i0 + threadIdx.x < Sq ? lse[q_row0 + i0 + threadIdx.x] : 0.f;

  int k_begin, k_end;
  mask.key_range(i0, min(i0 + 64, Sq), Sk, &k_begin, &k_end);
  const int j_first = (k_begin / 64) * 64;

  float p[16][2];

  // pass 1: delta = sum_j P dP, per row
  float part[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) part[r] = 0.f;
  for (int j0 = j_first; j0 < k_end; j0 += 64) {
    __syncthreads();
    stage64<D, LD>(k_s, k + kv_off, j0, Sk);
    stage64<D, LD>(v_s, v + kv_off, j0, Sk);
    __syncthreads();
    dq_tile_p_dp<D, LD, FLD>(p, f_s, q_s + warp * 16 * LD, do_s + warp * 16 * LD, k_s,
                             v_s, lse_s + warp * 16, iw, j0, Sq, Sk, mask, scale);
#pragma unroll
    for (int r = 0; r < 16; ++r)
      part[r] += p[r][0] * f_s[r * FLD + lane] + p[r][1] * f_s[r * FLD + lane + 32];
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float dl = warp_sum(part[r]);
    if (lane == 0) {
      dl_s[warp * 16 + r] = dl;
      if (iw + r < Sq) delta[q_row0 + iw + r] = dl;
    }
  }
  __syncwarp();

  // pass 2: dQ += dS K with dS = P (dP - delta)
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wm::fill_fragment(acc[n], 0.f);
  for (int j0 = j_first; j0 < k_end; j0 += 64) {
    __syncthreads();
    stage64<D, LD>(k_s, k + kv_off, j0, Sk);
    stage64<D, LD>(v_s, v + kv_off, j0, Sk);
    __syncthreads();
    dq_tile_p_dp<D, LD, FLD>(p, f_s, q_s + warp * 16 * LD, do_s + warp * 16 * LD, k_s,
                             v_s, lse_s + warp * 16, iw, j0, Sq, Sk, mask, scale);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float dl = dl_s[warp * 16 + r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        p_s[r * PLD + c] = __float2bfloat16(p[r][h] * (f_s[r * FLD + c] - dl));
      }
    }
    __syncwarp();
    tc_accumulate<D, LD, PLD>(acc, p_s, k_s);
  }
  __syncthreads();   // every warp is done with k_s / v_s: reuse them for staging
  float* o_s = reinterpret_cast<float*>(smem + 2 * S::tile) + warp * 16 * OLD;
  tc_store_rows<D, OLD>(dq + q_row0 * D, acc, o_s, iw, Sq, scale, nullptr);
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

template <typename T, int D>
cudaError_t fwd_t(const void* q, const void* k, const void* v, void* out, void* lse,
                  int B, int Hq, int Hkv, int Sq, int Sk, Mask mask, float scale,
                  cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = TcSmem<D>::bytes;
    static bool configured = false;
    const cudaError_t e = allow_smem(fa_fwd_tc_kernel<D>, smem, &configured);
    if (e != cudaSuccess) return e;
    fa_fwd_tc_kernel<D><<<dim3((Sq + 63) / 64, Hq, B), 128, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse),
        Hq, Hkv, Sq, Sk, mask, scale);
  } else {
    fa_fwd_kernel<T, D><<<dim3((Sq + F_BQ - 1) / F_BQ, Hq, B), F_NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), static_cast<float*>(lse), Hq, Hkv, Sq, Sk, mask, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
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
    const size_t smem = TcSmem<D>::bytes;
    static bool conf_dkdv = false, conf_dq = false;
    e = allow_smem(fa_bwd_dkdv_tc_kernel<D>, smem, &conf_dkdv);
    if (e == cudaSuccess) e = allow_smem(fa_bwd_dq_tc_kernel<D>, smem, &conf_dq);
    if (e != cudaSuccess) return e;
    fa_bwd_dq_tc_kernel<D><<<dim3((Sq + 63) / 64, Hq, B), 128, smem, stream>>>(
        q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, mask, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    fa_bwd_dkdv_tc_kernel<D><<<dim3((Sk + 63) / 64, Hkv, B), 128, smem, stream>>>(
        q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv,
        Sq, Sk, mask, scale);
  } else {
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

bool bad_shape(int B, int Hq, int Hkv, int Sq, int Sk, int D, int dtype, int kind,
               int window, int chunk) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
         (D != 16 && D != 32 && D != 64 && D != 128) || (dtype != 0 && dtype != 1) ||
         kind < 0 || kind > 3 || (kind == 1 && window <= 0) ||
         (kind == 2 && chunk <= 0) || Hq > 65535 || B > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; kind: 0 causal, 1 sliding, 2 chunked,
// 3 bidirectional.  Writes out (B, Hq, Sq, D) and lse (B, Hq, Sq) f32.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int Hq, int Hkv,
                               int Sq, int Sk, int D, int dtype, int kind,
                               int window, int chunk, int q_offset, float scale,
                               void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Sk, D, dtype, kind, window, chunk))
    return (int)cudaErrorInvalidValue;
  const Mask mask{kind, window, chunk, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FA_FWD(TT, DD) \
  e = fwd_t<TT, DD>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, mask, scale, s)
#define REPRO_FA_FWD_D(TT)                  \
  switch (D) {                              \
    case 16: REPRO_FA_FWD(TT, 16); break;   \
    case 32: REPRO_FA_FWD(TT, 32); break;   \
    case 64: REPRO_FA_FWD(TT, 64); break;   \
    case 128: REPRO_FA_FWD(TT, 128); break; \
  }
  if (dtype == 0) {
    REPRO_FA_FWD_D(float)
  } else {
    REPRO_FA_FWD_D(__nv_bfloat16)
  }
#undef REPRO_FA_FWD_D
#undef REPRO_FA_FWD
  return (int)e;
}

// Gradients of the forward above: dq (B, Hq, Sq, D), dk and dv (B, Hkv, Sk,
// D) in the operands' dtype, from q, k, v, the forward's out and lse, and
// dout.  delta is (B, Hq, Sq) f32 scratch.  Three launches on one stream.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout, const void* lse,
                               void* delta, void* dq, void* dk, void* dv, int B,
                               int Hq, int Hkv, int Sq, int Sk, int D, int dtype,
                               int kind, int window, int chunk, int q_offset,
                               float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Sq, Sk, D, dtype, kind, window, chunk))
    return (int)cudaErrorInvalidValue;
  const Mask mask{kind, window, chunk, q_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
#define REPRO_FA_BWD(TT, DD)                                                     \
  e = bwd_t<TT, DD>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, \
                    Sk, mask, scale, s)
#define REPRO_FA_BWD_D(TT)                  \
  switch (D) {                              \
    case 16: REPRO_FA_BWD(TT, 16); break;   \
    case 32: REPRO_FA_BWD(TT, 32); break;   \
    case 64: REPRO_FA_BWD(TT, 64); break;   \
    case 128: REPRO_FA_BWD(TT, 128); break; \
  }
  if (dtype == 0) {
    REPRO_FA_BWD_D(float)
  } else {
    REPRO_FA_BWD_D(__nv_bfloat16)
  }
#undef REPRO_FA_BWD_D
#undef REPRO_FA_BWD
  return (int)e;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
