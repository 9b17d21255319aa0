// Chunked-prefill GQA attention on explicit positions, reading the keys
// from two sources: the prior KV cache and the chunk's own keys.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:
// flash_prefill (body _prefill_kernel).
//
// What bounds it on an H100: both bytes and flops.  Per (row, query head)
// it reads every live cache key once per query tile and does 4·D flops per
// live (query, key) pair; with a 256-token chunk against a 2048-slot cache
// the flops dominate once the cache is full.  This first version computes
// in f32 on the CUDA cores (67 TFLOP/s), not the tensor cores, and re-reads
// each K/V tile once per query tile and query head (L2 absorbs most of it).
//
// What the design does about it:
//  * one thread block per (query tile of BQ rows, query head, batch row);
//  * it reads the BQ query positions and each tile's BK key positions
//    first and skips a tile where no (q, k) pair is live — the counterpart
//    of pl.when(jnp.any(mask)) — so the unwritten tail of the cache is
//    neither read nor computed; holes inside a live tile are zero-filled
//    instead of read;
//  * key index j < Sc reads the cache (B, Hkv, Sc, D) and j >= Sc reads the
//    chunk (B, Hkv, Sn, D): the caller no longer concatenates cache and
//    chunk, which cost one cache-sized copy per layer per chunk;
//  * the mask is the reference's: q_pos >= k_pos, k_pos >= 0, plus
//    q_pos - k_pos < window (sliding) or the same q_pos // chunk (chunked);
//  * the online softmax runs in f32; out = acc / max(l, 1e-30), so a query
//    row with no live key comes out 0 (the plain version gives mean(V);
//    such rows are padding and both sides discard them).
//
// Plain C interface (loaded with ctypes): prefill_attention_launch returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
    const T* __restrict__ kc,        // (B, Hkv, Sc, D)  prior cache
    const T* __restrict__ vc,
    const T* __restrict__ kn,        // (B, Hkv, Sn, D)  chunk keys
    const T* __restrict__ vn,
    const int* __restrict__ q_pos,   // (B, Sq)
    const int* __restrict__ k_pos,   // (B, Sc + Sn)
    T* __restrict__ out,             // (B, Hq, Sq, D)
    int Hq, int Hkv, int Sq, int Sc, int Sn, int kind, int window, int chunk,
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
  const T* kcb = kc + ((size_t)b * Hkv + hk) * (size_t)Sc * D;
  const T* vcb = vc + ((size_t)b * Hkv + hk) * (size_t)Sc * D;
  const T* knb = kn + ((size_t)b * Hkv + hk) * (size_t)Sn * D;
  const T* vnb = vn + ((size_t)b * Hkv + hk) * (size_t)Sn * D;

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
              int B, int Hq, int Hkv, int Sq, int Sc, int Sn, int D, int kind,
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
                                                 kp_, o_, Hq, Hkv, Sq, Sc, Sn, \
                                                 kind, window, chunk, scale)
  switch (D) {
    case 16: REPRO_PREFILL_LAUNCH(16); break;
    case 32: REPRO_PREFILL_LAUNCH(32); break;
    case 64: REPRO_PREFILL_LAUNCH(64); break;
    case 128: REPRO_PREFILL_LAUNCH(128); break;
  }
#undef REPRO_PREFILL_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; kind: 0 causal, 1 sliding, 2 chunked.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take.
int prefill_attention_launch(const void* q, const void* kc, const void* vc,
                             const void* kn, const void* vn, const void* q_pos,
                             const void* k_pos, void* out, int B, int Hq,
                             int Hkv, int Sq, int Sc, int Sn, int D, int dtype,
                             int kind, int window, int chunk, float scale,
                             void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sc < 0 || Sn < 0 ||
      Sc + Sn <= 0 || (D != 16 && D != 32 && D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || kind < 0 || kind > 2 ||
      (kind == 2 && chunk <= 0) || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_t<float>(q, kc, vc, kn, vn, q_pos, k_pos, out, B, Hq, Hkv, Sq, Sc, Sn,
                    D, kind, window, chunk, scale, s);
  else
    launch_t<__nv_bfloat16>(q, kc, vc, kn, vn, q_pos, k_pos, out, B, Hq, Hkv, Sq,
                            Sc, Sn, D, kind, window, chunk, scale, s);
  return (int)cudaGetLastError();
}

const char* prefill_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
