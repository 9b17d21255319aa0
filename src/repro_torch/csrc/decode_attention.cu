// Single-token GQA decode attention against a padded KV cache.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py:
// flash_decode (body _decode_kernel).
//
// What bounds it on an H100: bytes.  Each (batch row, KV head) reads
// lengths[b] keys and values of D elements once and does 4·G·D flops per
// key, about G flops per byte in bf16 — far below the ~295 flops/byte at
// which the tensor cores would become the limit.  The only lever is to
// read the live part of the cache once, with enough loads in flight.
//
// What the design does about it:
//  * the G = Hq/Hkv query rows of a KV head are loaded once, scaled, into
//    shared memory as f32, and every K/V tile staged in shared memory is
//    read once for all G rows — the point of the TPU kernel;
//  * B·Hkv alone is too few blocks for 132 SMs (32 at yi-6b with 8
//    slots), so the live keys of each row are split across NS blocks
//    (grid Hkv x B x NS), each running the online softmax over its share
//    of tiles; a second kernel combines the NS partial (m, l, acc);
//  * the cache is walked in tiles of BK keys up to lengths[b] and no
//    further (the counterpart of pl.when(k_lo < length)); each thread
//    issues all of a tile's 16-byte loads before storing any, and the next
//    tile's loads are in flight while the current tile is computed;
//  * the ragged tail is masked inside the tile (keys at or past the length
//    are neither read nor counted), so Smax needs no multiple of BK;
//  * m, l and acc stay in f32; out = acc / max(l, 1e-30).
//
// Plain C interface (loaded with ctypes): decode_attention_num_splits
// sizes the partials the caller allocates; decode_attention_launch runs
// both kernels and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;         // threads per block
constexpr int MAXG = 16;        // largest query-group size G supported
constexpr float NEG_INF = -1e30f;

template <typename T> struct Tile {
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;   // keys per tile
};

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

// Pass 1: the online softmax over one split of one (row, KV head)'s tiles.
template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q,          // (B, Hq, D)
    const T* __restrict__ k,          // (B, Hkv, Smax, D)
    const T* __restrict__ v,          // (B, Hkv, Smax, D)
    const int* __restrict__ lengths,  // (B,)
    float* __restrict__ part_acc,     // (B, Hkv, NS, G, D)
    float* __restrict__ part_ml,      // (B, Hkv, NS, G, 2): m, l
    int Hq, int Hkv, int Smax, int NS, float scale) {
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

  __shared__ float q_s[MAXG][D];
  __shared__ T k_s[BK][KP];
  __shared__ T v_s[BK][D];
  __shared__ float p_s[MAXG][BK];
  __shared__ float m_s[MAXG], l_s[MAXG], c_s[MAXG];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int L = min(max(lengths[b], 0), Smax);
  const int ntiles = (L + BK - 1) / BK;
  const int per = (ntiles + NS - 1) / NS;            // tiles per split, this row
  const int t_lo = s * per;
  const int t_hi = min(ntiles, t_lo + per);

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  const T* kb = k + ((size_t)b * Hkv + h) * (size_t)Smax * D;
  const T* vb = v + ((size_t)b * Hkv + h) * (size_t)Smax * D;

  for (int e = tid; e < G * D; e += NT) q_s[e / D][e % D] = to_f(qb[e]) * scale;
  if (tid < MAXG) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int d = tid % D;             // PV phase: this thread's column ...
  const int cg = tid / D;            // ... and row group
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
      const int g = cg + r * CGROUPS;
      if (g < G) acc[r] *= c_s[g];
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float vj = to_f(v_s[j][d]);
#pragma unroll
      for (int r = 0; r < CROWS; ++r) {
        const int g = cg + r * CGROUPS;
        if (g < G) acc[r] += p_s[g][j] * vj;
      }
    }
    __syncthreads();
  }

  // partials of this split; an empty split leaves m = NEG_INF, l = acc = 0
  const size_t base = (((size_t)b * Hkv + h) * NS + s) * G;
#pragma unroll
  for (int r = 0; r < CROWS; ++r) {
    const int g = cg + r * CGROUPS;
    if (g < G) part_acc[(base + g) * D + d] = acc[r];
  }
  if (tid < G) {
    part_ml[(base + tid) * 2] = m_s[tid];
    part_ml[(base + tid) * 2 + 1] = l_s[tid];
  }
}

// Pass 2: one block per (query head, row), one thread per column.
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int Hq, int Hkv, int NS) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = Hq / Hkv, h = hq / G, g = hq % G;
  const size_t base = ((size_t)b * Hkv + h) * NS;
  float m = NEG_INF;
  for (int s = 0; s < NS; ++s) m = fmaxf(m, part_ml[((base + s) * G + g) * 2]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < NS; ++s) {
    const size_t i = (base + s) * G + g;
    const float w = expf(part_ml[i * 2] - m);
    l += w * part_ml[i * 2 + 1];
    a += w * part_acc[i * D + d];
  }
  out[((size_t)b * Hq + hq) * D + d] = from_f<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int D>
void launch_d(const void* q, const void* k, const void* v, const void* lengths,
              void* out, float* pacc, float* pml, int B, int Hq, int Hkv,
              int Smax, int NS, float scale, cudaStream_t stream) {
  decode_split_kernel<T, D><<<dim3(Hkv, B, NS), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), pacc, pml,
      Hq, Hkv, Smax, NS, scale);
  decode_combine_kernel<T, D><<<dim3(Hq, B), D, 0, stream>>>(
      pacc, pml, static_cast<T*>(out), Hq, Hkv, NS);
}

template <typename T>
void launch_t(const void* q, const void* k, const void* v, const void* lengths,
              void* out, float* pacc, float* pml, int B, int Hq, int Hkv,
              int Smax, int D, int NS, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: launch_d<T, 16>(q, k, v, lengths, out, pacc, pml, B, Hq, Hkv, Smax, NS, scale, stream); break;
    case 32: launch_d<T, 32>(q, k, v, lengths, out, pacc, pml, B, Hq, Hkv, Smax, NS, scale, stream); break;
    case 64: launch_d<T, 64>(q, k, v, lengths, out, pacc, pml, B, Hq, Hkv, Smax, NS, scale, stream); break;
    case 128: launch_d<T, 128>(q, k, v, lengths, out, pacc, pml, B, Hq, Hkv, Smax, NS, scale, stream); break;
  }
}

}  // namespace

extern "C" {

// How many blocks share one (row, KV head): enough for two blocks per SM
// of the current device, at most one tile of BK keys each.  The caller
// allocates partials of (B, Hkv, NS, G, D) and (B, Hkv, NS, G, 2) floats.
int decode_attention_num_splits(int B, int Hkv, int Smax, int dtype) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int bk = dtype == 1 ? Tile<__nv_bfloat16>::BK : Tile<float>::BK;
  const int rows = B * Hkv > 0 ? B * Hkv : 1;
  int ns = (2 * sms + rows - 1) / rows;
  const int max_ns = (Smax + bk - 1) / bk;
  if (ns > max_ns) ns = max_ns;
  return ns < 1 ? 1 : ns;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape the kernel does not take.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* part_acc,
                            void* part_ml, int B, int Hq, int Hkv, int Smax,
                            int D, int NS, int dtype, float scale,
                            void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG || Smax <= 0 ||
      NS <= 0 || NS > 65535 || B > 65535 || Hq > 65535 ||
      (D != 16 && D != 32 && D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == 0)
    launch_t<float>(q, k, v, lengths, out, pacc, pml, B, Hq, Hkv, Smax, D, NS, scale, st);
  else
    launch_t<__nv_bfloat16>(q, k, v, lengths, out, pacc, pml, B, Hq, Hkv, Smax, D, NS, scale, st);
  return (int)cudaGetLastError();
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
