// Mamba-2 chunked SSD scan (state-space duality), carrying the recurrent
// state in and out.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py: ssd_scan (body
// _ssd_kernel).  Unlike it, this kernel takes an initial state and returns
// the final one, so it also carries serving prefill (the reference runs
// its jnp oracle there), and it takes any T: the last chunk may be ragged.
//
// Per (batch row b, head h), over positions t with a_t = A_h · dt_t:
//   h_t = exp(a_t) · h_{t-1} + dt_t · x_t ⊗ B_t        (P x N, float32)
//   y_t = h_t · C_t                                     (P)
// evaluated chunk by chunk, Q positions at a time, with cum the inclusive
// cumsum of a inside the chunk:
//   y_i  = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) h·C_i
//   h   <- exp(cum_end) h + Σ_j exp(cum_end - cum_j) dt_j x_j ⊗ B_j
//
// What bounds it on an H100: bytes, at the serving shape.  One launch at
// (B 8, T 256, H 48, P 64, N 128) in bf16 reads x, the f32 state, dt, B
// and C and writes y and the state — about 52 MB, 15 µs at 3.35 TB/s —
// and does ~5 GFLOP of products (5 µs on the tensor cores).  This first
// version runs the products as f32 FMAs on the CUDA cores, whose floor
// for the same work is ~80 µs: the kernel is compute-bound in practice.
//
// What the design does about it:
//  * one block per (row, head) — B·H blocks, 384 at the mamba2-780m
//    serving shape — walks its chunks in order with the (P, N) state in
//    shared memory, so the state crosses device memory once in and once
//    out per launch, and nothing but x, dt, B, C and y moves per chunk;
//  * a chunk of Q = 32 positions keeps the block's tiles at ~82 KB of
//    shared memory (two blocks per SM) and the quadratic intra-chunk
//    work small (Q·(N + P) per position against 2·P·N for the state);
//  * every product reads 16-byte float4 vectors along its reduction axis
//    out of shared memory, with row strides padded so the eight lanes of
//    a quarter-warp hit distinct banks; x·dt is stored transposed (P rows
//    of Q) so that both of its products read it along that axis;
//  * positions past T are loaded as zeros with dt = 0: they add nothing
//    and decay nothing, so a ragged last chunk, T < Q and T = 1 need no
//    other case;
//  * a row whose dt is 0 everywhere keeps its state bit for bit: every
//    decay is exp(0) = 1 and every added term is an exact 0, and the state
//    update is one fmaf(h, 1, 0) per element;
//  * each block reads its whole (P, N) slice of the initial state before
//    it writes any of the final state, so the two may be one buffer (the
//    serving cache, updated in place).
//
// Plain C interface (loaded with ctypes): ssd_scan_launch returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int Q = 32;          // positions per chunk: one warp, one lane each
constexpr int QS = Q + 4;      // row stride of the transposed x·dt and of M

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int P, int N>
struct Smem {
  static constexpr int NS = N + 4;              // row stride of B, C and the state
  static constexpr int XT = 0;                  // [P][QS]  x·dt, transposed
  static constexpr int BS = XT + P * QS;        // [Q][NS]  B
  static constexpr int CS = BS + Q * NS;        // [Q][NS]  C
  static constexpr int HS = CS + Q * NS;        // [P][NS]  state
  static constexpr int MS = HS + P * NS;        // [Q][QS]  (C·Bᵀ) ∘ L
  static constexpr int CUM = MS + Q * QS;       // [Q] cum, [Q] exp(cum), [Q] exp(cum_end - cum)
  static constexpr int FLOATS = CUM + 3 * Q;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename E, int P, int N>
__global__ void __launch_bounds__(NT, 2) ssd_scan_kernel(
    const E* __restrict__ x, long long sxb, long long sxt, long long sxh,      // x[b,t,h,p]
    const float* __restrict__ dt, long long sdb, long long sdt, long long sdh, // dt[b,t,h]
    const float* __restrict__ A,                                               // (H,)
    const E* __restrict__ Bm, long long sbb, long long sbt,                    // B[b,t,n]
    const E* __restrict__ Cm, long long scb, long long sct,                    // C[b,t,n]
    const float* h0,       // (B, H, P, N) or null (zero state); may alias h_out
    E* __restrict__ y,     // (B, T, H, P)
    float* h_out,          // (B, H, P, N) or null (state not returned)
    int H, int T) {
  using S = Smem<P, N>;
  constexpr int NS = S::NS;
  static_assert(NT % P == 0 && (Q * P) % NT == 0 && (Q * Q) % NT == 0, "tile shape");
  static_assert(N % 4 == 0 && NT % (N / 4) == 0, "state tile shape");
  extern __shared__ __align__(16) float smem[];
  float* xt = smem + S::XT;
  float* bs = smem + S::BS;
  float* cs = smem + S::CS;
  float* hs = smem + S::HS;
  float* ms = smem + S::MS;
  float* cum = smem + S::CUM;
  float* ecum = cum + Q;
  float* dte = ecum + Q;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float Ah = A[h];
  const E* xb = x + b * sxb + h * sxh;
  const float* db = dt + b * sdb + h * sdh;
  const E* bb = Bm + b * sbb;
  const E* cb = Cm + b * scb;
  const size_t hoff = ((size_t)b * H + h) * P * N;

  for (int u = tid; u < P * N; u += NT)
    hs[(u / N) * NS + u % N] = h0 ? h0[hoff + u] : 0.f;

  for (int c0 = 0; c0 < T; c0 += Q) {
    __syncthreads();   // the previous chunk is done with every tile

    // -- load the chunk; positions past T are zeros with dt = 0 ----------
    if (tid < Q) {
      const int t = c0 + tid;
      float c = Ah * (t < T ? db[t * sdt] : 0.f);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {             // inclusive warp scan
        const float v = __shfl_up_sync(0xffffffffu, c, o);
        if (tid >= o) c += v;
      }
      const float cend = __shfl_sync(0xffffffffu, c, Q - 1);
      cum[tid] = c;
      ecum[tid] = expf(c);
      dte[tid] = expf(cend - c);
    }
    for (int u = tid; u < Q * P; u += NT) {
      const int i = u / P, p = u % P, t = c0 + i;
      xt[p * QS + i] = t < T ? to_f(xb[t * sxt + p]) * db[t * sdt] : 0.f;
    }
    for (int u = tid; u < Q * N; u += NT) {
      const int i = u / N, n = u % N, t = c0 + i;
      const bool live = t < T;
      bs[i * NS + n] = live ? to_f(bb[t * sbt + n]) : 0.f;
      cs[i * NS + n] = live ? to_f(cb[t * sct + n]) : 0.f;
    }
    __syncthreads();

    // -- M = (C·Bᵀ) ∘ L, L_ij = exp(cum_i - cum_j) for j <= i, else 0 ----
    {
      constexpr int R = Q * Q / NT;
      const int j = tid % Q, i0 = tid / Q;
      float g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) g[r] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 bv = ld4(bs + j * NS + n);
#pragma unroll
        for (int r = 0; r < R; ++r)
          g[r] = dot4(g[r], ld4(cs + (i0 + r * (NT / Q)) * NS + n), bv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r * (NT / Q);
        const bool on = j <= i;
        // the exponent is zeroed off the triangle first: exp never sees a
        // positive cum_i - cum_j
        const float delta = on ? cum[i] - cum[j] : 0.f;
        ms[i * QS + j] = on ? g[r] * expf(delta) : 0.f;
      }
    }
    __syncthreads();

    // -- y_i = Σ_j M_ij x_j dt_j + exp(cum_i) · h·C_i ----------------------
    {
      constexpr int R = Q * P / NT;
      constexpr int IS = NT / P;
      const int p = tid % P, i0 = tid / P;
      float yi[R], ye[R];
#pragma unroll
      for (int r = 0; r < R; ++r) yi[r] = ye[r] = 0.f;
#pragma unroll 2
      for (int j = 0; j < Q; j += 4) {
        const float4 xv = ld4(xt + p * QS + j);
#pragma unroll
        for (int r = 0; r < R; ++r) yi[r] = dot4(yi[r], ld4(ms + (i0 + r * IS) * QS + j), xv);
      }
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 hv = ld4(hs + p * NS + n);
#pragma unroll
        for (int r = 0; r < R; ++r) ye[r] = dot4(ye[r], ld4(cs + (i0 + r * IS) * NS + n), hv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r * IS, t = c0 + i;
        if (t < T) y[(((size_t)b * T + t) * H + h) * P + p] = from_f<E>(yi[r] + ecum[i] * ye[r]);
      }
    }
    __syncthreads();   // the state is read above and rewritten below

    // -- h <- exp(cum_end) h + Σ_j exp(cum_end - cum_j) dt_j x_j ⊗ B_j -------
    {
      constexpr int NG = N / 4;                 // float4 columns of the state
      constexpr int PSTEP = NT / NG;
      constexpr int R = (P * NG + NT - 1) / NT;
      const int nq = tid % NG, pb = tid / NG;
      if (pb < P) {
        const float dec = ecum[Q - 1];          // exp(cum_end)
        float4 acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int j = 0; j < Q; j += 4) {
          const float4 dv = ld4(dte + j);
          const float4 b0 = ld4(bs + (j + 0) * NS + 4 * nq);
          const float4 b1 = ld4(bs + (j + 1) * NS + 4 * nq);
          const float4 b2 = ld4(bs + (j + 2) * NS + 4 * nq);
          const float4 b3 = ld4(bs + (j + 3) * NS + 4 * nq);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 xv = ld4(xt + (pb + r * PSTEP) * QS + j);
            const float s0 = xv.x * dv.x, s1 = xv.y * dv.y, s2 = xv.z * dv.z, s3 = xv.w * dv.w;
            acc[r].x = fmaf(s3, b3.x, fmaf(s2, b2.x, fmaf(s1, b1.x, fmaf(s0, b0.x, acc[r].x))));
            acc[r].y = fmaf(s3, b3.y, fmaf(s2, b2.y, fmaf(s1, b1.y, fmaf(s0, b0.y, acc[r].y))));
            acc[r].z = fmaf(s3, b3.z, fmaf(s2, b2.z, fmaf(s1, b1.z, fmaf(s0, b0.z, acc[r].z))));
            acc[r].w = fmaf(s3, b3.w, fmaf(s2, b2.w, fmaf(s1, b1.w, fmaf(s0, b0.w, acc[r].w))));
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float4* hp = reinterpret_cast<float4*>(hs + (pb + r * PSTEP) * NS + 4 * nq);
          float4 hv = *hp;
          hv.x = fmaf(hv.x, dec, acc[r].x);
          hv.y = fmaf(hv.y, dec, acc[r].y);
          hv.z = fmaf(hv.z, dec, acc[r].z);
          hv.w = fmaf(hv.w, dec, acc[r].w);
          *hp = hv;
        }
      }
    }
  }
  if (h_out) {
    __syncthreads();
    for (int u = tid; u < P * N; u += NT) h_out[hoff + u] = hs[(u / N) * NS + u % N];
  }
}

template <typename E, int P, int N>
int launch_pn(const void* x, long long sxb, long long sxt, long long sxh, const void* dt,
              long long sdb, long long sdt, long long sdh, const void* A, const void* Bm,
              long long sbb, long long sbt, const void* Cm, long long scb, long long sct,
              const void* h0, void* y, void* h_out, int Bsz, int T, int H,
              cudaStream_t stream) {
  using S = Smem<P, N>;
  auto kernel = ssd_scan_kernel<E, P, N>;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kernel<<<dim3(H, Bsz), NT, S::BYTES, stream>>>(
      static_cast<const E*>(x), sxb, sxt, sxh, static_cast<const float*>(dt), sdb, sdt,
      sdh, static_cast<const float*>(A), static_cast<const E*>(Bm), sbb, sbt,
      static_cast<const E*>(Cm), scb, sct, static_cast<const float*>(h0),
      static_cast<E*>(y), static_cast<float*>(h_out), H, T);
  return (int)cudaGetLastError();
}

template <typename E, int P>
int launch_p(int N, const void* x, long long sxb, long long sxt, long long sxh,
             const void* dt, long long sdb, long long sdt, long long sdh, const void* A,
             const void* Bm, long long sbb, long long sbt, const void* Cm, long long scb,
             long long sct, const void* h0, void* y, void* h_out, int Bsz, int T, int H,
             cudaStream_t st) {
#define SSD_CASE(NN)                                                                     \
  case NN:                                                                               \
    return launch_pn<E, P, NN>(x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb, sbt, Cm, \
                               scb, sct, h0, y, h_out, Bsz, T, H, st);
  switch (N) {
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
  }
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int launch_t(int P, int N, const void* x, long long sxb, long long sxt, long long sxh,
             const void* dt, long long sdb, long long sdt, long long sdh, const void* A,
             const void* Bm, long long sbb, long long sbt, const void* Cm, long long scb,
             long long sct, const void* h0, void* y, void* h_out, int Bsz, int T, int H,
             cudaStream_t st) {
  switch (P) {
    case 32:
      return launch_p<E, 32>(N, x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb, sbt, Cm,
                             scb, sct, h0, y, h_out, Bsz, T, H, st);
    case 64:
      return launch_p<E, 64>(N, x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb, sbt, Cm,
                             scb, sct, h0, y, h_out, Bsz, T, H, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, B, C: dtype 0 = float32, 1 = bfloat16, with the strides given (in
// elements; the last dim is contiguous).  dt and A are float32.  h0 may be
// null (zero initial state), h_out null (state not returned), and the two
// may be the same buffer.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int ssd_scan_launch(const void* x, long long sxb, long long sxt, long long sxh,
                    const void* dt, long long sdb, long long sdt, long long sdh,
                    const void* A, const void* Bm, long long sbb, long long sbt,
                    const void* Cm, long long scb, long long sct, const void* h0,
                    void* y, void* h_out, int Bsz, int T, int H, int P, int N, int dtype,
                    void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || T < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(P, N, x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb, sbt, Cm,
                           scb, sct, h0, y, h_out, Bsz, T, H, st);
  return launch_t<__nv_bfloat16>(P, N, x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb, sbt,
                                 Cm, scb, sct, h0, y, h_out, Bsz, T, H, st);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
