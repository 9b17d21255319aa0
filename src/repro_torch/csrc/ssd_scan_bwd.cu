// Backward of the Mamba-2 chunked SSD scan (csrc/ssd_scan.cu).
//
// Replaces the backward of the Pallas kernel src/repro/kernels/ssd_scan.py:
// ssd_scan, which the reference registers as a jax.custom_vjp whose
// backward recomputes through its jnp oracle (src/repro/kernels/ops.py:
// _pallas_ssd_bwd).  Here both directions are kernels.
//
// Per (batch row b, head h), over positions t with a_t = A_h · dt_t, the
// forward is h_t = exp(a_t) h_{t-1} + dt_t x_t ⊗ B_t, y_t = h_t · C_t.
// With g_t the gradient of the loss in h_t (dy_t ⊗ C_t plus exp(a_{t+1})
// g_{t+1}, seeded at the last position by the final state's gradient):
//   dx_t  = dt_t · g_t B_t
//   dB_t  = Σ_h dt_t · g_tᵀ x_t
//   dC_t  = Σ_h h_tᵀ dy_t
//   ddt_t = x_t · g_t B_t + A_h · da_t,   da_t = exp(a_t) ⟨h_{t-1}, g_t⟩
//   dA_h  = Σ_{b,t} dt_t · da_t,          d_init = exp(a_0) g_0
// evaluated chunk by chunk, Q = 32 positions at a time.  Inside a chunk
// with start state h_s, end-state gradient G_e, cum the inclusive cumsum of
// a and L_kj = exp(cum_k - cum_j) for k >= j (else 0):
//   g_j B_j  = Σ_k (C_k·B_j) L_kj dy_k + exp(cum_end - cum_j) G_e B_j
//   g_jᵀ x_j = Σ_k W_kj C_k + exp(cum_end - cum_j) G_eᵀ x_j,   W = (dY Xᵀ) ∘ L
//   h_iᵀ dy_i = exp(cum_i) h_sᵀ dy_i + Σ_j W_ij dt_j B_j
//   da_i     = Σ_{j<i<=k} W_kj (C_k·B_j) dt_j + Σ_{j<i} exp(cum_end - cum_j)
//              dt_j x_j·G_e B_j + Σ_{k>=i} exp(cum_k) dy_k·h_s C_k
//              + exp(cum_end) ⟨h_s, G_e⟩
// (da_i sums the four cross terms of ⟨exp(a_i) h_{i-1}, g_i⟩ with h_{i-1}
// taken strictly before i, so nothing is subtracted); across chunks
//   h_s(c+1) = exp(cum_end) h_s(c) + Σ_j exp(cum_end - cum_j) dt_j x_j ⊗ B_j
//   G_e(c-1) = exp(cum_end) G_e(c) + Σ_k exp(cum_k) dy_k ⊗ C_k.
// Every decay is exp of a number <= 0: nothing overflows.
//
// Two kernels a call:
//  1. ssd_bwd_state_kernel, one block per (head, row): walks the chunks
//     forward from the initial state, writing each chunk's start state
//     h_s, then backward from the final state's gradient, writing each
//     chunk's G_e, and leaves d_init.  Scratch of (B, H, chunks, P, N) f32
//     each (2 x 402 MB at mamba2-780m's training shape, B 4, T 2048, H 48,
//     P 64, N 128), freed when the call returns.
//  2. ssd_bwd_chunk_kernel, one block per (chunk, row): every chunk is
//     independent given h_s and G_e.  The block walks the heads in order,
//     writes each head's dx and ddt, and sums dB and dC over the heads in
//     registers, so they leave the block final: no per-head partials, no
//     atomics, and a rerun is bit-identical.  dA leaves as one partial a
//     (row, chunk, head), which the wrapper sums with torch.sum.
//
// What bounds it on an H100: as written, the CUDA cores.  The least work is
// bytes (x, dy, dx, dt, ddt, B, C, dB, dC once: ~0.16 GB at the training
// shape, 0.05 ms at 3.35 TB/s); this kernel does ~42 GFLOP of f32 FMAs
// there (0.63 ms at the 67 TFLOP/s CUDA-core peak) and writes 0.8 GB of
// chunk states and gradients that it reads back.  Moving its products to
// the tensor cores and keeping the chunk states on chip are the next
// steps; every element here is f32 (a bf16 input is widened on load, the
// outputs rounded once).
//
// Positions past T load as zeros with dt = 0 and dy = 0: they add nothing
// and decay nothing, so T needs not be a multiple of Q.  A position whose
// dt is 0 gets dx = 0 and adds nothing to dB, exactly.
//
// Plain C interface (loaded with ctypes): ssd_scan_bwd_launch returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int Q = 32;          // positions per chunk: one warp, one lane each
constexpr int QS = Q + 4;      // row stride of the Q x Q tiles and of the transposed rows
constexpr unsigned FULL = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename E> __device__ __forceinline__ E from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 fma4(float s, float4 a, float4 acc) {
  return make_float4(fmaf(s, a.x, acc.x), fmaf(s, a.y, acc.y), fmaf(s, a.z, acc.z),
                     fmaf(s, a.w, acc.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_incl_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Σ over lanes >= this one
__device__ __forceinline__ float warp_suffix_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v += u;
  }
  return v;
}

// ---------------------------------------------------------------------------
// 1. chunk start states and chunk end-state gradients
// ---------------------------------------------------------------------------

template <int P, int N>
struct StateSmem {
  static constexpr int NS = N + 4;              // row stride of rows and the state
  static constexpr int AT = 0;                  // [P][QS]  x·dt or dy, transposed
  static constexpr int RW = AT + P * QS;        // [Q][NS]  B or C rows
  static constexpr int HS = RW + Q * NS;        // [P][NS]  the state or its gradient
  static constexpr int SV = HS + P * NS;        // [Q] the scale of each position's term
  static constexpr int EC = SV + Q;             // [Q] exp(cum)
  static constexpr int FLOATS = EC + Q;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// hs <- dec · hs + Σ_j at[:, j] sv_j ⊗ rows_j, each thread a fixed set of
// state elements (the forward kernel's f32 update)
template <int P, int N>
__device__ __forceinline__ void state_update(float* hs, const float* at, const float* sv,
                                             const float* rows, float dec) {
  constexpr int NS = N + 4, NG = N / 4, PSTEP = NT / NG;
  constexpr int R = (P * NG + NT - 1) / NT;
  const int nq = threadIdx.x % NG, pb = threadIdx.x / NG;
  if (pb >= P) return;
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int j = 0; j < Q; j += 4) {
    const float4 dv = ld4(sv + j);
    const float4 b0 = ld4(rows + (j + 0) * NS + 4 * nq);
    const float4 b1 = ld4(rows + (j + 1) * NS + 4 * nq);
    const float4 b2 = ld4(rows + (j + 2) * NS + 4 * nq);
    const float4 b3 = ld4(rows + (j + 3) * NS + 4 * nq);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 xv = ld4(at + (pb + r * PSTEP) * QS + j);
      acc[r] = fma4(xv.x * dv.x, b0, acc[r]);
      acc[r] = fma4(xv.y * dv.y, b1, acc[r]);
      acc[r] = fma4(xv.z * dv.z, b2, acc[r]);
      acc[r] = fma4(xv.w * dv.w, b3, acc[r]);
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

template <typename E, int P, int N>
__global__ void __launch_bounds__(NT, 2) ssd_bwd_state_kernel(
    const E* __restrict__ x, long long sxb, long long sxt, long long sxh,      // x[b,t,h,p]
    const float* __restrict__ dt, long long sdb, long long sdt, long long sdh, // dt[b,t,h]
    const float* __restrict__ A,                                               // (H,)
    const E* __restrict__ Bm, long long sbb, long long sbt,                    // B[b,t,n]
    const E* __restrict__ Cm, long long scb, long long sct,                    // C[b,t,n]
    const E* __restrict__ dy, long long syb, long long syt, long long syh,     // dy[b,t,h,p]
    const float* __restrict__ h0,    // (B, H, P, N) or null (zero initial state)
    const float* __restrict__ dhT,   // (B, H, P, N) or null (final state unused)
    float* __restrict__ S,           // (B, H, nc, P, N): chunk start states
    float* __restrict__ G,           // (B, H, nc, P, N): chunk end-state gradients
    float* __restrict__ dh0,         // (B, H, P, N) or null
    int H, int T) {
  using L = StateSmem<P, N>;
  constexpr int NS = L::NS;
  extern __shared__ __align__(16) float smem[];
  float* at = smem + L::AT;
  float* rows = smem + L::RW;
  float* hs = smem + L::HS;
  float* sv = smem + L::SV;
  float* ec = smem + L::EC;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nc = (T + Q - 1) / Q;
  const float Ah = A[h];
  const size_t hoff = ((size_t)b * H + h) * P * N;
  const size_t soff = ((size_t)b * H + h) * (size_t)nc * P * N;

  // this chunk's decays, one position a lane: exp(cum), and into sv either
  // exp(cum_end - cum) (forward) or exp(cum) (backward)
  auto decays = [&](int c0, bool fwd) {
    const int t = c0 + tid;
    float c = Ah * (t < T ? dt[b * sdb + t * sdt + h * sdh] : 0.f);
    c = warp_incl_scan(c);
    const float cend = __shfl_sync(FULL, c, Q - 1);
    ec[tid] = expf(c);
    sv[tid] = fwd ? expf(cend - c) : expf(c);
  };

  // -- forward: the start state of every chunk -----------------------------
  for (int u = tid; u < P * N; u += NT) hs[(u / N) * NS + u % N] = h0 ? h0[hoff + u] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    __syncthreads();   // the previous update is done
    for (int u = tid; u < P * N; u += NT)
      S[soff + (size_t)c * P * N + u] = hs[(u / N) * NS + u % N];
    if (tid < Q) decays(c0, true);
    for (int u = tid; u < Q * P; u += NT) {
      const int i = u / P, p = u % P, t = c0 + i;
      at[p * QS + i] = t < T ? to_f(x[b * sxb + t * sxt + h * sxh + p]) * dt[b * sdb + t * sdt + h * sdh]
                             : 0.f;
    }
    for (int u = tid; u < Q * N; u += NT) {
      const int i = u / N, n = u % N, t = c0 + i;
      rows[i * NS + n] = t < T ? to_f(Bm[b * sbb + t * sbt + n]) : 0.f;
    }
    __syncthreads();
    state_update<P, N>(hs, at, sv, rows, ec[Q - 1]);
  }

  // -- backward: the end-state gradient of every chunk ---------------------
  __syncthreads();
  for (int u = tid; u < P * N; u += NT) hs[(u / N) * NS + u % N] = dhT ? dhT[hoff + u] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * Q;
    __syncthreads();
    for (int u = tid; u < P * N; u += NT)
      G[soff + (size_t)c * P * N + u] = hs[(u / N) * NS + u % N];
    if (tid < Q) decays(c0, false);
    for (int u = tid; u < Q * P; u += NT) {
      const int i = u / P, p = u % P, t = c0 + i;
      at[p * QS + i] = t < T ? to_f(dy[b * syb + t * syt + h * syh + p]) : 0.f;
    }
    for (int u = tid; u < Q * N; u += NT) {
      const int i = u / N, n = u % N, t = c0 + i;
      rows[i * NS + n] = t < T ? to_f(Cm[b * scb + t * sct + n]) : 0.f;
    }
    __syncthreads();
    state_update<P, N>(hs, at, sv, rows, ec[Q - 1]);
  }
  if (dh0) {
    __syncthreads();
    for (int u = tid; u < P * N; u += NT) dh0[hoff + u] = hs[(u / N) * NS + u % N];
  }
}

// ---------------------------------------------------------------------------
// 2. the gradients of one chunk, every head
// ---------------------------------------------------------------------------

template <int P, int N>
struct ChunkSmem {
  static constexpr int NS = N + 4, PS = P + 4, NG = N / 4;
  static constexpr int BS = 0;                  // [Q][NS]  B rows
  static constexpr int CS = BS + Q * NS;        // [Q][NS]  C rows
  static constexpr int XS = CS + Q * NS;        // [Q][PS]  x rows (this head)
  static constexpr int YS = XS + Q * PS;        // [Q][PS]  dy rows
  static constexpr int HM = YS + Q * PS;        // [P][NS]  h_s
  static constexpr int GE = HM + P * NS;        // [P][NS]  G_e
  static constexpr int GM = GE + P * NS;        // [Q][QS]  C_k·B_j
  static constexpr int MS = GM + Q * QS;        // [Q][QS]  (C_k·B_j) L_kj
  static constexpr int WS = MS + Q * QS;        // [Q][QS]  W_kj = (dy_k·x_j) L_kj
  static constexpr int RS = WS + Q * QS;        // [Q][QS]  W_kj (C_k·B_j) dt_j
  static constexpr int DT = RS + Q * QS;        // [Q] dt
  static constexpr int CU = DT + Q;             // [Q] cum
  static constexpr int EC = CU + Q;             // [Q] exp(cum)
  static constexpr int DE = EC + Q;             // [Q] exp(cum_end - cum)
  static constexpr int WP = DE + Q;             // [Q][NG] partial dy_k·h_s C_k
  static constexpr int DP = WP + Q * NG;        // [Q][P / 32] partial x_j·g_j B_j
  static constexpr int UP = DP + Q * P / 32;    // [Q][P / 32] partial x_j·exp(cum_end - cum_j) G_e B_j
  static constexpr int RED = UP + Q * P / 32;   // [NT / 32] ⟨h_s, G_e⟩ per warp
  static constexpr int FLOATS = RED + NT / 32;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename E, int P, int N>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_chunk_kernel(
    const E* __restrict__ x, long long sxb, long long sxt, long long sxh,
    const float* __restrict__ dt, long long sdb, long long sdt, long long sdh,
    const float* __restrict__ A,
    const E* __restrict__ Bm, long long sbb, long long sbt,
    const E* __restrict__ Cm, long long scb, long long sct,
    const E* __restrict__ dy, long long syb, long long syt, long long syh,
    const float* __restrict__ S, const float* __restrict__ G,
    E* __restrict__ dx,         // (B, T, H, P)
    float* __restrict__ ddt,    // (B, T, H)
    E* __restrict__ dB,         // (B, T, N)
    E* __restrict__ dC,         // (B, T, N)
    float* __restrict__ dAp,    // (B, nc, H) partials of dA
    int H, int T) {
  using L = ChunkSmem<P, N>;
  constexpr int NS = L::NS, PS = L::PS, NG = L::NG;
  static_assert(NT % Q == 0 && NT % P == 0 && NT % NG == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* bs = smem + L::BS;
  float* cs = smem + L::CS;
  float* xs = smem + L::XS;
  float* ys = smem + L::YS;
  float* hm = smem + L::HM;
  float* ge = smem + L::GE;
  float* gm = smem + L::GM;
  float* ms = smem + L::MS;
  float* ws = smem + L::WS;
  float* rs = smem + L::RS;
  float* dts = smem + L::DT;
  float* cum = smem + L::CU;
  float* ecum = smem + L::EC;
  float* dend = smem + L::DE;
  float* wpart = smem + L::WP;
  float* dpart = smem + L::DP;
  float* upart = smem + L::UP;
  float* red = smem + L::RED;

  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = gridDim.x, c0 = c * Q;

  // -- B, C of the chunk and C·Bᵀ, once for all heads ----------------------
  for (int u = tid; u < Q * N; u += NT) {
    const int i = u / N, n = u % N, t = c0 + i;
    const bool live = t < T;
    bs[i * NS + n] = live ? to_f(Bm[b * sbb + t * sbt + n]) : 0.f;
    cs[i * NS + n] = live ? to_f(Cm[b * scb + t * sct + n]) : 0.f;
  }
  __syncthreads();
  {
    constexpr int R = Q * Q / NT;
    const int j = tid % Q, k0 = tid / Q;
    float g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) g[r] = 0.f;
    for (int n = 0; n < N; n += 4) {
      const float4 bv = ld4(bs + j * NS + n);
#pragma unroll
      for (int r = 0; r < R; ++r) g[r] = dot4(g[r], ld4(cs + (k0 + r * (NT / Q)) * NS + n), bv);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) gm[(k0 + r * (NT / Q)) * QS + j] = g[r];
  }

  // this thread's rows i and state columns 4 nq ... of the Q x N products
  constexpr int IS = NT / NG;
  constexpr int RN = (Q + IS - 1) / IS;
  const int nq = tid % NG, i0 = tid / NG;
  float4 dBa[RN], dCa[RN];
#pragma unroll
  for (int r = 0; r < RN; ++r) dBa[r] = dCa[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int h = 0; h < H; ++h) {
    const float Ah = A[h];
    const size_t soff = (((size_t)b * H + h) * nc + c) * P * N;

    // -- load: dt and its decays (warp 0), x and dy rows, h_s and G_e ------
    if (warp == 0) {
      const int t = c0 + lane;
      const float d = t < T ? dt[b * sdb + t * sdt + h * sdh] : 0.f;
      const float cl = warp_incl_scan(Ah * d);
      const float cend = __shfl_sync(FULL, cl, Q - 1);
      dts[lane] = d;
      cum[lane] = cl;
      ecum[lane] = expf(cl);
      dend[lane] = expf(cend - cl);
    }
    for (int u = tid; u < Q * P; u += NT) {
      const int i = u / P, p = u % P, t = c0 + i;
      const bool live = t < T;
      xs[i * PS + p] = live ? to_f(x[b * sxb + t * sxt + h * sxh + p]) : 0.f;
      ys[i * PS + p] = live ? to_f(dy[b * syb + t * syt + h * syh + p]) : 0.f;
    }
    float hg = 0.f;
    for (int u = tid; u < P * N; u += NT) {
      const float sv = S[soff + u], gv = G[soff + u];
      hm[(u / N) * NS + u % N] = sv;
      ge[(u / N) * NS + u % N] = gv;
      hg = fmaf(sv, gv, hg);
    }
    hg = warp_sum(hg);
    if (lane == 0) red[warp] = hg;
    __syncthreads();

    // -- D = dY Xᵀ, then M = (C·Bᵀ) ∘ L, W = D ∘ L, R = W ∘ (C·Bᵀ) dt_j -----
    {
      constexpr int R = Q * Q / NT;
      const int j = tid % Q, k0 = tid / Q;
      float d[R];
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = 0.f;
      for (int p = 0; p < P; p += 4) {
        const float4 xv = ld4(xs + j * PS + p);
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] = dot4(d[r], ld4(ys + (k0 + r * (NT / Q)) * PS + p), xv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + r * (NT / Q);
        const bool on = j <= k;
        // the exponent is zeroed off the triangle first: exp never sees a
        // positive cum_k - cum_j
        const float l = on ? expf(on ? cum[k] - cum[j] : 0.f) : 0.f;
        const float g = gm[k * QS + j], w = d[r] * l;
        ms[k * QS + j] = g * l;
        ws[k * QS + j] = w;
        rs[k * QS + j] = w * g * dts[j];
      }
    }
    __syncthreads();

    // -- g_j B_j = Σ_k M_kj dy_k + exp(cum_end - cum_j) G_e B_j; dx --------
    {
      constexpr int JS = NT / P, R = Q / JS;
      const int p = tid % P, j0 = tid / P;
      float a[R], s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = s[r] = 0.f;
      for (int k = 0; k < Q; ++k) {
        const float yv = ys[k * PS + p];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fmaf(ms[k * QS + j0 + r * JS], yv, a[r]);
      }
      for (int n = 0; n < N; n += 4) {
        const float4 gv = ld4(ge + p * NS + n);
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = dot4(s[r], ld4(bs + (j0 + r * JS) * NS + n), gv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + r * JS, t = c0 + j;
        const float sp = dend[j] * s[r], gb = a[r] + sp;
        if (t < T) dx[(((size_t)b * T + t) * H + h) * P + p] = from_f<E>(dts[j] * gb);
        // x_j·g_j B_j and x_j·(its state part), over this warp's 32 p
        const float xv = xs[j * PS + p];
        const float pd = warp_sum(xv * gb), pu = warp_sum(xv * sp);
        if (lane == 0) {
          dpart[j * (P / 32) + p / 32] = pd;
          upart[j * (P / 32) + p / 32] = pu;
        }
      }
    }

    // -- the Q x N products: h_iᵀ dy_i into dC, dt_j g_jᵀ x_j into dB; each
    //    state or B / C element read once for the thread's RN rows --------
    {
      float4 hy[RN], xg[RN], wc[RN], wb[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) hy[r] = xg[r] = wc[r] = wb[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      // rows past Q (N < 32: fewer rows than threads) read row 0 and are dropped
      int rows[RN];
#pragma unroll
      for (int r = 0; r < RN; ++r) rows[r] = i0 + r * IS < Q ? i0 + r * IS : 0;
      for (int p = 0; p < P; ++p) {
        const float4 hv = ld4(hm + p * NS + 4 * nq), gv = ld4(ge + p * NS + 4 * nq);
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          hy[r] = fma4(ys[rows[r] * PS + p], hv, hy[r]);
          xg[r] = fma4(xs[rows[r] * PS + p], gv, xg[r]);
        }
      }
      for (int j = 0; j < Q; ++j) {
        const float4 bv = ld4(bs + j * NS + 4 * nq), cv = ld4(cs + j * NS + 4 * nq);
        const float dj = dts[j];
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          wc[r] = fma4(ws[rows[r] * QS + j] * dj, bv, wc[r]);
          wb[r] = fma4(ws[j * QS + rows[r]], cv, wb[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int i = i0 + r * IS;
        if (i < Q) {
          const float e = ecum[i], d = dts[i], de = dend[i];
          dCa[r].x += fmaf(e, hy[r].x, wc[r].x);
          dCa[r].y += fmaf(e, hy[r].y, wc[r].y);
          dCa[r].z += fmaf(e, hy[r].z, wc[r].z);
          dCa[r].w += fmaf(e, hy[r].w, wc[r].w);
          dBa[r].x += d * fmaf(de, xg[r].x, wb[r].x);
          dBa[r].y += d * fmaf(de, xg[r].y, wb[r].y);
          dBa[r].z += d * fmaf(de, xg[r].z, wb[r].z);
          dBa[r].w += d * fmaf(de, xg[r].w, wb[r].w);
          wpart[i * NG + nq] = e * dot4(0.f, hy[r], ld4(cs + i * NS + 4 * nq));
        }
      }
    }
    __syncthreads();

    // -- per position: ddt, and this head's share of dA (warp 0) -----------
    if (warp == 0) {
      const int i = lane, t = c0 + i;
      float direct = 0.f, u = 0.f;
#pragma unroll
      for (int q = 0; q < P / 32; ++q) {
        direct += dpart[i * (P / 32) + q];
        u += upart[i * (P / 32) + q];
      }
      float w = 0.f;
      for (int q = 0; q < NG; ++q) w += wpart[i * NG + q];
      // t1_i = Σ_{j<i<=k} R_kj, from t1_{i+1} - t1_i = Σ_{k>i} R_ki - Σ_{j<i} R_ij
      float step = 0.f;
      for (int m = 0; m < Q; ++m) {
        if (m > i) step += rs[m * QS + i];
        if (m < i) step -= rs[i * QS + m];
      }
      const float step_incl = warp_incl_scan(step);
      float t1 = __shfl_up_sync(FULL, step_incl, 1);
      if (lane == 0) t1 = 0.f;
      float hg_all = 0.f;
#pragma unroll
      for (int q = 0; q < NT / 32; ++q) hg_all += red[q];
      const float v = dts[i] * u;
      const float v_incl = warp_incl_scan(v);
      float v_excl = __shfl_up_sync(FULL, v_incl, 1);
      if (lane == 0) v_excl = 0.f;
      const float da = t1 + v_excl + warp_suffix_scan(w) + ecum[Q - 1] * hg_all;
      if (t < T) ddt[((size_t)b * T + t) * H + h] = fmaf(Ah, da, direct);
      const float part = warp_sum(dts[i] * da);
      if (lane == 0) dAp[((size_t)b * nc + c) * H + h] = part;
    }
    __syncthreads();   // the next head overwrites every per-head tile
  }

#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int i = i0 + r * IS, t = c0 + i;
    if (i < Q && t < T) {
      const size_t o = ((size_t)b * T + t) * N + 4 * nq;
      dB[o + 0] = from_f<E>(dBa[r].x);
      dB[o + 1] = from_f<E>(dBa[r].y);
      dB[o + 2] = from_f<E>(dBa[r].z);
      dB[o + 3] = from_f<E>(dBa[r].w);
      dC[o + 0] = from_f<E>(dCa[r].x);
      dC[o + 1] = from_f<E>(dCa[r].y);
      dC[o + 2] = from_f<E>(dCa[r].z);
      dC[o + 3] = from_f<E>(dCa[r].w);
    }
  }
}

// the launch's arguments, as ssd_scan_bwd_launch takes them
#define BWD_PARAMS                                                                          \
  const void *x, long long sxb, long long sxt, long long sxh, const void *dt, long long sdb,  \
      long long sdt, long long sdh, const void *A, const void *Bm, long long sbb,            \
      long long sbt, const void *Cm, long long scb, long long sct, const void *dy,           \
      long long syb, long long syt, long long syh, const void *h0, const void *dhT, void *S, \
      void *G, void *dx, void *ddt, void *dB, void *dC, void *dh0, void *dAp, int Bsz,       \
      int T, int H, cudaStream_t stream
#define BWD_ARGS                                                                            \
  x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb, sbt, Cm, scb, sct, dy, syb, syt, syh, h0, \
      dhT, S, G, dx, ddt, dB, dC, dh0, dAp, Bsz, T, H, stream

template <typename K>
int size_once(K kernel, size_t bytes, bool& sized) {
  if (sized) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  sized = true;
  return 0;
}

template <typename E, int P, int N>
int launch(BWD_PARAMS) {
  using SL = StateSmem<P, N>;
  using CL = ChunkSmem<P, N>;
  auto k1 = ssd_bwd_state_kernel<E, P, N>;
  auto k2 = ssd_bwd_chunk_kernel<E, P, N>;
  static bool sized1 = false, sized2 = false;   // one attribute call per instantiation
  int e = size_once(k1, SL::BYTES, sized1);
  if (e) return e;
  e = size_once(k2, CL::BYTES, sized2);
  if (e) return e;
  const E* xe = static_cast<const E*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const E* be = static_cast<const E*>(Bm);
  const E* ce = static_cast<const E*>(Cm);
  const E* ye = static_cast<const E*>(dy);
  float* Sf = static_cast<float*>(S);
  float* Gf = static_cast<float*>(G);
  k1<<<dim3(H, Bsz), NT, SL::BYTES, stream>>>(
      xe, sxb, sxt, sxh, dtf, sdb, sdt, sdh, Af, be, sbb, sbt, ce, scb, sct, ye, syb, syt, syh,
      static_cast<const float*>(h0), static_cast<const float*>(dhT), Sf, Gf,
      static_cast<float*>(dh0), H, T);
  e = (int)cudaGetLastError();
  if (e) return e;
  const int nc = (T + Q - 1) / Q;
  if (nc == 0) return 0;
  k2<<<dim3(nc, Bsz), NT, CL::BYTES, stream>>>(
      xe, sxb, sxt, sxh, dtf, sdb, sdt, sdh, Af, be, sbb, sbt, ce, scb, sct, ye, syb, syt, syh,
      Sf, Gf, static_cast<E*>(dx), static_cast<float*>(ddt), static_cast<E*>(dB),
      static_cast<E*>(dC), static_cast<float*>(dAp), H, T);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(int N, int dtype, BWD_PARAMS) {
#define BWD_CASE(NN)                                                               \
  case NN:                                                                         \
    return dtype == 1 ? launch<bf16, P, NN>(BWD_ARGS) : launch<float, P, NN>(BWD_ARGS);
  switch (N) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
  }
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, B, C, dy and the outputs dx, dB, dC: dtype 0 = float32, 1 = bfloat16;
// dt, A, the states, ddt and the dA partials float32.  Inputs take the
// strides given (in elements; the last dim is contiguous); the outputs are
// contiguous: dx (B, T, H, P), ddt (B, T, H), dB and dC (B, T, N), dAp
// (B, ceil(T / 32), H).  S and G are scratch of (B, H, ceil(T / 32), P, N)
// float32 each.  h0 may be null (zero initial state; dh0 is then unused and
// may be null too), dhT null (the final state's gradient is 0).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape the kernels do not take.
int ssd_scan_bwd_launch(const void* x, long long sxb, long long sxt, long long sxh,
                        const void* dt, long long sdb, long long sdt, long long sdh,
                        const void* A, const void* Bm, long long sbb, long long sbt,
                        const void* Cm, long long scb, long long sct, const void* dy,
                        long long syb, long long syt, long long syh, const void* h0,
                        const void* dhT, void* S, void* G, void* dx, void* ddt, void* dB,
                        void* dC, void* dh0, void* dAp, int Bsz, int T, int H, int P, int N,
                        int dtype, void* stream_ptr) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || T < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (P) {
    case 32: return launch_p<32>(N, dtype, BWD_ARGS);
    case 64: return launch_p<64>(N, dtype, BWD_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of the state pass (kernel 0) or of the chunk
// pass (kernel 1) for (P, N); 0 for a (P, N) they do not take.
int ssd_scan_bwd_smem_bytes(int P, int N, int kernel) {
#define BWD_SMEM(PP, NN)                                                  \
  if (P == PP && N == NN)                                                 \
    return kernel ? (int)ChunkSmem<PP, NN>::BYTES : (int)StateSmem<PP, NN>::BYTES;
  BWD_SMEM(32, 16) BWD_SMEM(32, 32) BWD_SMEM(32, 64) BWD_SMEM(32, 128)
  BWD_SMEM(64, 16) BWD_SMEM(64, 32) BWD_SMEM(64, 64) BWD_SMEM(64, 128)
#undef BWD_SMEM
  return 0;
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
