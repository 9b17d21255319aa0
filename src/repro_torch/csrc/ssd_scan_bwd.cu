// Backward of the Mamba-2 chunked SSD scan (csrc/ssd_scan.cu).
//
// Replaces the backward of the Pallas kernel src/repro/kernels/ssd_scan.py:90
// ssd_scan, which the reference registers as a jax.custom_vjp whose
// backward recomputes through its jnp oracle (src/repro/kernels/ops.py:162
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
// evaluated chunk by chunk, Q positions at a time.  Inside a chunk with
// start state h_s, end-state gradient G_e, cum the inclusive cumsum of a
// and L_kj = exp(cum_k - cum_j) for k >= j (else 0):
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
// Two passes a call, each one kernel:
//  1. the state pass: every chunk's start state h_s, walking forward from
//     the initial state, and every chunk's end-state gradient G_e, walking
//     back from the final state's gradient, into scratch (B, H, chunks, P,
//     N); the backward walk leaves d_init;
//  2. the chunk pass, one block per (chunk, row): every chunk is
//     independent given h_s and G_e.  The block walks the heads in order,
//     writes each head's dx and ddt, and sums dB and dC over the heads in
//     registers, so they leave the block final: no per-head partials, no
//     atomics, and a rerun is bit-identical.  dA leaves as one partial a
//     (row, chunk, head), which the wrapper sums with torch.sum.
//
// Two routes by dtype:
//  * bfloat16 (training): Q = 64 (kernels/ssd_scan.py BWD_CHUNK), every
//    product on the tensor cores (mma.sync m16n8k16 fed by ldmatrix,
//    cp.async rings; tc_common.cuh):
//      - ssd_bwd_state_mma_kernel, one block per (head, row, direction):
//        the forward and the backward walk run side by side (384 blocks of
//        8 warps at mamba2-780m's training shape, B 4, T 2048, H 48, P 64,
//        N 128, two a SM: 128 registers, 99 KB of shared memory).  A warp
//        owns a (16, N / 2) slice of the f32 state or its gradient in its
//        mma accumulators across all chunks; the next two chunks' x or dy,
//        dt and B or C stream in through a three-stage cp.async ring.  The
//        slice goes to scratch once a chunk, rounded once to bf16 and
//        staged in the warp's own shared-memory rows so that it leaves as
//        whole 16-byte pieces of rows (stored from the accumulators as they
//        lie, 4 bytes a lane and 8 rows a store, they were the pass's
//        largest cost); nothing waits on them.  The update's f32 operand
//        (x·exp(cum_end - cum)·dt, or dy·exp(cum)) goes in as a bf16 hi +
//        lo pair, so the carried state and d_init keep f32 accuracy;
//      - ssd_bwd_chunk_mma_kernel, one block of 8 warps per (chunk, row):
//        128 blocks at that shape, one wave.  C·Bᵀ once per block, kept in
//        the warps' registers; per head D = dY·Xᵀ, then M = (C·Bᵀ) ∘ L,
//        W = D ∘ L and W·dt rounded once into shared memory, and the
//        products Mᵀ·dY, B·G_eᵀ (g B, dx), dY·h_s, W·dt·B (dC) and X·G_e,
//        Wᵀ·C (dB), each skipping the k-blocks its triangle zeroes.  The
//        next head's x, dy, h_s, G_e and dt stream in (two stages) while
//        the current one computes; dx leaves through the warp's staged
//        rows like the scratch above; each head's ddt and dA partial are
//        finished by one warp while the others start on the next head.
//    The decays take the fast exponential (__expf: ex2.approx, ~2^-21
//    relative for the arguments here), well inside bf16 rounding.
//    Which f32 operands may be rounded once is shown by the CPU emulation
//    tests/test_torch_ssd_bwd_rounding.py: h_s, G_e, M, W and W·dt are
//    (each moves a gradient by at most ~5 % of phase 8f's bf16 limit);
//  * float32 (the smoke configs, checks): Q = 32, f32 FMAs on the CUDA
//    cores, ssd_bwd_state_kernel (one block per (head, row), the two walks
//    one after the other, the state in shared memory, f32 scratch) and
//    ssd_bwd_chunk_kernel; not redesigned.
//
// What bounds it on an H100: bytes.  The function must move x, dy, dx, dt,
// ddt, B, C, dB and dC once: 162.5 MB at the training shape, 0.0485 ms at
// 3.35 TB/s; its ~4e10 flops would take 0.04 ms on the tensor cores.  This
// design also writes and reads back its bf16 scratch, 2 x 100.7 MB at that
// shape: its own floor is 565 MB, 0.169 ms.  Its products, with the hi +
// lo pairs and the triangles' zero blocks skipped, are 5.8e10 flops of
// mma.sync (0.06 ms at the 989 TFLOP/s peak).
//
// Positions past T load as zeros with dt = 0 and dy = 0: they add nothing
// and decay nothing, so T needs not be a multiple of Q.  A position whose
// dt is 0 gets dx = 0 and adds nothing to dB, exactly.
//
// Plain C interface (loaded with ctypes): ssd_scan_bwd_launch returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int NT = 256;        // threads per block (float32 kernels)
constexpr int Q = 32;          // positions per float32 chunk: one warp, one lane each
constexpr int QS = Q + 4;      // row stride of the Q x Q tiles and of the transposed rows
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }

template <typename E> __device__ __forceinline__ E from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// ---------------------------------------------------------------------------
// 3. bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int QM = 64;   // positions a chunk of the bf16 kernels (BWD_CHUNK)

// A chunk's decays as every warp sees them: lane l holds positions l (d0,
// c0) and l + 32 (d1, c1); c is the inclusive cumsum of A dt
struct Decays {
  float d0, d1, c0, c1, cend;
};

__device__ __forceinline__ Decays chunk_decays(const float* dts, float Ah) {
  const int lane = threadIdx.x & 31;
  Decays r;
  r.d0 = dts[lane];
  r.d1 = dts[lane + 32];
  r.c0 = warp_incl_scan(Ah * r.d0);
  r.c1 = warp_incl_scan(Ah * r.d1) + __shfl_sync(FULL, r.c0, 31);
  r.cend = __shfl_sync(FULL, r.c1, 31);
  return r;
}

// the value at position q of a (lane, lane + 32) pair
__device__ __forceinline__ float at_pos(float lo, float hi, int q) {
  const float a = __shfl_sync(FULL, lo, q & 31), b = __shfl_sync(FULL, hi, q & 31);
  return q < 32 ? a : b;
}

// exclusive prefix sums of a (lane, lane + 32) pair over the 64 positions
__device__ __forceinline__ void excl_scan64(float v0, float v1, float& e0, float& e1) {
  const int lane = threadIdx.x & 31;
  const float i0 = warp_incl_scan(v0), tot = __shfl_sync(FULL, i0, 31);
  const float i1 = warp_incl_scan(v1) + tot;
  e0 = __shfl_up_sync(FULL, i0, 1);
  e1 = __shfl_up_sync(FULL, i1, 1);
  if (lane == 0) {
    e0 = 0.f;
    e1 = tot;
  }
}

// inclusive suffix sums of a (lane, lane + 32) pair over the 64 positions
__device__ __forceinline__ void suffix_scan64(float v0, float v1, float& s0, float& s1) {
  s1 = warp_suffix_scan(v1);
  s0 = warp_suffix_scan(v0) + __shfl_sync(FULL, s1, 0);
}

__device__ __forceinline__ float2 bf2_at(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A fragment (16 x 16) of Mᵀ for an M stored row-major in shared memory:
// rows m0 ... of the fragment are columns of the stored rows k0 ...
__device__ __forceinline__ uint32_t lane_at_t(uint32_t base, int RB, int k0, int m0) {
  const int lane = threadIdx.x & 31;
  return base + (k0 + (lane & 7) + (lane >> 4) * 8) * RB + (m0 + ((lane >> 3) & 1) * 8) * 2;
}
// A fragment of a row-major matrix: rows m0 ..., columns k0 ...
__device__ __forceinline__ uint32_t lane_at_a(uint32_t base, int RB, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  return base + (m0 + (lane & 15)) * RB + k0 * 2 + (lane >> 4) * 16;
}
// B fragments (16 x 16: two 8-column blocks) of a row-major [k][n] matrix
__device__ __forceinline__ uint32_t lane_at_b(uint32_t base, int RB, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RB + n0 * 2 + (lane >> 4) * 16;
}

// acc (16 x 8 NB) += A (16 x 16 KB, at a_lane, advancing 32 bytes or 16
// rows a k-block) times the [k][n] matrix at b_lane, k-blocks kb0 ... kb1
template <int NB, bool A_T>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4], uint32_t a_lane, int a_rb,
                                         uint32_t b_lane, int b_rb, int kb0, int kb1) {
  for (int kk = kb0; kk < kb1; ++kk) {
    uint32_t a[4];
    if (A_T)
      ldsm_x4_t(a, a_lane + kk * 16 * a_rb);
    else
      ldsm_x4(a, a_lane + kk * 32);
#pragma unroll
    for (int dp = 0; dp < NB / 2; ++dp) {
      uint32_t bb[4];
      ldsm_x4_t(bb, b_lane + kk * 16 * b_rb + dp * 32);
      mma16816(acc[2 * dp], a, bb[0], bb[1]);
      mma16816(acc[2 * dp + 1], a, bb[2], bb[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int i = 0; i < NB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// -- the state pass ---------------------------------------------------------

// Warps, shared memory and the ring of the bf16 state pass.  A warp owns
// 16 rows of the (P, N) state and NW of its columns; a stage holds one
// chunk's Q rows of x or dy (P bf16), of B or C (N bf16) and its Q dt;
// after the stages, each warp's 16 rows of NW bf16, where its slice is
// staged on its way to the scratch.
template <int P, int N>
struct StateMma {
  static constexpr int WR = P / 16;
  static constexpr int WC = (8 / WR < N / 16) ? 8 / WR : N / 16;
  static constexpr int WARPS = WR * WC, NW = N / WC;
  static constexpr int STAGES = 3;
  static constexpr int RP = TcRow<P>::RB, RN = TcRow<N>::RB, RW = TcRow<NW>::RB;
  static constexpr int U_OFF = 0, V_OFF = QM * RP, DT_OFF = V_OFF + QM * RN;
  static constexpr int STAGE = DT_OFF + QM * 4;
  static constexpr int OUT_OFF = STAGES * STAGE;
  static constexpr int BYTES = OUT_OFF + WARPS * 16 * RW;
};

template <int P, int N>
__global__ void __launch_bounds__(256, 2) ssd_bwd_state_mma_kernel(
    const bf16* __restrict__ x, long long sxb, long long sxt, long long sxh,
    const float* __restrict__ dt, long long sdb, long long sdt, long long sdh,
    const float* __restrict__ A,
    const bf16* __restrict__ Bm, long long sbb, long long sbt,
    const bf16* __restrict__ Cm, long long scb, long long sct,
    const bf16* __restrict__ dy, long long syb, long long syt, long long syh,
    const float* __restrict__ h0,    // (B, H, P, N) or null
    const float* __restrict__ dhT,   // (B, H, P, N) or null
    bf16* __restrict__ S,            // (B, H, nc, P, N): chunk start states
    bf16* __restrict__ G,            // (B, H, nc, P, N): chunk end-state gradients
    float* __restrict__ dh0,         // (B, H, P, N) or null
    int H, int T) {
  using L = StateMma<P, N>;
  constexpr int RP = L::RP, RN = L::RN, NB = L::NW / 8, NTH = L::WARPS * 32;
  extern __shared__ __align__(128) unsigned char raw[];
  const uint32_t base = smem_addr(raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const bool fwd = blockIdx.z == 0;   // forward: x, B into S; backward: dy, C into G
  const int p0 = (warp % L::WR) * 16, n0 = (warp / L::WR) * L::NW;
  const int nc = (T + QM - 1) / QM;
  const float Ah = A[h];
  const bf16* u = fwd ? x + b * sxb + h * sxh : dy + b * syb + h * syh;
  const long long sut = fwd ? sxt : syt;
  const bf16* v = fwd ? Bm + b * sbb : Cm + b * scb;
  const long long svt = fwd ? sbt : sct;
  const float* dtb = dt + b * sdb + h * sdh;

  // chunk c into stage stg; positions past T zero-filled
  auto load = [&](int c, int stg) {
    const uint32_t sb = base + stg * L::STAGE;
    const int c0 = c * QM;
    constexpr int UP = P / 8, VN = N / 8;
    for (int e = tid; e < QM * UP; e += NTH) {
      const int r = e / UP, cc = e % UP, t = c0 + r;
      const bool in = t < T;
      cp_async16(sb + L::U_OFF + r * RP + cc * 16, u + (in ? t * sut : 0) + cc * 8, in);
    }
    for (int e = tid; e < QM * VN; e += NTH) {
      const int r = e / VN, cc = e % VN, t = c0 + r;
      const bool in = t < T;
      cp_async16(sb + L::V_OFF + r * RN + cc * 16, v + (in ? t * svt : 0) + cc * 8, in);
    }
    for (int e = tid; e < QM; e += NTH) {
      const int t = c0 + e;
      const bool in = t < T;
      cp_async4(sb + L::DT_OFF + e * 4, dtb + (in ? t * sdt : 0), in);
    }
  };

  // this warp's slice in accumulator layout: st[nb] is the 16 x 8 tile of
  // columns n0 + 8 nb ..., rows p0 + g and p0 + g + 8
  float st[NB][4];
  const float* init = fwd ? h0 : dhT;
  const size_t hoff = (((size_t)b * H + h) * P + p0) * N + n0;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 iv = make_float2(0.f, 0.f);
      if (init)
        iv = *reinterpret_cast<const float2*>(init + hoff + (size_t)(g + 8 * half) * N + nb * 8 + 2 * tq);
      st[nb][2 * half] = iv.x;
      st[nb][2 * half + 1] = iv.y;
    }
  }
  bf16* out = (fwd ? S : G) + (((size_t)b * H + h) * nc * P + p0) * N + n0;
  unsigned char* staged = raw + L::OUT_OFF + warp * 16 * L::RW;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < nc) load(fwd ? s : nc - 1 - s, s);
    cp_async_commit();
  }
  const uint32_t a_lane = lane_at_t(0, RP, 0, p0);
  const uint32_t b_lane = lane_at_b(0, RN, 0, n0);
  for (int it = 0; it < nc; ++it) {
    const int c = fwd ? it : nc - 1 - it, stg = it % L::STAGES;
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();   // chunk it has landed; every warp is done with chunk it - 1
    {
      const int nx = it + L::STAGES - 1;
      if (nx < nc) load(fwd ? nx : nc - 1 - nx, nx % L::STAGES);
      cp_async_commit();
    }
    // the state before chunk c (forward) or the gradient after it
    // (backward), rounded once to bf16, staged in the warp's own rows so
    // that it leaves as whole 16-byte pieces of rows; nothing waits on the
    // stores
    __syncwarp();   // the previous chunk's pieces have been read
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(staged + (g + 8 * half) * L::RW + (nb * 8 + 2 * tq) * 2) =
            pack_bf16(st[nb][2 * half], st[nb][2 * half + 1]);
    __syncwarp();
    {
      constexpr int PR = L::NW / 8;   // pieces a row
      bf16* o = out + (size_t)c * P * N;
#pragma unroll
      for (int e = lane; e < 16 * PR; e += 32)
        *reinterpret_cast<uint4*>(o + (size_t)(e / PR) * N + (e % PR) * 8) =
            *reinterpret_cast<const uint4*>(staged + (e / PR) * L::RW + (e % PR) * 16);
    }

    const uint32_t sb = base + stg * L::STAGE;
    const Decays dc = chunk_decays(reinterpret_cast<const float*>(raw + stg * L::STAGE + L::DT_OFF), Ah);
    // a position's weight: exp(cum_end - cum_j) dt_j (forward), exp(cum_k) (backward)
    const float w0 = fwd ? __expf(dc.cend - dc.c0) * dc.d0 : __expf(dc.c0);
    const float w1 = fwd ? __expf(dc.cend - dc.c1) * dc.d1 : __expf(dc.c1);
    const float dec = __expf(dc.cend);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      st[nb][0] *= dec;
      st[nb][1] *= dec;
      st[nb][2] *= dec;
      st[nb][3] *= dec;
    }
    // a chunk whose weights are all 0 (dt = 0 throughout) adds nothing
    if (__any_sync(FULL, w0 != 0.f || w1 != 0.f)) {
#pragma unroll
      for (int kk = 0; kk < QM / 16; ++kk) {
        // A = (u w)ᵀ: rows p, columns the chunk's positions, u read transposed
        uint32_t au[4];
        ldsm_x4_t(au, sb + L::U_OFF + a_lane + kk * 16 * RP);
        const float wl = kk < 2 ? w0 : w1;
        const int j = (kk & 1) * 16 + 2 * tq;
        const float w[4] = {__shfl_sync(FULL, wl, j), __shfl_sync(FULL, wl, j + 1),
                            __shfl_sync(FULL, wl, j + 8), __shfl_sync(FULL, wl, j + 9)};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 uv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&au[r]));
          const int k8 = (r >> 1) * 2;               // a0, a1: positions j; a2, a3: j + 8
          split_bf16(uv.x * w[k8], uv.y * w[k8 + 1], ahi[r], alo[r]);
        }
#pragma unroll
        for (int dp = 0; dp < NB / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(bb, sb + L::V_OFF + b_lane + kk * 16 * RN + dp * 32);
          mma16816(st[2 * dp], ahi, bb[0], bb[1]);
          mma16816(st[2 * dp], alo, bb[0], bb[1]);
          mma16816(st[2 * dp + 1], ahi, bb[2], bb[3]);
          mma16816(st[2 * dp + 1], alo, bb[2], bb[3]);
        }
      }
    }
  }
  if (!fwd && dh0) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(dh0 + hoff + (size_t)(g + 8 * half) * N + nb * 8 + 2 * tq) =
            make_float2(st[nb][2 * half], st[nb][2 * half + 1]);
  }
}

// -- the chunk pass ---------------------------------------------------------

// Shared memory of the bf16 chunk pass: the chunk's B and C rows; two
// stages of one head's x and dy rows, h_s and G_e (bf16, from the state
// pass) and dt; M, W and W·dt (Q x Q bf16); two heads' sets of per-position
// sums (f32), read by the warp that finishes each head; each warp's 16
// rows of P / 2 bf16, where its dx is staged.  bf16 rows padded by 16
// bytes (TcRow).
template <int P, int N>
struct ChunkMma {
  static constexpr int STAGES = 2;
  static constexpr int RN = TcRow<N>::RB, RP = TcRow<P>::RB, RQ = TcRow<QM>::RB;
  static constexpr int RX = TcRow<P / 2>::RB;            // a warp's staged dx rows
  static constexpr int BS = 0, CS = QM * RN, ST = 2 * QM * RN;
  static constexpr int X_OFF = 0, Y_OFF = QM * RP, H_OFF = 2 * QM * RP, G_OFF = H_OFF + P * RN;
  static constexpr int DT_OFF = G_OFF + P * RN, STAGE = DT_OFF + QM * 4;
  static constexpr int MW = ST + STAGES * STAGE;          // M, W, W·dt
  static constexpr int VEC = MW + 3 * QM * RQ;
  // one set, in floats: x·g B and x·G_e B (two column halves each), dy·h_s
  // C (two halves), R's row sums (two column halves) and column sums (four
  // row blocks), dt, ⟨h_s, G_e⟩ per warp, cum_end
  static constexpr int DPo = 0, UPo = 2 * QM, WPo = 4 * QM, RRo = 6 * QM, RCo = 8 * QM,
                       DTo = 12 * QM, HGo = 13 * QM, CEo = HGo + 8, SET = CEo + 8;
  static constexpr int DX_OFF = VEC + 2 * SET * 4;
  static constexpr int BYTES = DX_OFF + 8 * 16 * RX;
};

template <int P, int N>
__global__ void __launch_bounds__(256, 1) ssd_bwd_chunk_mma_kernel(
    const bf16* __restrict__ x, long long sxb, long long sxt, long long sxh,
    const float* __restrict__ dt, long long sdb, long long sdt, long long sdh,
    const float* __restrict__ A,
    const bf16* __restrict__ Bm, long long sbb, long long sbt,
    const bf16* __restrict__ Cm, long long scb, long long sct,
    const bf16* __restrict__ dy, long long syb, long long syt, long long syh,
    const bf16* __restrict__ S, const bf16* __restrict__ G,
    bf16* __restrict__ dx,      // (B, T, H, P)
    float* __restrict__ ddt,    // (B, T, H)
    bf16* __restrict__ dB,      // (B, T, N)
    bf16* __restrict__ dC,      // (B, T, N)
    float* __restrict__ dAp,    // (B, nc, H) partials of dA
    int H, int T) {
  using L = ChunkMma<P, N>;
  constexpr int RN = L::RN, RP = L::RP, RQ = L::RQ, LDQ = TcRow<QM>::LD;
  constexpr int NBP = P / 16;                       // g B: P / 2 columns a warp
  constexpr int NCW = N >= 32 ? N / 2 : N;          // dB, dC: columns a warp
  constexpr int NBN = NCW / 8;
  static_assert(P % 32 == 0 && N % 16 == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char raw[];
  const uint32_t base = smem_addr(raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  // this warp: rows 16 rg ... of every Q-row product, column half ch
  const int rg = warp & 3, ch = warp >> 2, r0 = 16 * rg + g;
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x, c0 = c * QM;
  const int pc0 = ch * (P / 2), nc0 = ch * NCW;
  const bool n_live = nc0 < N;                      // N = 16: one column half
  const bool upper = ch == 1 && rg < 2;             // its Q x Q tile is above the diagonal
  float* vec = reinterpret_cast<float*>(raw + L::VEC);

  auto load_head = [&](int h, int stg) {
    const uint32_t sb = base + L::ST + stg * L::STAGE;
    constexpr int XP = P / 8, HN = N / 8;
    for (int e = tid; e < 2 * QM * XP; e += 256) {
      const int which = e / (QM * XP), r = (e / XP) % QM, cc = e % XP, t = c0 + r;
      const bool in = t < T;
      const long long tt = in ? t : 0;
      const bf16* src = which ? dy + b * syb + tt * syt + h * syh : x + b * sxb + tt * sxt + h * sxh;
      cp_async16(sb + (which ? L::Y_OFF : L::X_OFF) + r * RP + cc * 16, src + cc * 8, in);
    }
    const size_t so = (((size_t)b * H + h) * nc + c) * P * N;
    for (int e = tid; e < 2 * P * HN; e += 256) {
      const int which = e / (P * HN), r = (e / HN) % P, cc = e % HN;
      cp_async16(sb + (which ? L::G_OFF : L::H_OFF) + r * RN + cc * 16,
                 (which ? G : S) + so + (size_t)r * N + cc * 8, true);
    }
    for (int e = tid; e < QM; e += 256) {
      const int t = c0 + e;
      const bool in = t < T;
      cp_async4(sb + L::DT_OFF + e * 4, dt + b * sdb + (in ? t * sdt + h * sdh : 0), in);
    }
  };

  // ddt and the dA partial of head hf from set pf, by one warp: lane l
  // takes positions l and l + 32
  auto finish = [&](int hf, int pf) {
    const float* s = vec + pf * L::SET;
    float dir[2], uu[2], ww[2], stp[2], dq[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = lane + 32 * half;
      dir[half] = s[L::DPo + q] + s[L::DPo + QM + q];
      uu[half] = s[L::UPo + q] + s[L::UPo + QM + q];
      ww[half] = s[L::WPo + q] + s[L::WPo + QM + q];
      // t1_{q+1} - t1_q = Σ_{k>q} R_kq - Σ_{j<q} R_qj
      stp[half] = (s[L::RCo + q] + s[L::RCo + QM + q]) + (s[L::RCo + 2 * QM + q] + s[L::RCo + 3 * QM + q]) -
                  (s[L::RRo + q] + s[L::RRo + QM + q]);
      dq[half] = s[L::DTo + q];
    }
    float hg = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) hg += s[L::HGo + w];
    const float tail = __expf(s[L::CEo]) * hg;
    float t1[2], vx[2], wsuf[2];
    excl_scan64(stp[0], stp[1], t1[0], t1[1]);
    excl_scan64(dq[0] * uu[0], dq[1] * uu[1], vx[0], vx[1]);
    suffix_scan64(ww[0], ww[1], wsuf[0], wsuf[1]);
    const float Ah = A[hf];
    float part = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float da = t1[half] + vx[half] + wsuf[half] + tail;
      const int t = c0 + lane + 32 * half;
      if (t < T) ddt[((size_t)b * T + t) * H + hf] = fmaf(Ah, da, dir[half]);
      part = fmaf(dq[half], da, part);
    }
    part = warp_sum(part);
    if (lane == 0) dAp[((size_t)b * nc + c) * H + hf] = part;
  };

  // the chunk's B and C rows, with the first head
  {
    constexpr int HN = N / 8;
    for (int e = tid; e < 2 * QM * HN; e += 256) {
      const int which = e / (QM * HN), r = (e / HN) % QM, cc = e % HN, t = c0 + r;
      const bool in = t < T;
      const long long tt = in ? t : 0;
      const bf16* src = which ? Cm + b * scb + tt * sct : Bm + b * sbb + tt * sbt;
      cp_async16(base + (which ? L::CS : L::BS) + r * RN + cc * 16, src + cc * 8, in);
    }
  }
  load_head(0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < L::STAGES - 1; ++s) {
    if (s < H) load_head(s, s);
    cp_async_commit();
  }
  cp_async_wait<L::STAGES - 2>();
  __syncthreads();

  // C·Bᵀ on this warp's tile of the Q x Q products: rows k = 16 rg ...,
  // columns j = 32 ch ..., for every head
  float cb[4][4];
  zero(cb);
  if (!upper) mma_abt<N, 4>(cb, base + L::CS + 16 * rg * RN, base + L::BS + 32 * ch * RN);

  float accB[NBN][4], accC[NBN][4];
  zero(accB);
  zero(accC);
  bf16* mt = reinterpret_cast<bf16*>(raw + L::MW);
  bf16* wt = mt + QM * LDQ;
  bf16* wdt = wt + QM * LDQ;
  unsigned char* staged = raw + L::DX_OFF + warp * 16 * L::RX;

  for (int h = 0; h < H; ++h) {
    const int stg = h % L::STAGES, par = h & 1;
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();   // head h has landed; every warp is done with head h - 1's tiles
    {
      const int nx = h + L::STAGES - 1;
      if (nx < H) load_head(nx, nx % L::STAGES);
      cp_async_commit();
    }
    if (warp == 4 && h > 0) finish(h - 1, par ^ 1);   // warp 4 has no tile in (a)

    const uint32_t sb = base + L::ST + stg * L::STAGE;
    const unsigned char* sp = raw + L::ST + stg * L::STAGE;
    float* set = vec + par * L::SET;
    const Decays dc = chunk_decays(reinterpret_cast<const float*>(sp + L::DT_OFF), A[h]);
    if (warp == 0) {
      set[L::DTo + lane] = dc.d0;
      set[L::DTo + 32 + lane] = dc.d1;
      if (lane == 0) set[L::CEo] = dc.cend;
    }
    // this warp's rows r0, r0 + 8: cum, dt, exp(cum), exp(cum_end - cum)
    float ci[2], di[2], ei[2], de[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      ci[half] = at_pos(dc.c0, dc.c1, r0 + 8 * half);
      di[half] = at_pos(dc.d0, dc.d1, r0 + 8 * half);
      ei[half] = __expf(ci[half]);
      de[half] = __expf(dc.cend - ci[half]);
    }

    // -- ⟨h_s, G_e⟩, an eighth a warp ---------------------------------------
    {
      constexpr int HN = N / 8;
      float s = 0.f;
      for (int e = tid; e < P * HN; e += 256) {
        const int r = e / HN, cc = e % HN;
        const uint4 hv = *reinterpret_cast<const uint4*>(sp + L::H_OFF + r * RN + cc * 16);
        const uint4 gv = *reinterpret_cast<const uint4*>(sp + L::G_OFF + r * RN + cc * 16);
        const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hw[q]));
          const float2 bq = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[q]));
          s = fmaf(a.x, bq.x, fmaf(a.y, bq.y, s));
        }
      }
      s = warp_sum(s);
      if (lane == 0) set[L::HGo + warp] = s;
    }

    // -- (a) D = dY Xᵀ on this warp's 16 x 32 tile, then W = D ∘ L,
    //    M = (C·Bᵀ) ∘ L and W·dt_j into shared memory, and the row and
    //    column sums of R = W·dt_j ∘ C·Bᵀ below the diagonal ----------------
    {
      float rrow[2] = {0.f, 0.f}, rcol[4][2];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) rcol[nb][0] = rcol[nb][1] = 0.f;
      if (!upper) {
        float d[4][4];
        zero(d);
        mma_abt<P, 4>(d, sb + L::Y_OFF + 16 * rg * RP, sb + L::X_OFF + 32 * ch * RP);
        const float chalf = ch ? dc.c1 : dc.c0, dhalf = ch ? dc.d1 : dc.d0;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int jl = 8 * nb + 2 * tq, j = 32 * ch + jl;
          const float cj[2] = {__shfl_sync(FULL, chalf, jl), __shfl_sync(FULL, chalf, jl + 1)};
          const float dj[2] = {__shfl_sync(FULL, dhalf, jl), __shfl_sync(FULL, dhalf, jl + 1)};
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int k = r0 + 8 * half;
            float wv[2], mv[2], wd[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // the exponent is zeroed off the triangle first: exp never
              // sees a positive cum_k - cum_j
              const bool on = j + e <= k;
              const float l = on ? __expf(on ? ci[half] - cj[e] : 0.f) : 0.f;
              wv[e] = d[nb][2 * half + e] * l;
              mv[e] = cb[nb][2 * half + e] * l;
              wd[e] = wv[e] * dj[e];
              const float r = j + e < k ? wd[e] * cb[nb][2 * half + e] : 0.f;
              rrow[half] += r;
              rcol[nb][e] += r;
            }
            *reinterpret_cast<uint32_t*>(wt + k * LDQ + j) = pack_bf16(wv[0], wv[1]);
            *reinterpret_cast<uint32_t*>(mt + k * LDQ + j) = pack_bf16(mv[0], mv[1]);
            *reinterpret_cast<uint32_t*>(wdt + k * LDQ + j) = pack_bf16(wd[0], wd[1]);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float r = quad_sum(rrow[half]);
        if (tq == 0) set[L::RRo + ch * QM + r0 + 8 * half] = r;
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float r = rcol[nb][e];
          r += __shfl_xor_sync(FULL, r, 4);
          r += __shfl_xor_sync(FULL, r, 8);
          r += __shfl_xor_sync(FULL, r, 16);
          if (g == 0) set[L::RCo + rg * QM + 32 * ch + 8 * nb + 2 * tq + e] = r;
        }
    }
    __syncthreads();   // M, W and W·dt are complete

    // -- (b) g_j B_j = Σ_k M_kj dy_k + exp(cum_end - cum_j) G_e B_j on rows
    //    j, columns pc0 ...; dx, and x_j·g_j B_j, x_j·exp(..) G_e B_j --------
    {
      float mg[NBP][4], bg[NBP][4];
      zero(mg);
      zero(bg);
      mma_abt<N, NBP>(bg, base + L::BS + 16 * rg * RN, sb + L::G_OFF + pc0 * RN);
      // Mᵀ rows j, k >= j: the k-blocks from rg on
      mma_rows<NBP, true>(mg, lane_at_t(base + L::MW, RQ, 0, 16 * rg), RQ,
                          lane_at_b(sb + L::Y_OFF, RP, 0, pc0), RP, rg, QM / 16);
      float dsum[2] = {0.f, 0.f}, usum[2] = {0.f, 0.f};
      __syncwarp();   // the previous head's dx has left the staged rows
#pragma unroll
      for (int nb = 0; nb < NBP; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = r0 + 8 * half, p = pc0 + 8 * nb + 2 * tq;
          const float b0 = bg[nb][2 * half], b1 = bg[nb][2 * half + 1];
          const float g0 = fmaf(de[half], b0, mg[nb][2 * half]);
          const float g1 = fmaf(de[half], b1, mg[nb][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(staged + (g + 8 * half) * L::RX + (8 * nb + 2 * tq) * 2) =
              pack_bf16(di[half] * g0, di[half] * g1);
          const float2 xv = bf2_at(sp + L::X_OFF + j * RP + p * 2);
          dsum[half] = fmaf(xv.x, g0, fmaf(xv.y, g1, dsum[half]));
          usum[half] = fmaf(xv.x, b0, fmaf(xv.y, b1, usum[half]));
        }
      __syncwarp();
      {
        // dx rows j: whole 16-byte pieces of this warp's P / 2 columns
        constexpr int PR = P / 16;   // pieces a row
#pragma unroll
        for (int e = lane; e < 16 * PR; e += 32) {
          const int t = c0 + 16 * rg + e / PR;
          if (t < T)
            *reinterpret_cast<uint4*>(dx + (((size_t)b * T + t) * H + h) * P + pc0 + (e % PR) * 8) =
                *reinterpret_cast<const uint4*>(staged + (e / PR) * L::RX + (e % PR) * 16);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float ds = quad_sum(dsum[half]), us = quad_sum(usum[half]);
        if (tq == 0) {
          set[L::DPo + ch * QM + r0 + 8 * half] = ds;
          set[L::UPo + ch * QM + r0 + 8 * half] = de[half] * us;
        }
      }
    }

    // -- (c) h_iᵀ dy_i = exp(cum_i) dY·h_s + W·dt·B into dC, and
    //    exp(cum_i) (dy_i·h_s)·C_i -------------------------------------------
    {
      float wsum[2] = {0.f, 0.f};
      if (n_live) {
        float hy[NBN][4];
        zero(hy);
        mma_rows<NBN, false>(hy, lane_at_a(sb + L::Y_OFF, RP, 16 * rg, 0), RP,
                             lane_at_b(sb + L::H_OFF, RN, 0, nc0), RN, 0, P / 16);
#pragma unroll
        for (int nb = 0; nb < NBN; ++nb)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = r0 + 8 * half, n = nc0 + 8 * nb + 2 * tq;
            const float2 cv = bf2_at(raw + L::CS + i * RN + n * 2);
            const float h0v = hy[nb][2 * half], h1v = hy[nb][2 * half + 1];
            wsum[half] = fmaf(h0v, cv.x, fmaf(h1v, cv.y, wsum[half]));
            accC[nb][2 * half] = fmaf(ei[half], h0v, accC[nb][2 * half]);
            accC[nb][2 * half + 1] = fmaf(ei[half], h1v, accC[nb][2 * half + 1]);
          }
        // W·dt rows i, j <= i: the k-blocks up to rg
        mma_rows<NBN, false>(accC, lane_at_a(base + L::MW + 2 * QM * RQ, RQ, 16 * rg, 0), RQ,
                             lane_at_b(base + L::BS, RN, 0, nc0), RN, 0, rg + 1);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float ws = quad_sum(wsum[half]);
        if (tq == 0) set[L::WPo + ch * QM + r0 + 8 * half] = ei[half] * ws;
      }
    }

    // -- (d) dB_i += dt_i (exp(cum_end - cum_i) X·G_e + Wᵀ·C) --------------
    if (n_live) {
      float xg[NBN][4];
      zero(xg);
      mma_rows<NBN, false>(xg, lane_at_a(sb + L::X_OFF, RP, 16 * rg, 0), RP,
                           lane_at_b(sb + L::G_OFF, RN, 0, nc0), RN, 0, P / 16);
#pragma unroll
      for (int nb = 0; nb < NBN; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) xg[nb][q] *= de[q >> 1];
      // Wᵀ rows i, k >= i: the k-blocks from rg on
      mma_rows<NBN, true>(xg, lane_at_t(base + L::MW + QM * RQ, RQ, 0, 16 * rg), RQ,
                          lane_at_b(base + L::CS, RN, 0, nc0), RN, rg, QM / 16);
#pragma unroll
      for (int nb = 0; nb < NBN; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) accB[nb][q] = fmaf(di[q >> 1], xg[nb][q], accB[nb][q]);
    }
  }

  __syncthreads();
  if (warp == 4) finish(H - 1, (H - 1) & 1);
  if (n_live) {
#pragma unroll
    for (int nb = 0; nb < NBN; ++nb)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = c0 + r0 + 8 * half;
        if (t < T) {
          const size_t o = ((size_t)b * T + t) * N + nc0 + 8 * nb + 2 * tq;
          *reinterpret_cast<uint32_t*>(dB + o) = pack_bf16(accB[nb][2 * half], accB[nb][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(dC + o) = pack_bf16(accC[nb][2 * half], accC[nb][2 * half + 1]);
        }
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

template <int P, int N>
int launch_fma(BWD_PARAMS) {
  using E = float;
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

template <int P, int N>
int launch_mma(BWD_PARAMS) {
  using SL = StateMma<P, N>;
  using CL = ChunkMma<P, N>;
  auto k1 = ssd_bwd_state_mma_kernel<P, N>;
  auto k2 = ssd_bwd_chunk_mma_kernel<P, N>;
  static bool sized1 = false, sized2 = false;   // one attribute call per instantiation
  int e = size_once(k1, SL::BYTES, sized1);
  if (e) return e;
  e = size_once(k2, CL::BYTES, sized2);
  if (e) return e;
  const bf16* xe = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const bf16* be = static_cast<const bf16*>(Bm);
  const bf16* ce = static_cast<const bf16*>(Cm);
  const bf16* ye = static_cast<const bf16*>(dy);
  bf16* Sb = static_cast<bf16*>(S);
  bf16* Gb = static_cast<bf16*>(G);
  k1<<<dim3(H, Bsz, 2), SL::WARPS * 32, SL::BYTES, stream>>>(
      xe, sxb, sxt, sxh, dtf, sdb, sdt, sdh, Af, be, sbb, sbt, ce, scb, sct, ye, syb, syt, syh,
      static_cast<const float*>(h0), static_cast<const float*>(dhT), Sb, Gb,
      static_cast<float*>(dh0), H, T);
  e = (int)cudaGetLastError();
  if (e) return e;
  const int nc = (T + QM - 1) / QM;
  if (nc == 0) return 0;
  k2<<<dim3(nc, Bsz), 256, CL::BYTES, stream>>>(
      xe, sxb, sxt, sxh, dtf, sdb, sdt, sdh, Af, be, sbb, sbt, ce, scb, sct, ye, syb, syt, syh,
      Sb, Gb, static_cast<bf16*>(dx), static_cast<float*>(ddt), static_cast<bf16*>(dB),
      static_cast<bf16*>(dC), static_cast<float*>(dAp), H, T);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(int N, int dtype, BWD_PARAMS) {
#define BWD_CASE(NN)                                                               \
  case NN:                                                                         \
    return dtype == 1 ? launch_mma<P, NN>(BWD_ARGS) : launch_fma<P, NN>(BWD_ARGS);
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
// dt, A, the initial state and its gradient, ddt and the dA partials
// float32.  Inputs take the strides given (in elements; the last dim is
// contiguous; in bfloat16 every row start 16-byte aligned); the outputs are
// contiguous: dx (B, T, H, P), ddt (B, T, H), dB and dC (B, T, N), dAp
// (B, ceil(T / Q), H), with Q = 32 in float32 and 64 in bfloat16.  S and G
// are scratch of (B, H, ceil(T / Q), P, N) each, float32 or bfloat16.  h0 may be null (zero initial state; dh0 is then unused and
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

// The dynamic shared memory of the float32 state pass (kernel 0) and
// chunk pass (1), and of the bfloat16 state pass (2) and chunk pass (3),
// for (P, N); 0 for a (P, N) they do not take.
int ssd_scan_bwd_smem_bytes(int P, int N, int kernel) {
#define BWD_SMEM(PP, NN)                                                     \
  if (P == PP && N == NN) {                                                  \
    const int bytes[4] = {(int)StateSmem<PP, NN>::BYTES, (int)ChunkSmem<PP, NN>::BYTES, \
                          StateMma<PP, NN>::BYTES, ChunkMma<PP, NN>::BYTES}; \
    return kernel >= 0 && kernel < 4 ? bytes[kernel] : 0;                    \
  }
  BWD_SMEM(32, 16) BWD_SMEM(32, 32) BWD_SMEM(32, 64) BWD_SMEM(32, 128)
  BWD_SMEM(64, 16) BWD_SMEM(64, 32) BWD_SMEM(64, 64) BWD_SMEM(64, 128)
#undef BWD_SMEM
  return 0;
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
