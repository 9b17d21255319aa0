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
// evaluated chunk by chunk, Q = 32 positions at a time, with cum the
// inclusive cumsum of a inside the chunk and w_j = exp(cum_end - cum_j) dt_j:
//   y_i  = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) h·C_i
//   h   <- exp(cum_end) h + Σ_j w_j x_j ⊗ B_j
//
// What bounds it on an H100: bytes, at the serving shape.  One launch at
// (B 8, T 256, H 48, P 64, N 128) in bf16 reads x, the f32 state, dt, B
// and C and writes y and the state — about 52 MB, 15 µs at 3.35 TB/s —
// and does ~5 GFLOP of products: 5 µs on the tensor cores, but ~80 µs as
// f32 FMAs on the CUDA cores.  So the products must leave the CUDA cores.
//
// Two routes by dtype:
//  * bfloat16 (serving): every product on the tensor cores (mma.sync
//    m16n8k16, ldmatrix, cp.async from tc_common.cuh):
//      - B and C (one group, shared by all heads) are loaded and
//        G = C·Bᵀ is computed once per chunk for the HB heads of a block,
//        by four warps while the others start on C·hᵀ; each head's own
//        warps then apply its decay, M_h = G ∘ L_h ∘ dt, behind a barrier
//        of that head's warps only;
//      - a warp owns 16 state rows p of one head.  Its (16, N) slice of
//        the f32 state lives in its mma accumulators for the whole launch:
//        read once before the first chunk, written once after the last, so
//        the state crosses device memory once each way and a block reads
//        every state element it owns before it writes any (init_state and
//        state_out may be one buffer);
//      - y_i = exp(cum_i) C·hᵀ + M·x: C·hᵀ takes h straight from the
//        accumulators (their layout is the B operand's), split into a bf16
//        hi + lo pair, two products; M·x takes M as such a pair too (x is
//        exact).  One bf16 rounding of either operand, though it feeds only
//        y, puts single elements of y past its bf16 limit
//        (tests/test_torch_ssd_rounding.py emulates both);
//      - the state update h·exp(cum_end) + (x·w)ᵀ·B splits x·w into bf16
//        hi + lo (B is exact in bf16): the state never takes a rounded
//        product, and a chunk whose w is 0 throughout for a head (dt = 0)
//        skips its products, so such a row multiplies by exp(0) = 1 and
//        keeps its state bit for bit;
//      - the next chunk's x, dt, B and C stream in by cp.async (two
//        stages) while the current one is computed; two block barriers
//        a chunk;
//      - HB heads a block is chosen on the host (kernels/ssd_scan.py:
//        heads_per_block): the fewest heads that still fit the grid on the
//        SMs in one wave, at most 12 warps a block: 3 heads of P = 64 at
//        the serving shape, 128 blocks on 132 SMs.  A head index past H
//        is idle;
//  * float32 (the smoke configs, checks): f32 FMAs on the CUDA cores, one
//    block per (row, head), the state in shared memory; not redesigned.
//
// Positions past T are loaded as zeros with dt = 0: they add nothing and
// decay nothing, so a ragged last chunk, T < Q and T = 1 need no other
// case.
//
// Plain C interface (loaded with ctypes): ssd_scan_launch returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int NT = 256;        // threads per block (float32 kernel)
constexpr int Q = 32;          // positions per chunk: one warp, one lane each
constexpr int QS = Q + 4;      // row stride of the transposed x·dt and of M

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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
__global__ void __launch_bounds__(NT, 2) ssd_fma_kernel(
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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MAX_WARPS = 12;   // a block: HB heads x P / 16 warps
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of the bf16 kernel.  Two stages, each the chunk's
// Q rows of C and of B (N bf16), its Q rows of x for each of the HB heads
// (P bf16) and its Q dt for each head (f32); then M of each head, Q x Q
// as a bf16 hi and a bf16 lo matrix, then G = C·Bᵀ (f32).  bf16 rows are
// padded by 16 bytes (TcRow) for conflict-free ldmatrix.
template <int P, int N>
struct ScanSmem {
  static constexpr int RN = TcRow<N>::RB, RP = TcRow<P>::RB, RQ = TcRow<Q>::RB;
  static constexpr int c_off = 0, b_off = Q * RN, x_off = 2 * Q * RN;
  __host__ __device__ static constexpr int dt_off(int hb) { return x_off + hb * Q * RP; }
  __host__ __device__ static constexpr int stage(int hb) { return dt_off(hb) + hb * Q * 4; }
  static constexpr int GS = Q + 8;     // row stride of G = C·Bᵀ, floats
  __host__ __device__ static constexpr int g_off(int hb) { return 2 * stage(hb) + hb * 2 * Q * RQ; }
  __host__ __device__ static constexpr int bytes(int hb) { return g_off(hb) + Q * GS * 4; }
};

__device__ __forceinline__ float warp_incl_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

template <int P, int N>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1) ssd_mma_kernel(
    const bf16* __restrict__ x, long long sxb, long long sxt, long long sxh,   // x[b,t,h,p]
    const float* __restrict__ dt, long long sdb, long long sdt, long long sdh, // dt[b,t,h]
    const float* __restrict__ A,                                               // (H,)
    const bf16* __restrict__ Bm, long long sbb, long long sbt,                 // B[b,t,n]
    const bf16* __restrict__ Cm, long long scb, long long sct,                 // C[b,t,n]
    const float* h0,       // (B, H, P, N) or null (zero state); may alias h_out
    bf16* __restrict__ y,  // (B, T, H, P)
    float* h_out,          // (B, H, P, N) or null (state not returned)
    int H, int T, int HB) {
  using S = ScanSmem<P, N>;
  constexpr int RN = S::RN, RP = S::RP, RQ = S::RQ, WH = P / 16, NBN = N / 8;
  static_assert(Q == 32 && P % 16 == 0 && N % 16 == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char raw[];
  const uint32_t base = smem_addr(raw);
  const int stage_bytes = S::stage(HB), dt_off = S::dt_off(HB);
  const uint32_t m_addr = base + 2 * stage_bytes;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y, hb0 = blockIdx.x * HB;
  const int nh = min(HB, H - hb0);                   // heads this block owns
  const int hl = warp / WH, p0 = (warp % WH) * 16;   // this warp: head, first state row
  const bool active = hl < nh;
  const int h = hb0 + hl;
  const float Ah = active ? A[h] : 0.f;

  // chunk c0 into stage stg; positions past T and heads past H zero-filled
  auto load = [&](int c0, int stg) {
    const uint32_t sb = base + stg * stage_bytes;
    constexpr int CN = N / 8, XP = P / 8;            // 16-byte pieces a row
    for (int e = tid; e < 2 * Q * CN; e += nthreads) {
      const int which = e / (Q * CN), r = (e / CN) % Q, cc = e % CN, t = c0 + r;
      const bool in = t < T;
      const long long tt = in ? t : 0;
      const bf16* src = which ? Bm + b * sbb + tt * sbt : Cm + b * scb + tt * sct;
      cp_async16(sb + (which ? S::b_off : S::c_off) + r * RN + cc * 16, src + cc * 8, in);
    }
    for (int e = tid; e < HB * Q * XP; e += nthreads) {
      const int hh = e / (Q * XP), r = (e / XP) % Q, cc = e % XP, t = c0 + r;
      const bool in = t < T && hh < nh;
      const bf16* src = x + b * sxb + (in ? t * sxt + (hb0 + hh) * sxh : 0) + cc * 8;
      cp_async16(sb + S::x_off + (hh * Q + r) * RP + cc * 16, src, in);
    }
    for (int e = tid; e < HB * Q; e += nthreads) {
      const int hh = e / Q, r = e % Q, t = c0 + r;
      const bool in = t < T && hh < nh;
      cp_async4(sb + dt_off + e * 4, dt + b * sdb + (in ? t * sdt + (hb0 + hh) * sdh : 0), in);
    }
  };

  // this warp's state rows p0 + g, p0 + g + 8 in accumulator layout:
  // st[nb] is the 16 x 8 tile of columns 8 nb ... 8 nb + 7
  float st[NBN][4];
  const size_t hoff = (((size_t)b * H + h) * P + p0) * N;
#pragma unroll
  for (int nb = 0; nb < NBN; ++nb) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(0.f, 0.f);
      if (active && h0)
        v = *reinterpret_cast<const float2*>(h0 + hoff + (size_t)(g + 8 * half) * N + nb * 8 + 2 * tq);
      st[nb][2 * half] = v.x;
      st[nb][2 * half + 1] = v.y;
    }
  }

  const int nc = (T + Q - 1) / Q;
  if (nc > 0) load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q, stg = c & 1;
    cp_async_wait<0>();
    __syncthreads();   // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < nc) load(c0 + Q, stg ^ 1);
    cp_async_commit();
    const uint32_t sb = base + stg * stage_bytes;
    const float* dts = reinterpret_cast<const float*>(raw + stg * stage_bytes + dt_off);

    // -- G = C·Bᵀ, once for all the block's heads: four 16 x 16 tiles
    //    over the first warps, into shared memory ----------------------
    float* gsm = reinterpret_cast<float*>(raw + S::g_off(HB));
    for (int u = warp; u < 4; u += nwarps) {
      const int mt = u >> 1, np = u & 1;
      float gs[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) gs[nb][0] = gs[nb][1] = gs[nb][2] = gs[nb][3] = 0.f;
      mma_abt<N, 2>(gs, sb + S::c_off + mt * 16 * RN, sb + S::b_off + np * 16 * RN);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(gsm + (mt * 16 + g + 8 * half) * S::GS + np * 16 + nb * 8 +
                                     2 * tq) = make_float2(gs[nb][2 * half], gs[nb][2 * half + 1]);
    }

    // this head's decays, one position a lane
    float dtv = 0.f, cl = 0.f, ecl = 0.f, wl = 0.f, dec = 1.f;
    float ya[2][2][4];
    if (active) {
      dtv = dts[hl * Q + lane];
      cl = warp_incl_scan(Ah * dtv);
      const float cend = __shfl_sync(FULL, cl, Q - 1);
      ecl = expf(cl);                  // exp(cum_i)
      wl = expf(cend - cl) * dtv;      // w_j
      dec = expf(cend);                // exp(cum_end)

      // -- y = exp(cum_i) C·hᵀ (+ M·x below), Q rows x this warp's 16
      //    columns p; the first warps' C·Bᵀ runs beside it ------------
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) ya[mt][nb][0] = ya[mt][nb][1] = ya[mt][nb][2] = ya[mt][nb][3] = 0.f;
      const uint32_t c_lane = sb + S::c_off + (lane & 15) * RN + (lane >> 4) * 16;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        // hᵀ over state columns 16 kk ...: B fragments from the
        // accumulators, rows g (n-block 0) and g + 8 (n-block 1)
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          split_bf16(st[2 * kk][2 * half], st[2 * kk][2 * half + 1], bh[half][0], bl[half][0]);
          split_bf16(st[2 * kk + 1][2 * half], st[2 * kk + 1][2 * half + 1], bh[half][1], bl[half][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, c_lane + mt * 16 * RN + kk * 32);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            mma16816(ya[mt][nb], a, bh[nb][0], bh[nb][1]);
            mma16816(ya[mt][nb], a, bl[nb][0], bl[nb][1]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float e0 = __shfl_sync(FULL, ecl, mt * 16 + g);
        const float e1 = __shfl_sync(FULL, ecl, mt * 16 + g + 8);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          ya[mt][nb][0] *= e0;
          ya[mt][nb][1] *= e0;
          ya[mt][nb][2] *= e1;
          ya[mt][nb][3] *= e1;
        }
      }
    }
    __syncthreads();   // G is in shared memory

    if (active) {
      // -- M_h = G ∘ L_h ∘ dt_h, bf16 hi + lo, 0 above the diagonal: this
      //    head's warps build its four 16 x 16 tiles -------------------
      bf16* mhi = reinterpret_cast<bf16*>(raw + 2 * stage_bytes + hl * 2 * Q * RQ);
      bf16* mlo = mhi + Q * TcRow<Q>::LD;
      for (int u = warp % WH; u < 4; u += WH) {
        const int mt = u >> 1, np = u & 1;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int j = np * 16 + nb * 8 + 2 * tq;
          const float cj0 = __shfl_sync(FULL, cl, j), cj1 = __shfl_sync(FULL, cl, j + 1);
          const float d0 = __shfl_sync(FULL, dtv, j), d1 = __shfl_sync(FULL, dtv, j + 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = mt * 16 + g + 8 * half;
            const float ci = __shfl_sync(FULL, cl, i);
            const float2 gv = *reinterpret_cast<const float2*>(gsm + i * S::GS + j);
            // exp only ever sees cum_i - cum_j <= 0: the exponent is
            // zeroed off the triangle first
            const bool on0 = j <= i, on1 = j + 1 <= i;
            const float v0 = on0 ? gv.x * expf(on0 ? ci - cj0 : 0.f) * d0 : 0.f;
            const float v1 = on1 ? gv.y * expf(on1 ? ci - cj1 : 0.f) * d1 : 0.f;
            uint32_t hi, lo;
            split_bf16(v0, v1, hi, lo);
            *reinterpret_cast<uint32_t*>(mhi + i * TcRow<Q>::LD + j) = hi;
            *reinterpret_cast<uint32_t*>(mlo + i * TcRow<Q>::LD + j) = lo;
          }
        }
      }
      // this head's M is complete: a barrier of its WH warps only
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + hl), "r"(WH * 32) : "memory");

      const uint32_t xs = sb + S::x_off + hl * Q * RP;
      const uint32_t mq = m_addr + hl * 2 * Q * RQ + (lane & 15) * RQ + (lane >> 4) * 16;
      const uint32_t x_lane = xs + ((lane & 7) + ((lane >> 3) & 1) * 8) * RP + (lane >> 4) * 16 + p0 * 2;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        uint32_t bx[4];
        ldsm_x4_t(bx, x_lane + kk * 16 * RP);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int part = 0; part < 2; ++part) {        // M's hi, then its lo
            uint32_t a[4];
            ldsm_x4(a, mq + (part * Q + mt * 16) * RQ + kk * 32);
            mma16816(ya[mt][0], a, bx[0], bx[1]);
            mma16816(ya[mt][1], a, bx[2], bx[3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = c0 + mt * 16 + g + 8 * half;
          if (t < T) {
            bf16* yp = y + (((size_t)b * T + t) * H + h) * P + p0 + 2 * tq;
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              *reinterpret_cast<uint32_t*>(yp + nb * 8) =
                  pack_bf16(ya[mt][nb][2 * half], ya[mt][nb][2 * half + 1]);
          }
        }
      }

      // -- h <- exp(cum_end) h + (x·w)ᵀ B, x·w split into hi + lo --------
#pragma unroll
      for (int nb = 0; nb < NBN; ++nb) {
        st[nb][0] *= dec;
        st[nb][1] *= dec;
        st[nb][2] *= dec;
        st[nb][3] *= dec;
      }
      if (__any_sync(FULL, wl != 0.f)) {
        // A = (x w)ᵀ, rows p, columns j: x's rows j read transposed
        const uint32_t xa_lane =
            xs + ((lane & 7) + (lane >> 4) * 8) * RP + (p0 + ((lane >> 3) & 1) * 8) * 2;
        const uint32_t b_lane = sb + S::b_off + ((lane & 7) + ((lane >> 3) & 1) * 8) * RN + (lane >> 4) * 16;
#pragma unroll
        for (int kk = 0; kk < Q / 16; ++kk) {
          uint32_t ax[4];
          ldsm_x4_t(ax, xa_lane + kk * 16 * RP);
          const int j = kk * 16 + 2 * tq;
          const float w[4] = {__shfl_sync(FULL, wl, j), __shfl_sync(FULL, wl, j + 1),
                              __shfl_sync(FULL, wl, j + 8), __shfl_sync(FULL, wl, j + 9)};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ax[r]));
            const int k8 = (r >> 1) * 2;             // a0, a1: columns j; a2, a3: j + 8
            split_bf16(xv.x * w[k8], xv.y * w[k8 + 1], ahi[r], alo[r]);
          }
#pragma unroll
          for (int dp = 0; dp < N / 16; ++dp) {
            uint32_t bb[4];
            ldsm_x4_t(bb, b_lane + kk * 16 * RN + dp * 32);
            mma16816(st[2 * dp], ahi, bb[0], bb[1]);
            mma16816(st[2 * dp], alo, bb[0], bb[1]);
            mma16816(st[2 * dp + 1], ahi, bb[2], bb[3]);
            mma16816(st[2 * dp + 1], alo, bb[2], bb[3]);
          }
        }
      }
    }
  }

  if (active && h_out) {
#pragma unroll
    for (int nb = 0; nb < NBN; ++nb) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(h_out + hoff + (size_t)(g + 8 * half) * N + nb * 8 + 2 * tq) =
            make_float2(st[nb][2 * half], st[nb][2 * half + 1]);
    }
  }
}

// the launch's arguments after the kernel, as ssd_scan_launch takes them
#define SSD_PARAMS                                                                         \
  const void *x, long long sxb, long long sxt, long long sxh, const void *dt, long long sdb, \
      long long sdt, long long sdh, const void *A, const void *Bm, long long sbb,           \
      long long sbt, const void *Cm, long long scb, long long sct, const void *h0, void *y, \
      void *h_out, int Bsz, int T, int H, int HB, cudaStream_t stream
#define SSD_ARGS                                                                            \
  x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb, sbt, Cm, scb, sct, h0, y, h_out, Bsz, T, \
      H, HB, stream

template <int P, int N>
int launch_fma(SSD_PARAMS) {
  using S = Smem<P, N>;
  auto kernel = ssd_fma_kernel<float, P, N>;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kernel<<<dim3(H, Bsz), NT, S::BYTES, stream>>>(
      static_cast<const float*>(x), sxb, sxt, sxh, static_cast<const float*>(dt), sdb, sdt,
      sdh, static_cast<const float*>(A), static_cast<const float*>(Bm), sbb, sbt,
      static_cast<const float*>(Cm), scb, sct, static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), H, T);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_mma(SSD_PARAMS) {
  using S = ScanSmem<P, N>;
  constexpr int HB_MAX = MAX_WARPS / (P / 16);
  if (HB < 1 || HB > HB_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_mma_kernel<P, N>;
  static bool sized = false;   // one attribute call per instantiation
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes(HB_MAX));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  kernel<<<dim3((H + HB - 1) / HB, Bsz), HB * (P / 16) * 32, S::bytes(HB), stream>>>(
      static_cast<const bf16*>(x), sxb, sxt, sxh, static_cast<const float*>(dt), sdb, sdt,
      sdh, static_cast<const float*>(A), static_cast<const bf16*>(Bm), sbb, sbt,
      static_cast<const bf16*>(Cm), scb, sct, static_cast<const float*>(h0),
      static_cast<bf16*>(y), static_cast<float*>(h_out), H, T, HB);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(int N, int dtype, SSD_PARAMS) {
#define SSD_CASE(NN)                                                         \
  case NN:                                                                   \
    return dtype == 1 ? launch_mma<P, NN>(SSD_ARGS) : launch_fma<P, NN>(SSD_ARGS);
  switch (N) {
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
  }
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, B, C: dtype 0 = float32, 1 = bfloat16, with the strides given (in
// elements; the last dim is contiguous; in bfloat16 every row start
// 16-byte aligned).  dt and A are float32.  h0 may be null (zero initial
// state), h_out null (state not returned), and the two may be the same
// buffer.  HB: heads a block of the bfloat16 kernel carries, 1 ..
// 12 / (P / 16); the float32 kernel ignores it.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape the kernel does
// not take.
int ssd_scan_launch(const void* x, long long sxb, long long sxt, long long sxh,
                    const void* dt, long long sdb, long long sdt, long long sdh,
                    const void* A, const void* Bm, long long sbb, long long sbt,
                    const void* Cm, long long scb, long long sct, const void* h0,
                    void* y, void* h_out, int Bsz, int T, int H, int P, int N, int dtype,
                    int HB, void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || H <= 0 || T < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 32: return launch_p<32>(N, dtype, x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb,
                                 sbt, Cm, scb, sct, h0, y, h_out, Bsz, T, H, HB, stream_);
    case 64: return launch_p<64>(N, dtype, x, sxb, sxt, sxh, dt, sdb, sdt, sdh, A, Bm, sbb,
                                 sbt, Cm, scb, sct, h0, y, h_out, Bsz, T, H, HB, stream_);
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory the bf16 kernel launches with for (P, N) and
// HB heads a block; 0 for a (P, N) it does not take.
int ssd_scan_smem_bytes(int P, int N, int HB) {
#define SSD_SMEM(PP, NN) \
  if (P == PP && N == NN) return ScanSmem<PP, NN>::bytes(HB);
  SSD_SMEM(32, 16) SSD_SMEM(32, 32) SSD_SMEM(32, 64) SSD_SMEM(32, 128)
  SSD_SMEM(64, 16) SSD_SMEM(64, 32) SSD_SMEM(64, 64) SSD_SMEM(64, 128)
#undef SSD_SMEM
  return 0;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
