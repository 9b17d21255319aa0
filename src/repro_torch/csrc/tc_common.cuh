// Tensor-core building blocks shared by the bf16 kernels (attention,
// decode, the SSD scan and its backward): cp.async copies into shared
// memory, ldmatrix, mma.sync m16n8k16 with bf16 operands and f32
// accumulators, the register repacking that keeps a score tile's softmax
// probabilities out of shared memory, and the bf16 hi + lo split of an f32
// operand.
//
// A warp's 16 x 8 accumulator tile gives lane l rows g = l / 4 and g + 8,
// columns 2 (l % 4) and + 1; the same lane's A fragment of a 16 x 16
// operand is rows g and g + 8, columns 2 (l % 4) + {0, 1, 8, 9}.  So the
// scores of two neighbouring 8-column tiles, rounded to bf16, are the A
// fragment of the next product over those 16 columns (pack_a).
//
// Every shared-memory tile row is D bf16 padded by 16 bytes (TcRow): the
// row stride is then 4 banks past a multiple of 32, so the eight row
// addresses of an ldmatrix hit eight distinct groups of four banks.
//
// The kernels' libraries are built per .cu file; kernels/_build.py hashes
// every csrc/*.cuh into each library's name, so an edit here rebuilds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

template <int D>
struct TcRow {
  static constexpr int LD = D + 8;     // elements
  static constexpr int RB = LD * 2;    // bytes
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; a false `full` fills
// the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a bf16 pair hi and the pair of what it leaves out, lo:
// a = hi.x + lo.x to ~2^-17 relative (the scan kernels' f32 operands)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<uint32_t*>(&h);
  const float2 f = __bfloat1622float2(h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// rows [r0, r0 + R) of an (n_rows, D) bf16 matrix into R padded rows at
// shared address dst, by all NT threads; rows past n_rows become zeros
template <int D, int R, int NT>
__device__ __forceinline__ void load_rows_async(uint32_t dst, const bf16* __restrict__ src,
                                                int r0, int n_rows) {
  constexpr int PER_ROW = D / 8, N = R * PER_ROW;
#pragma unroll
  for (int u = 0; u < (N + NT - 1) / NT; ++u) {
    const int e = threadIdx.x + u * NT;
    if (N % NT == 0 || e < N) {
      const int r = e / PER_ROW, c = e % PER_ROW;
      const bool in = r0 + r < n_rows;
      cp_async16(dst + r * TcRow<D>::RB + c * 16, src + (size_t)(in ? r0 + r : 0) * D + c * 8, in);
    }
  }
}

// s (16 x 8 NB) += A B^T: A is the warp's 16 rows at a_addr, B is 8 NB rows
// at b_addr, both D wide (a score tile: Q K^T, dO V^T, K Q^T, V dO^T)
template <int D, int NB>
__device__ __forceinline__ void mma_abt(float (&s)[NB][4], uint32_t a_addr, uint32_t b_addr) {
  constexpr int RB = TcRow<D>::RB;
  const int lane = threadIdx.x & 31;
  const uint32_t a_lane = a_addr + (lane & 15) * RB + (lane >> 4) * 16;
  const uint32_t b_lane = b_addr + ((lane & 7) + (lane >> 4) * 8) * RB + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_lane + kk * 32);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_lane + np * 16 * RB + kk * 32);
      mma16816(s[2 * np], a, b[0], b[1]);
      mma16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// A fragments (16 x 16 NB / 2) of a score tile's accumulators, in bf16
template <int NB>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[NB / 2][4], const float (&p)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    pa[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// o (16 x D) += P M: P in A fragments over 16 KB columns, M is 16 KB rows
// of D at m_addr, read transposed by ldmatrix (P V, P^T dO, dS^T Q, dS K)
template <int D, int KB>
__device__ __forceinline__ void mma_pm(float (&o)[D / 8][4], const uint32_t (&pa)[KB][4],
                                       uint32_t m_addr) {
  constexpr int RB = TcRow<D>::RB;
  const int lane = threadIdx.x & 31;
  const uint32_t m_lane = m_addr + ((lane & 7) + ((lane >> 3) & 1) * 8) * RB + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, m_lane + kk * 16 * RB + dp * 32);
      mma16816(o[2 * dp], pa[kk], b[0], b[1]);
      mma16816(o[2 * dp + 1], pa[kk], b[2], b[3]);
    }
  }
}

// Rows [row0, row0 + 16) of an (n_rows, D) bf16 matrix from a warp's
// accumulators, row g scaled by f[0] and row g + 8 by f[1]; staged in the
// warp's own 16 padded shared-memory rows so that every global store is a
// 16-byte vector.  Rows >= n_rows are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&o)[D / 8][4],
                                           const float (&f)[2], bf16* stage, int row0,
                                           int n_rows) {
  constexpr int LD = TcRow<D>::LD, PER_ROW = D / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + nb * 8 + 2 * tq) =
        pack_bf16(o[nb][0] * f[0], o[nb][1] * f[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + nb * 8 + 2 * tq) =
        pack_bf16(o[nb][2] * f[1], o[nb][3] * f[1]);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * PER_ROW; e += 32) {
    const int r = e / PER_ROW, c = e % PER_ROW;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
