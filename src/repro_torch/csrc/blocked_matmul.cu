// Tiled GEMM: out (M, N) = A (M, K) · B (K, N), f32 accumulation over a
// sequential K loop, cast to the output dtype.
//
// Replaces the Pallas kernel src/repro/kernels/blocked_matmul.py:
// blocked_matmul (body _mm_kernel).  It is the kernel of the paper's GEMM
// study (benchmarks/bench_gemm.py, Figs. 15-16): no model calls it.
//
// What bounds it on an H100: operations at the study's size.  N = 16384 in
// bf16 is 2·N³ = 8.8 TFLOP, 8.9 ms at 989 TFLOP/s on the tensor cores,
// against 3·N²·2 B = 1.6 GB read and written once, 0.48 ms at 3.35 TB/s.
// Re-reads of the A and B tiles come from the 50 MB L2 as much as from
// HBM; the traffic model (kernels/blocked_matmul.py) counts all of them as
// HBM bytes.
//
// Design (first version, right and simple):
//  * one block per (BM, BN) output tile; the Pallas grid's sequential K
//    dimension is a loop inside the block, with the f32 accumulators in
//    registers (the TPU kernel kept them in a VMEM scratch);
//  * each K step stages one A tile (BM, BK) and one B tile (BK, BN) in
//    shared memory with 16-byte loads, rows padded by 16 bytes against bank
//    conflicts: one stage, synchronous (no cp.async, TMA or wgmma yet);
//  * bfloat16 inputs: every product on the tensor cores with WMMA
//    16x16x16 (bf16 in, f32 accumulators), one 64x32 tile per warp;
//  * float32 inputs: FMAs on the CUDA cores (TF32 stays off), 8x8 outputs
//    per thread (rows ty + 16·i of the tile, two float4 column groups);
//  * a fixed set of (BM, BN, BK) instantiations (TILINGS below); any other
//    tiling, a shape that is not a multiple of it, or one whose tiles do
//    not fit the 227 KB a block may use returns cudaErrorInvalidValue.
//
// Plain C interface (loaded with ctypes): blocked_matmul_launch returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr size_t SMEM_MAX = 232448;   // 227 KB: the most one block may use

// Shared-memory layout of one stage: A (BM, BK + PAD) then B (BK, BN + PAD),
// PAD = 16 bytes of elements.  kernels/blocked_matmul.py::traffic_model's
// smem_bytes is this size.
template <typename T, int BM, int BN, int BK>
struct Tile {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr size_t bytes = (size_t)(BM * LDA + BK * LDB) * sizeof(T);
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// Copy an (R, C) tile of a row-major matrix (leading dimension ld, origin
// src) into shared memory with row stride LDS: 16-byte loads, up to eight a
// thread issued before their stores.
template <typename T, int R, int C, int LDS, int NT>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, long ld) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = C / VEC;
  constexpr int TOTAL = R * PER_ROW;
  static_assert(C % VEC == 0 && TOTAL % NT == 0, "tile not a multiple of the block's loads");
  constexpr int PER_THREAD = TOTAL / NT;
  constexpr int BATCH = PER_THREAD < 8 ? PER_THREAD : 8;
  static_assert(PER_THREAD % BATCH == 0, "loads per thread not a multiple of the batch");
#pragma unroll
  for (int b0 = 0; b0 < PER_THREAD; b0 += BATCH) {
    uint4 v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = (b0 + j) * NT + threadIdx.x;
      v[j] = __ldg(reinterpret_cast<const uint4*>(src + (i / PER_ROW) * ld +
                                                  (i % PER_ROW) * VEC));
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = (b0 + j) * NT + threadIdx.x;
      *reinterpret_cast<uint4*>(dst + (i / PER_ROW) * LDS + (i % PER_ROW) * VEC) = v[j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: warps in a (BM / 64) x (BN / 32) grid, each
// owning a 64x32 block of the output as 4 x 2 WMMA accumulators.
// ---------------------------------------------------------------------------

template <int BM, int BN>
__host__ __device__ constexpr int tc_threads() { return (BM / 64) * (BN / 32) * 32; }

template <int BM, int BN, int BK, typename OutT>
__global__ void __launch_bounds__(tc_threads<BM, BN>())
mm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             OutT* __restrict__ out, int N, int K) {
  using S = Tile<bf16, BM, BN, BK>;
  constexpr int NT = tc_threads<BM, BN>();
  constexpr int WN = BN / 32;
  static_assert(NT / 32 * 256 * sizeof(float) <= S::bytes,
                "epilogue staging does not fit the tiles' shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + BM * S::LDA;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / WN) * 64, wc = (warp % WN) * 32;
  const long row0 = (long)blockIdx.y * BM, col0 = (long)blockIdx.x * BN;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tiles
    stage<bf16, BM, BK, S::LDA, NT>(a_s, a + row0 * K + k0, K);
    stage<bf16, BK, BN, S::LDB, NT>(b_s, b + (long)k0 * N + col0, N);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> bfr[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wm::load_matrix_sync(bfr[j], b_s + kk * S::LDB + wc + 16 * j, S::LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> afr;
        wm::load_matrix_sync(afr, a_s + (wr + 16 * i) * S::LDA + kk, S::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wm::mma_sync(acc[i][j], afr, bfr[j], acc[i][j]);
      }
    }
  }

  // Epilogue: WMMA hides the accumulator layout, so each warp stores one
  // fragment at a time into its own 1 KB of shared memory, then its lanes
  // convert and write 16-element rows.
  __syncthreads();
  float* c_s = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wm::store_matrix_sync(c_s, acc[i][j], 16, wm::mem_row_major);
      __syncwarp();
      OutT* o = out + (row0 + wr + 16 * i) * N + col0 + wc + 16 * j;
#pragma unroll
      for (int e = lane; e < 256; e += 32) o[(e / 16) * (long)N + e % 16] = from_f<OutT>(c_s[e]);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: threads in a (BM / 8) x (BN / 8) grid, each
// owning rows ty + (BM / 8)·i and columns 4·tx + (BN / 2)·h + c of the tile.
// ---------------------------------------------------------------------------

template <int BM, int BN>
__host__ __device__ constexpr int fma_threads() { return BM * BN / 64; }

template <typename OutT>
__device__ __forceinline__ void store4(OutT* p, float x, float y, float z, float w);
template <>
__device__ __forceinline__ void store4<float>(float* p, float x, float y, float z, float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
template <>
__device__ __forceinline__ void store4<bf16>(bf16* p, float x, float y, float z, float w) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x, y), hi = __floats2bfloat162_rn(z, w);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

template <int BM, int BN, int BK, typename OutT>
__global__ void __launch_bounds__(fma_threads<BM, BN>())
mm_fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
              OutT* __restrict__ out, int N, int K) {
  using S = Tile<float, BM, BN, BK>;
  constexpr int NT = fma_threads<BM, BN>();
  constexpr int TX = BN / 8, TY = BM / 8, HALF = BN / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);
  float* b_s = a_s + BM * S::LDA;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const long row0 = (long)blockIdx.y * BM, col0 = (long)blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    stage<float, BM, BK, S::LDA, NT>(a_s, a + row0 * K + k0, K);
    stage<float, BK, BN, S::LDB, NT>(b_s, b + (long)k0 * N + col0, N);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a_s[(ty + TY * i) * S::LDA + k];
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + k * S::LDB + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + k * S::LDB + HALF + 4 * tx);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    OutT* o = out + (row0 + ty + TY * i) * N + col0 + 4 * tx;
    store4<OutT>(o, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    store4<OutT>(o + HALF, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename InT, typename OutT, int BM, int BN, int BK>
cudaError_t launch_t(const void* a, const void* b, void* out, int M, int N, int K,
                     cudaStream_t stream) {
  constexpr size_t smem = Tile<InT, BM, BN, BK>::bytes;
  if constexpr (smem > SMEM_MAX) {
    return cudaErrorInvalidValue;   // this tiling's tiles do not fit a block
  } else {
    constexpr bool tc = std::is_same<InT, bf16>::value;
    constexpr int nt = tc ? tc_threads<BM, BN>() : fma_threads<BM, BN>();
    static bool configured = false;
    const dim3 grid(N / BN, M / BM);
    if constexpr (tc) {
      auto kernel = mm_tc_kernel<BM, BN, BK, OutT>;
      if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        configured = true;
      }
      kernel<<<grid, nt, smem, stream>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                         static_cast<OutT*>(out), N, K);
    } else {
      auto kernel = mm_fma_kernel<BM, BN, BK, OutT>;
      if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        configured = true;
      }
      kernel<<<grid, nt, smem, stream>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                         static_cast<OutT*>(out), N, K);
    }
    return cudaGetLastError();
  }
}

template <typename InT, typename OutT>
cudaError_t launch_tiling(const void* a, const void* b, void* out, int M, int N, int K,
                          int bm, int bn, int bk, cudaStream_t s) {
#define REPRO_MM_TILING(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return launch_t<InT, OutT, BM, BN, BK>(a, b, out, M, N, K, s);
  // TILINGS: keep in step with kernels/blocked_matmul.py::TILINGS
  REPRO_MM_TILING(128, 128, 32)
  REPRO_MM_TILING(128, 128, 64)
  REPRO_MM_TILING(128, 128, 128)
  REPRO_MM_TILING(256, 128, 32)
  REPRO_MM_TILING(256, 128, 64)
  REPRO_MM_TILING(256, 128, 128)
  REPRO_MM_TILING(256, 128, 256)
#undef REPRO_MM_TILING
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtypes: 0 = float32, 1 = bfloat16.  a (M, K) and b (K, N) row-major and
// contiguous in in_dtype, out (M, N) in out_dtype.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// tiling with no instantiation, tiles over 227 KB, or a shape that is not a
// multiple of the tiling.
int blocked_matmul_launch(const void* a, const void* b, void* out, int M, int N, int K,
                          int bm, int bn, int bk, int in_dtype, int out_dtype,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn ||
      K % bk || (in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1)
    return out_dtype == 1
               ? (int)launch_tiling<bf16, bf16>(a, b, out, M, N, K, bm, bn, bk, s)
               : (int)launch_tiling<bf16, float>(a, b, out, M, N, K, bm, bn, bk, s);
  return out_dtype == 1 ? (int)launch_tiling<float, bf16>(a, b, out, M, N, K, bm, bn, bk, s)
                        : (int)launch_tiling<float, float>(a, b, out, M, N, K, bm, bn, bk, s);
}

const char* blocked_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
