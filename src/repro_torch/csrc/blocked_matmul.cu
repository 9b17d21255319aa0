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
// Design.  One block per (BM, BN) output tile; the Pallas grid's
// sequential K dimension is a loop inside the block, with the f32
// accumulators in registers (the TPU kernel kept them in a VMEM scratch).
//  * bfloat16 inputs: warpgroup MMA (wgmma.mma_async m64n128k16, the only
//    way to the tensor cores' full rate) fed by TMA through a ring of
//    shared-memory stages:
//      - A is K-major (a row-major) and B MN-major (b row-major (K, N));
//        wgmma reads both from shared memory, B with its transpose flag;
//      - tiles land through cp.async.bulk.tensor (TMA) with the 128-byte
//        swizzle (64-byte for A when BK = 32: a 64-byte row), in boxes
//        whose inner edge is one swizzle span: A as BK / 64 boxes of
//        (BM, 64), B as two boxes of (BK, 64).  The tensor maps are made on
//        the host with cuTensorMapEncodeTiled, reached through
//        cudaGetDriverEntryPoint (no -lcuda), and passed as
//        __grid_constant__ parameters;
//      - the ring: per stage a "full" mbarrier (TMA completion, with the
//        stage's bytes expected) and an "empty" one (one arrival per
//        consumer warp); one producer warp keeps it full; stages: the most
//        (at most 4) whose tiles fit 227 KB, so (256, 128, 256) has one;
//      - two consumer warpgroups, each 64 (BM 128) or 2 x 64 (BM 256) rows
//        by BN = 128 columns; one wgmma group stays in flight, and a stage
//        is released when the group that read it has completed;
//      - the epilogue writes straight from the accumulator registers
//        (lane l of warp w of a warpgroup holds rows 16 w + l / 4 and + 8,
//        columns 8 i + 2 (l % 4) and + 1);
//      - tiles are visited in groups of 8 tile rows, column by column, so
//        the blocks in flight share A and B panels in L2;
//  * float32 inputs: FMAs on the CUDA cores (TF32 stays off), 8x8 outputs
//    per thread (rows ty + 16·i of the tile, two float4 column groups), one
//    synchronous shared-memory stage, rows padded by 16 bytes;
//  * a fixed set of (BM, BN, BK) instantiations (TILINGS below); any other
//    tiling, a shape that is not a multiple of it, or one whose tiles do
//    not fit the 227 KB a block may use returns cudaErrorInvalidValue.
//
// Plain C interface (loaded with ctypes): blocked_matmul_launch returns
// cudaGetLastError() after its launch; blocked_matmul_smem_bytes the
// shared memory a tiling's kernel allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr size_t SMEM_MAX = 232448;   // 227 KB: the most one block may use

// Shared-memory layout of the float32 route's one stage: A (BM, BK + PAD)
// then B (BK, BN + PAD), PAD = 16 bytes of elements.
// kernels/blocked_matmul.py::traffic_model's smem_bytes is this size for
// itemsize 4.
template <typename T, int BM, int BN, int BK>
struct Tile {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr size_t bytes = (size_t)(BM * LDA + BK * LDB) * sizeof(T);
};

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
// bfloat16 on the tensor cores: wgmma fed by a TMA / mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WG_CONSUMERS = 2;                  // consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 32;   // + one producer warp
constexpr int RASTER_ROWS = 8;                   // tile rows a raster group

// The ring of a tiling: a stage is one A tile (BM, BK) and one B tile
// (BK, BN), both swizzled as TMA writes them; then a full and an empty
// mbarrier per stage; 1024 bytes of slack align the ring to the 128-byte
// swizzle's 1024-byte period.  kernels/blocked_matmul.py::traffic_model's
// smem_bytes is this size for itemsize 2.
template <int BM, int BN, int BK>
struct Ring {
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = (int)((SMEM_MAX - 1024) / (STAGE + 16));
  static constexpr int ST = FIT < 1 ? 1 : FIT > 4 ? 4 : FIT;
  static constexpr size_t bytes = 1024 + (size_t)ST * (STAGE + 16);
  static constexpr int AKC = BK < 64 ? BK : 64;    // A box: AKC columns, one swizzle span
  static constexpr int A_BOX = BM * AKC * 2;
  static constexpr int MT = BM / (64 * WG_CONSUMERS);   // m64 tiles a warpgroup
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed; a phase that never
// completes (a fault in the ring) traps after ~2^26 tries, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) asm volatile("trap;");
  }
}

// a (box) tile of a 2-D tensor map at (c0 inner, c1 outer) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (1: 128 B, 2: 64 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swizzle << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across wgmma's
// asynchronous reads and writes
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, K-major) . B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <int BM, int BN, int BK, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, OutT* __restrict__ out, int M,
                int N, int K) {
  using R = Ring<BM, BN, BK>;
  constexpr int ST = R::ST, MT = R::MT;
  static_assert(BN == 128 && BM % (64 * WG_CONSUMERS) == 0 && BK % 16 == 0, "tile shape");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + ST * R::STAGE;     // full[ST], then empty[ST]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // tile (pid_m, pid_n): groups of RASTER_ROWS tile rows, column by column
  const int tiles_m = M / BM, tiles_n = N / BN;
  const int per_group = RASTER_ROWS * tiles_n, group = blockIdx.x / per_group;
  const int first_m = group * RASTER_ROWS;
  const int rows = min(tiles_m - first_m, RASTER_ROWS);
  const int pid_m = first_m + (blockIdx.x % per_group) % rows;
  const int pid_n = (blockIdx.x % per_group) / rows;
  const int m0 = pid_m * BM, n0 = pid_n * BN;
  const int KT = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (ST + s), WG_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG_CONSUMERS * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % ST;
        const uint32_t st = base + s * R::STAGE, full = bars + 8 * s;
        mbar_wait(bars + 8 * (ST + s), ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(full, R::STAGE);
#pragma unroll
        for (int c = 0; c < BK / R::AKC; ++c)
          tma_load_2d(st + c * R::A_BOX, &tma_a, full, kt * BK + c * R::AKC, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + R::A_BYTES + c * BK * 128, &tma_b, full, n0 + 64 * c, kt * BK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows (wg MT + mt) 64 .. + 64 of the tile
  const int wg = threadIdx.x >> 7;
  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % ST;
    const uint32_t st = base + s * R::STAGE;
    mbar_wait(bars + 8 * s, (kt / ST) & 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B: (BK, 64) boxes of 128-byte rows; 8-row groups 1024 B apart, the
      // second 64 columns BK · 128 B on
      const uint64_t db = gmma_desc(st + R::A_BYTES + kk * 16 * 128, BK * 128, 1024, 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row0 = (wg * MT + mt) * 64;
        // A: 16 columns at kk of K-major rows; 8-row groups 8 rows apart
        const uint64_t da =
            BK < 64 ? gmma_desc(st + row0 * 64 + kk * 32, 16, 512, 2)
                    : gmma_desc(st + (kk / 4) * R::A_BOX + row0 * 128 + (kk % 4) * 32, 16,
                                1024, 1);
        wgmma_m64n128k16(acc[mt], da, db);
      }
    }
    wgmma_commit();
    if constexpr (ST == 1) {
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bars + 8 * (ST + s));
    } else {
      // the group of tile kt - 1 has completed: its stage is free
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(bars + 8 * (ST + (kt - 1) % ST));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

  const int w4 = warp & 3, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long row = m0 + (wg * MT + mt) * 64 + w4 * 16 + g;
    OutT* o = out + row * N + n0 + 2 * tq;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      store2<OutT>(o + 8 * i, acc[mt][4 * i], acc[mt][4 * i + 1]);
      store2<OutT>(o + 8 * (long)N + 8 * i, acc[mt][4 * i + 2], acc[mt][4 * i + 3]);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) bf16 matrix, read in boxes of (box_rows, box_cols)
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// the shared memory a tiling's kernel allocates, by input dtype
template <typename InT, int BM, int BN, int BK>
constexpr size_t smem_of() {
  if constexpr (std::is_same<InT, bf16>::value) return Ring<BM, BN, BK>::bytes;
  else return Tile<InT, BM, BN, BK>::bytes;
}

template <typename InT, typename OutT, int BM, int BN, int BK>
cudaError_t launch_t(const void* a, const void* b, void* out, int M, int N, int K,
                     cudaStream_t stream) {
  constexpr size_t smem = smem_of<InT, BM, BN, BK>();
  if constexpr (smem > SMEM_MAX) {
    return cudaErrorInvalidValue;   // this tiling's tiles do not fit a block
  } else {
    static bool configured = false;
    if constexpr (std::is_same<InT, bf16>::value) {
      auto kernel = mm_wgmma_kernel<BM, BN, BK, OutT>;
      if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        configured = true;
      }
      constexpr int akc = Ring<BM, BN, BK>::AKC;
      CUtensorMap ta, tb;
      if (!tensor_map(&ta, a, M, K, BM, akc,
                      akc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) ||
          !tensor_map(&tb, b, K, N, BK, 64, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
      kernel<<<(M / BM) * (N / BN), WG_THREADS, smem, stream>>>(ta, tb, static_cast<OutT*>(out),
                                                                M, N, K);
    } else {
      auto kernel = mm_fma_kernel<BM, BN, BK, OutT>;
      if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        configured = true;
      }
      constexpr int nt = fma_threads<BM, BN>();
      kernel<<<dim3(N / BN, M / BM), nt, smem, stream>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), static_cast<OutT*>(out),
          N, K);
    }
    return cudaGetLastError();
  }
}

// TILINGS: keep in step with kernels/blocked_matmul.py::TILINGS
#define REPRO_MM_TILINGS(X) \
  X(128, 128, 32)           \
  X(128, 128, 64)           \
  X(128, 128, 128)          \
  X(256, 128, 32)           \
  X(256, 128, 64)           \
  X(256, 128, 128)          \
  X(256, 128, 256)

template <typename InT, typename OutT>
cudaError_t launch_tiling(const void* a, const void* b, void* out, int M, int N, int K,
                          int bm, int bn, int bk, cudaStream_t s) {
#define REPRO_MM_TILING(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return launch_t<InT, OutT, BM, BN, BK>(a, b, out, M, N, K, s);
  REPRO_MM_TILINGS(REPRO_MM_TILING)
#undef REPRO_MM_TILING
  return cudaErrorInvalidValue;
}

template <typename InT>
long smem_tiling(int bm, int bn, int bk) {
#define REPRO_MM_SMEM(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return (long)smem_of<InT, BM, BN, BK>();
  REPRO_MM_TILINGS(REPRO_MM_SMEM)
#undef REPRO_MM_SMEM
  return -1;
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

// The shared memory, in bytes, the kernel of tiling (bm, bn, bk) allocates
// for in_dtype (0 = float32, 1 = bfloat16), over 227 KB where the tiling
// is refused; -1 for a tiling with no instantiation.
long blocked_matmul_smem_bytes(int bm, int bn, int bk, int dtype) {
  return dtype == 1 ? smem_tiling<bf16>(bm, bn, bk) : smem_tiling<float>(bm, bn, bk);
}

const char* blocked_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
