// Memory microbenchmark kernels: a streaming read (sum) and a streaming
// write (fill) over device memory or pinned host memory read in place, and
// a one-thread dependent-load chase.
//
// Not a port of a Pallas kernel: the reference measures these with XLA
// loops (benchmarks/bench_membw.py: jnp.sum and jnp.full_like;
// benchmarks/bench_latency.py: a fori_loop chase).  PyTorch has no single
// call for them: torch.sum of a pinned host tensor copies it to the card
// first, and a chase of 2048 dependent loads written with tensor indexing
// would time 2048 launches, not the loads.
//
// What bounds them on an H100: the read and the fill are bytes over the
// tier's link (3.35 TB/s HBM, 64 GB/s a direction of PCIe Gen5 x16 for
// pinned host memory); the chase is one load's latency times the chain.
//
// Design:
//  * the pointer may be device memory or pinned host memory: the launcher
//    asks cudaPointerGetAttributes which it is, maps a pinned host pointer
//    with cudaHostGetDevicePointer, and refuses anything else (pageable
//    host memory the card cannot read) with cudaErrorInvalidHostPointer;
//  * read and fill are grid-stride loops of 16-byte accesses, four in
//    flight a thread, four blocks of 256 threads per SM; the read sums in
//    f32 per thread (each thread sees at most a few thousand elements) and
//    per block, then in f64 over the blocks: the last block to finish (a
//    counter in the call's own scratch, zeroed on the call's stream, so
//    reads on other streams at the same time keep their own) adds the
//    block sums in a fixed order and writes the result, so a sum is
//    deterministic and needs no zeroed output;
//  * the chase is one thread walking idx = perm[idx] `steps` times from
//    the index held in device memory at `pos`, and writing the last index
//    back there, so no load can be skipped or overlapped and the next call
//    goes on along the cycle: every call touches lines no call before it
//    touched (a chase that restarted at one index would walk the same
//    2048 lines each call, and L2 would hold them).
//
// Plain C interface (loaded with ctypes): each *_launch returns
// cudaGetLastError() after its launch, or the error of the pointer check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 4096;   // keep in step with kernels/membench.py

// The address the card reads `p` through: p itself for device memory, the
// mapped address for pinned host memory; an error for anything else.
cudaError_t device_view(const void* p, const void** out) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: the launch below must not report it
    return e;
  }
  if (attr.type == cudaMemoryTypeDevice || attr.type == cudaMemoryTypeManaged) {
    *out = p;
    return cudaSuccess;
  }
  if (attr.type == cudaMemoryTypeHost) {
    void* d = nullptr;
    e = cudaHostGetDevicePointer(&d, const_cast<void*>(p), 0);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
    *out = d;
    return cudaSuccess;
  }
  return cudaErrorInvalidHostPointer;
}

int grid_for(long long n4) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long g = (long long)sms * 4;
  const long long need = (n4 + NT - 1) / NT;
  if (g > need) g = need;
  if (g > MAX_BLOCKS) g = MAX_BLOCKS;
  return g < 1 ? 1 : (int)g;
}

__device__ __forceinline__ float sum4(float4 v) { return (v.x + v.y) + (v.z + v.w); }

__global__ void __launch_bounds__(NT)
read_kernel(const float* __restrict__ p, long long n, double* __restrict__ partial,
            double* __restrict__ out, unsigned int* __restrict__ blocks_done) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * NT;
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  float s = 0.0f;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const float4 v0 = p4[i], v1 = p4[i + stride], v2 = p4[i + 2 * stride],
                 v3 = p4[i + 3 * stride];
    s += (sum4(v0) + sum4(v1)) + (sum4(v2) + sum4(v3));
  }
  for (; i < n4; i += stride) s += sum4(p4[i]);
  if (blockIdx.x == 0 && threadIdx.x < n % 4) s += p[4 * n4 + threadIdx.x];

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __shared__ float warp_sums[NT / 32];
  __shared__ bool last;
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double b = 0.0;
    for (int w = 0; w < NT / 32; ++w) b += warp_sums[w];
    partial[blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(blocks_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block adds the block sums: thread t takes blocks t, t + NT, ...
  // (read from L2, where the other blocks' writes are), then a fixed tree
  __threadfence();
  double t = 0.0;
  for (unsigned int blk = threadIdx.x; blk < gridDim.x; blk += NT) t += __ldcg(partial + blk);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __shared__ double warp_totals[NT / 32];
  if (threadIdx.x % 32 == 0) warp_totals[threadIdx.x / 32] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < NT / 32; ++w) total += warp_totals[w];
    *out = total;
  }
}

__global__ void __launch_bounds__(NT)
fill_kernel(float* __restrict__ p, long long n, float value) {
  float4* p4 = reinterpret_cast<float4*>(p);
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * NT;
  const float4 v = make_float4(value, value, value, value);
  long long i = (long long)blockIdx.x * NT + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    p4[i] = v;
    p4[i + stride] = v;
    p4[i + 2 * stride] = v;
    p4[i + 3 * stride] = v;
  }
  for (; i < n4; i += stride) p4[i] = v;
  if (blockIdx.x == 0 && threadIdx.x < n % 4) p[4 * n4 + threadIdx.x] = value;
}

__global__ void chase_kernel(const int* __restrict__ perm, int steps, int* __restrict__ pos) {
  int idx = *pos;
  for (int s = 0; s < steps; ++s) idx = perm[idx];
  *pos = idx;
}

}  // namespace

extern "C" {

// Sum of n floats at p (device or pinned host memory) into *out (one double
// on the device).  partial holds at least MAX_BLOCKS doubles of scratch on
// the device, and counter one unsigned int, which this call zeroes on
// `stream` before its launch.  p must be 16-byte aligned.
int membench_read_launch(const void* p, long long n, void* partial, void* out,
                         void* counter, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const void* d = nullptr;
  cudaError_t e = device_view(p, &d);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(counter, 0, sizeof(unsigned int), s);
  if (e != cudaSuccess) return (int)e;
  read_kernel<<<grid_for(n / 4 + 1), NT, 0, s>>>(
      static_cast<const float*>(d), n, static_cast<double*>(partial),
      static_cast<double*>(out), static_cast<unsigned int*>(counter));
  return (int)cudaGetLastError();
}

// Set n floats at p (device or pinned host memory) to value.
int membench_fill_launch(void* p, long long n, float value, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const void* d = nullptr;
  const cudaError_t e = device_view(p, &d);
  if (e != cudaSuccess) return (int)e;
  fill_kernel<<<grid_for(n / 4 + 1), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(const_cast<void*>(d)), n, value);
  return (int)cudaGetLastError();
}

// Walk idx = perm[idx] `steps` times from *pos (perm: n int32 in device or
// pinned host memory, each entry in [0, n); pos: one int32 in device
// memory, in [0, n)) and write the last index back to *pos.
int membench_chase_launch(const void* perm, int steps, void* pos, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  const void* d = nullptr;
  const cudaError_t e = device_view(perm, &d);
  if (e != cudaSuccess) return (int)e;
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(d), steps, static_cast<int*>(pos));
  return (int)cudaGetLastError();
}

const char* membench_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
