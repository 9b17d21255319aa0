// KV write-back into pinned host memory, and the host tier's plumbing.
//
// kv_stream_write_back_launch: under a streamed host placement of the KV
// cache (`kv_host`), each layer computes on a device staging window that
// holds a copy of the layer's cache slab; the step writes its new keys and
// values into that window.  This kernel copies exactly those rows back
// into the layer's slab of the cache in pinned host memory: per row b, the
// positions [pos[b], pos[b] + n[b]) modulo the cache size S (the ring
// arithmetic of models/attention.py `_append_kv`; when n[b] > S only the
// last S positions survive), for every KV head, keys and values.  Decode
// writes one position a row (n = 1), a prefill dispatch new_lens[b] from
// offsets[b]; a row with n[b] = 0 writes nothing.
//
// No Pallas original: the reference leaves host<->device transfers to XLA
// (jax.device_put between memory kinds, src/repro/core/placement.py
// to_device/to_host).  Copying the whole slab back would double the PCIe
// bytes the planner prices for a streamed cache, and one cudaMemcpyAsync
// per (row, head, k/v) would be B x Hkv x 2 launches a layer.
//
// What bounds it on an H100: the PCIe writes, 2 x sum_b min(n[b], S) x Hkv
// x D x element size bytes (yi-6b decode: 16 KB a layer, prefill of 8 x
// 256 tokens: 4 MB), at 64 GB/s a direction of PCIe Gen5 x16 on the data
// sheet; the reads come from HBM.  A decode launch is launch-bound.
//
// Design:
//  * every surviving 16-byte chunk of the launch has one index g in a flat
//    space ordered (row b, keys then values, head, position, chunk), so
//    the chunks of one (row, head, k/v) run are consecutive; a grid-stride
//    loop gives chunk g to thread g mod (grid size): consecutive lanes of
//    a warp store consecutive chunks, so a warp writes 512 contiguous
//    bytes of host memory where the slab is contiguous (two 256-byte rows
//    of a decode step share a warp), and no lane idles while work is left;
//  * the grid is sized by the caller (kernels/kv_stream.py
//    write_back_blocks), not by (row, head), and capped at one block for
//    every 16 SMs: PCIe bounds a prefill dispatch's write-back with that
//    many, and the launch runs beside the layers' kernels, on a stream of
//    its own, where each SM and thread it holds is one they cannot use;
//  * each block first works out, once per row, the ring arithmetic
//    (surviving positions, first slot, where the row's chunks start in
//    the flat space) into shared memory, and a chunk finds its row by
//    binary search there, then its head, position and slot with 32-bit
//    arithmetic alone;
//  * pos and n are read from device memory by the blocks themselves: no
//    host query, so a captured launch replays correctly after the lengths
//    change, like the decode kernel's;
//  * the destination pointers are the card's view of the slab, resolved
//    once per slab (kv_stream_device_view: the mapped address of pinned
//    host memory, a device pointer as it is, pageable host memory refused
//    with cudaErrorInvalidHostPointer; kernels/kv_stream.py keeps it), not
//    once a launch.
//
// kv_stream_copy is the host tier's bulk copy (cudaMemcpyAsync on a given
// stream), and kv_stream_host_alloc / _free allocate and free a block of
// pinned host memory mapped for the card (cudaHostAlloc, exact size): the
// window copies of a streamed role go through it so that a CUDA graph can
// capture them with no host-allocator bookkeeping on the capturing stream,
// and a RESIDENT role's kernels read and write it in place through its
// mapped address.  cudaHostAlloc, not cudaHostRegister of pageable memory:
// on an H100 the card reads a registered range up to ~40 % slower in place
// (PERF.md §6, tools/mapped_reads.py).  kv_stream_empty_launch launches a
// kernel that does nothing, for the launch floor beside the write-back.
//
// Plain C interface (loaded with ctypes): each function returns a
// cudaError_t, a launch cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads a block: 8 warps
constexpr int MAX_ROWS = 2048;     // rows a block keeps the ring bounds of

// The positions a row with `cnt` new ones keeps (min(max(cnt, 0), S)) and
// the slot of the first, (pos + cnt - W) mod S, in [0, S).
__device__ __forceinline__ int survivors(int cnt, int S) {
  return cnt <= 0 ? 0 : (cnt < S ? cnt : S);
}
__device__ __forceinline__ int first_slot(int pos, int cnt, int W, int S) {
  const long long t = (long long)pos + cnt - W;
  if (t >= 0 && t < (1LL << 31)) return (int)t % S;   // the usual case, 32-bit
  const long long f = t % S;
  return (int)(f < 0 ? f + S : f);
}

// grid (blocks): chunk g of the flat space goes to thread g mod (blocks x NT).
// Each block first builds the rows' table in dynamic shared memory,
// (B + 1) + 2 B ints: where each row's chunks start, its first slot, its
// chunks a run.
__global__ void __launch_bounds__(NT)
write_back_kernel(const uint4* __restrict__ src_k, const uint4* __restrict__ src_v,
                  uint4* __restrict__ dst_k, uint4* __restrict__ dst_v,
                  const int* __restrict__ pos, const int* __restrict__ n,
                  int B, int H, int S, int C) {
  extern __shared__ int row_first[];                   // (B + 1)
  int* start = row_first + B + 1;                      // (B)
  int* run = start + B;                                // (B)
  if (threadIdx.x < 32) {
    // warp 0 scans the rows' chunk counts (2 H runs of W x C) into their
    // starts in the flat space
    const int lane = threadIdx.x;
    int carry = 0;
    if (lane == 0) row_first[0] = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      int mine = 0;
      if (b < B) {
        const int cnt = n[b];
        const int W = survivors(cnt, S);
        start[b] = first_slot(pos[b], cnt, W, S);
        run[b] = W * C;
        mine = 2 * H * W * C;
      }
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, mine, d);
        if (lane >= d) mine += up;
      }
      if (b < B) row_first[b + 1] = carry + mine;
      carry += __shfl_sync(0xffffffffu, mine, 31);
    }
  }
  __syncthreads();
  const int total = row_first[B];                      // < 2^31 (checked at launch)
  for (int g = blockIdx.x * NT + threadIdx.x; g < total; g += gridDim.x * NT) {
    // the row: the last b whose start is <= g (a row with no chunks has
    // the same start as the next one)
    int lo = 0, hi = B - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (row_first[mid] <= g) lo = mid; else hi = mid - 1;
    }
    const int b = lo;
    const int R = run[b];
    const int l = g - row_first[b];
    const int u = l / R;                     // keys: u < H, values: u >= H
    const int e = l - u * R;
    const int j = e / C;
    const int c = e - j * C;
    int slot = start[b] + j;
    if (slot >= S) slot -= S;
    const bool values = u >= H;
    const int h = values ? u - H : u;
    const long long off = (((long long)b * H + h) * S + slot) * C + c;
    (values ? dst_v : dst_k)[off] = __ldg((values ? src_v : src_k) + off);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// The address through which the card reads and writes p: p itself for
// device memory, the mapped address for pinned host memory registered
// mapped; cudaErrorInvalidHostPointer for pageable host memory.
int kv_stream_device_view(void* p, void** out) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: a later launch must not report it
    return (int)e;
  }
  if (attr.type == cudaMemoryTypeDevice || attr.type == cudaMemoryTypeManaged) {
    *out = p;
    return (int)cudaSuccess;
  }
  if (attr.type == cudaMemoryTypeHost) {
    e = cudaHostGetDevicePointer(out, p, 0);
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
  }
  return (int)cudaErrorInvalidHostPointer;
}

// src_k/src_v: the (B, H, S, row_bytes) staging window on the device;
// dst_k/dst_v: the card's view (kv_stream_device_view) of the layer's slab
// of the cache, same shape, in pinned host (or device) memory; pos, n:
// (B,) int32 in device memory; blocks: the grid, any size >= 1 (the
// loop strides over it).  row_bytes must be a multiple of 16, every
// pointer 16-byte aligned, B <= MAX_ROWS and B x 2 H S row_bytes / 16 +
// blocks x NT < 2^31 (the flat index is 32-bit).
int kv_stream_write_back_launch(const void* src_k, const void* src_v, void* dst_k,
                                void* dst_v, const void* pos, const void* n, int B, int H,
                                int S, int row_bytes, int blocks, void* stream) {
  if (B <= 0 || B > MAX_ROWS || H <= 0 || S <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      blocks <= 0 ||
      (long long)B * 2 * H * S * (row_bytes / 16) + (long long)blocks * NT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {src_k, src_v, dst_k, dst_v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * B + 1) * sizeof(int);
  write_back_kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src_k), static_cast<const uint4*>(src_v),
      static_cast<uint4*>(dst_k), static_cast<uint4*>(dst_v), static_cast<const int*>(pos),
      static_cast<const int*>(n), B, H, S, row_bytes / 16);
  return (int)cudaGetLastError();
}

// One launch of a kernel that does nothing, `blocks` blocks of NT threads.
int kv_stream_empty_launch(int blocks, void* stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// bytes from src to dst (device or pinned host memory, either way) on
// `stream`, asynchronously.
int kv_stream_copy(void* dst, const void* src, long long bytes, void* stream) {
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  if (bytes == 0) return (int)cudaSuccess;
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes, cudaMemcpyDefault,
                              static_cast<cudaStream_t>(stream));
}

// `bytes` of pinned host memory, mapped into the card's address space.
int kv_stream_host_alloc(void** out, long long bytes) {
  if (bytes <= 0) return (int)cudaErrorInvalidValue;
  return (int)cudaHostAlloc(out, (size_t)bytes, cudaHostAllocMapped);
}

int kv_stream_host_free(void* p) { return (int)cudaFreeHost(p); }

const char* kv_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
