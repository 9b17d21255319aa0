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
// x D x element size bytes (yi-6b decode: 32 KB a layer), at 64 GB/s a
// direction of PCIe Gen5 x16 on the data sheet; the reads come from HBM.
//
// Design:
//  * the destination is written through the card's mapped view of the
//    pinned host memory: the launcher asks cudaPointerGetAttributes which
//    memory each destination is, maps a pinned host pointer with
//    cudaHostGetDevicePointer, and refuses pageable host memory with
//    cudaErrorInvalidHostPointer (device memory is taken as it is);
//  * one block per (row, KV head, keys or values); its W = min(n, S)
//    positions are one or two contiguous runs of the slab, copied as
//    16-byte chunks with consecutive threads on consecutive chunks, so a
//    warp writes 512 contiguous bytes of host memory;
//  * pos and n are read from device memory by the blocks themselves: no
//    host query, so a captured launch replays correctly after the lengths
//    change, like the decode kernel's.
//
// kv_stream_copy is the host tier's bulk copy (cudaMemcpyAsync on a given
// stream), and kv_stream_host_register / _unregister pin a host range
// (cudaHostRegister, mapped): the window copies of a streamed role go
// through it so that a CUDA graph can capture them with no host-allocator
// bookkeeping on the capturing stream.
//
// Plain C interface (loaded with ctypes): each function returns a
// cudaError_t, the launch cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

// The address the card writes `p` through: p itself for device memory, the
// mapped address for pinned host memory; an error for anything else.
cudaError_t device_view(void* p, void** out) {
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
    e = cudaHostGetDevicePointer(out, p, 0);
    if (e != cudaSuccess) cudaGetLastError();
    return e;
  }
  return cudaErrorInvalidHostPointer;
}

// grid (B * H, 2): blockIdx.x = b * H + h, blockIdx.y = 0 keys, 1 values.
__global__ void __launch_bounds__(NT)
write_back_kernel(const uint4* __restrict__ src_k, const uint4* __restrict__ src_v,
                  uint4* __restrict__ dst_k, uint4* __restrict__ dst_v,
                  const int* __restrict__ pos, const int* __restrict__ n,
                  int H, int S, int chunks_per_row) {
  const int b = blockIdx.x / H;
  const int cnt = n[b];
  if (cnt <= 0) return;
  const int W = cnt < S ? cnt : S;
  // the first surviving position, reduced into [0, S)
  const long long first = ((long long)pos[b] + cnt - W) % S;
  const int start = (int)(first < 0 ? first + S : first);
  const uint4* src = blockIdx.y == 0 ? src_k : src_v;
  uint4* dst = blockIdx.y == 0 ? dst_k : dst_v;
  const long long slab = (long long)blockIdx.x * S * chunks_per_row;
  const long long total = (long long)W * chunks_per_row;
  for (long long e = threadIdx.x; e < total; e += NT) {
    const long long j = e / chunks_per_row;
    const long long c = e - j * chunks_per_row;
    long long slot = start + j;
    if (slot >= S) slot -= S;
    const long long off = slab + slot * chunks_per_row + c;
    dst[off] = src[off];
  }
}

}  // namespace

extern "C" {

// src_k/src_v: the (B, H, S, row_bytes) staging window on the device;
// dst_k/dst_v: the layer's slab of the cache, same shape, in pinned host
// (or device) memory; pos, n: (B,) int32 in device memory.  row_bytes must
// be a multiple of 16 and every pointer 16-byte aligned.
int kv_stream_write_back_launch(const void* src_k, const void* src_v, void* dst_k,
                                void* dst_v, const void* pos, const void* n, int B,
                                int H, int S, int row_bytes, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || row_bytes <= 0 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {src_k, src_v, dst_k, dst_v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  void* dk = nullptr;
  void* dv = nullptr;
  cudaError_t e = device_view(dst_k, &dk);
  if (e != cudaSuccess) return (int)e;
  e = device_view(dst_v, &dv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(B * H), 2);
  write_back_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src_k), static_cast<const uint4*>(src_v),
      static_cast<uint4*>(dk), static_cast<uint4*>(dv), static_cast<const int*>(pos),
      static_cast<const int*>(n), H, S, row_bytes / 16);
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

// Pin [p, p + bytes) of host memory, mapped into the card's address space.
int kv_stream_host_register(void* p, long long bytes) {
  if (bytes <= 0) return (int)cudaErrorInvalidValue;
  return (int)cudaHostRegister(p, (size_t)bytes, cudaHostRegisterMapped);
}

int kv_stream_host_unregister(void* p) { return (int)cudaHostUnregister(p); }

const char* kv_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
