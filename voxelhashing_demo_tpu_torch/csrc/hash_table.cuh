// What the hash table's kernels share (csrc/alloc.cu's K5b and
// csrc/maintain.cu's K10, K14 and K15): the bucket of a packed key, the
// free-stack pop, the gpu-scope flag and arrival atomics, a CTA's
// exclusive prefix sum, the bitonic sort of (entry, fill) pairs in shared
// memory and the co-resident CTAs of a kernel.  Included by
// both sources; kernels.py hashes this header into each source's library
// name, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_table {

constexpr int kEmptyKey = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

// gpu-scope acquire / release (the flag and the arrival), relaxed reads
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// BucketHash (ops/hash_ops.py) of a packed key: the unpacked block's
// spatial_hash, int32 products wrapping, the floor modulo (C's % truncates),
// then the floor division by the divisor (both positive): >= 0, not clamped
__device__ __forceinline__ int spatial_bucket(int key, int key_bits,
                                              int hash_buckets, int divisor) {
  const int mask = (1 << key_bits) - 1, bias = 1 << (key_bits - 1);
  const unsigned x = static_cast<unsigned>(((key >> (2 * key_bits)) & mask) - bias);
  const unsigned y = static_cast<unsigned>(((key >> key_bits) & mask) - bias);
  const unsigned z = static_cast<unsigned>((key & mask) - bias);
  const int h = static_cast<int>((x * 73856093u) ^ (y * 19349669u) ^ (z * 83492791u));
  int m = h % hash_buckets;
  if (m < 0) m += hash_buckets;
  return m / divisor;
}

// the row the free stack hands the r-th allocation:
// free_list[clamp(top - 1 - r, 0, N - 1)], read from L2
__device__ __forceinline__ int free_row(const int* free_list, int N, int top,
                                        int r) {
  return __ldcg(free_list + min(max(top - 1 - r, 0), N - 1));
}

// exclusive prefix sum of x over a CTA of kWarps warps; `total` gets the
// sum.  red holds kWarps ints and is free again when this returns
template <int kWarps>
__device__ __forceinline__ int cta_exclusive_sum(int x, int* red, int& total) {
  static_assert(kWarps <= 32, "one warp scans the warps' sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? red[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += o;
    }
    if (lane < kWarps) red[lane] = w;    // inclusive over the warps
  }
  __syncthreads();
  const int before = warp ? red[warp - 1] : 0;
  total = red[kWarps - 1];
  __syncthreads();
  return before + incl - x;
}

// ascending bitonic sort of entry[0, n2) (n2 a power of two), each fill
// moving with its entry, by a CTA of kThreads threads; every thread calls
// it after the entries are in shared memory and a __syncthreads
template <int kThreads>
__device__ __forceinline__ void sort_pairs(unsigned long long* entry,
                                           uint16_t* fill, int n2) {
  const int tid = threadIdx.x;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n2; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = entry[i], c = entry[ixj];
          if ((a > c) == ((i & k) == 0)) {
            entry[i] = c;
            entry[ixj] = a;
            const uint16_t t = fill[i];   // the fill moves with it
            fill[i] = fill[ixj];
            fill[ixj] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// co-resident CTAs of `kernel` at `threads` on the current device, asked
// once a device into cached[device]; the error on failure
template <typename Kernel, int N>
cudaError_t capacity_of(Kernel kernel, int threads, int (&cached)[N],
                        int* capacity) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= N) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = per_sm * sms;
  }
  *capacity = cached[dev];
  return cudaSuccess;
}

}  // namespace hash_table
