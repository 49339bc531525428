// The tile statuses of a one-launch scan over a table (csrc/fuse.cu's K6,
// csrc/maintain.cu's K10 and K14): each tile publishes a 64-bit status,
// the launch's tag << 32 | inclusive << 31 | value (its count, or with the
// flag the count of tiles 0..t), kStride 64-bit words from the next, in a
// scratch whose word 0 is the epoch word (the epoch in the high half).
// The tag is 0x80000000 | the epoch's low 31 bits, never 0, so a zeroed
// scratch holds no status.  A status is one 64-bit word, written and read
// whole.  kernels.py hashes this header into each source's library name.

#pragma once

#include <cuda_runtime.h>

namespace tile_status {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kInclusive = 1ull << 31;
constexpr unsigned kValueMask = 0x7fffffffu;
constexpr int kBackoffNs = 32;    // the sleep between polls of the statuses

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long make_status(unsigned tag,
                                                          bool inclusive,
                                                          int value) {
  return (static_cast<unsigned long long>(tag) << 32) |
         (inclusive ? kInclusive : 0ull) | static_cast<unsigned>(value);
}

// The counts of the tiles before `tile` (decoupled look-back): warp-wide,
// 32 predecessors' statuses a round (lane l the one l + 1 tiles back; one
// past tile 0 reads as an inclusive 0), waiting until all carry this
// launch's tag, summed up to the nearest that holds its inclusive prefix.
template <int kStride>
__device__ __forceinline__ int look_back(const unsigned long long* status,
                                         int tile, unsigned tag, int lane) {
  int sum = 0;
  for (int top = tile - 1;; top -= 32) {
    const int k = top - lane;
    unsigned long long s;
    for (;;) {
      s = k >= 0 ? load_status(status + kStride * k)
                 : make_status(tag, true, 0);
      if (__all_sync(kFull, static_cast<unsigned>(s >> 32) == tag)) break;
      __nanosleep(kBackoffNs);
    }
    const unsigned inc = __ballot_sync(kFull, (s & kInclusive) != 0ull);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    sum += __reduce_add_sync(
        kFull, lane <= stop ? static_cast<int>(s & kValueMask) : 0);
    if (inc) return sum;
  }
}

// Tables of at most kSnapTiles tiles, one CTA a tile (all co-resident):
// every tile's count from one snapshot of all the statuses (kSnapTiles /
// 32 a lane, loaded together), polled until all carry this launch's tag:
// the counts of the tiles before `tile` and of all of them.
template <int kStride, int kSnapTiles>
__device__ __forceinline__ int2 snapshot(const unsigned long long* status,
                                         int n_tiles, int tile, unsigned tag,
                                         int lane) {
  constexpr int kPer = kSnapTiles / 32;
  for (;;) {
    unsigned long long s[kPer];
    bool ready = true;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int k = lane + 32 * q;
      s[q] = k < n_tiles ? load_status(status + kStride * k)
                         : make_status(tag, false, 0);
      ready &= static_cast<unsigned>(s[q] >> 32) == tag;
    }
    if (__all_sync(kFull, ready)) {
      int before = 0, all = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int v = static_cast<int>(s[q] & kValueMask);
        all += v;
        if (lane + 32 * q < tile) before += v;
      }
      return make_int2(__reduce_add_sync(kFull, before),
                       __reduce_add_sync(kFull, all));
    }
    __nanosleep(kBackoffNs);
  }
}

}  // namespace tile_status
