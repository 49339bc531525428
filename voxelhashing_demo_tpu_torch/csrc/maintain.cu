// The map's free and restore paths for Hopper (sm_90a), three kernels:
//
//   gc_free (K10): garbage collection.  The stale test of every table
//     entry (allocated, every voxel weight of its row below min_weight,
//     and with an age gate frame_idx - last_seen >= min_age), the stale
//     rank in table order capped at max_free, the freed rows pushed on the
//     free stack, the freed entries cleared and every bucket re-compacted
//     stably, the fills and free_top.  Replaces what XLA fused on the TPU
//     in voxelhashing_demo_tpu/ops/hash_ops.py: garbage_collect (:613) and
//     its tail _free_marked (:566).
//   evict_free (K14): eviction, the same free tail with the stale test
//     frame_idx - last_seen > max_age (strict) and cap max_evict, and each
//     freed entry's key, tsdf and weight rows and born copied out at its
//     rank, the rows past the count padding.  Replaces evict_stale (:663).
//     One kernel body, instantiated twice.
//   restore_rows (K15): restore.  Each key probes its bucket (lookup_keys,
//     :230); the rows of found keys are weight-merged; the new keys are
//     ranked in their buckets in stable bucket order (bucket, input
//     position), given heap rows from the free stack and written, their
//     payload copied.  Replaces restore_blocks (:715).
//
// No PyTorch call computes any of the three.
//
// K10 / K14.  One launch, no grid barrier: csrc/fuse.cu's K6 tile scan.
// The table is cut into tiles of kTileBuckets whole buckets (a bucket
// never straddles a tile, so re-compaction is local), CTA b taking tiles
// b, b + gridDim.x, ...; the grid is one CTA a tile up to the CTAs the
// card holds at once.  A thread holds kBucketsPerThread buckets of its
// tile (bucket k * kThreadsF + t: a warp's loads coalesce, 16 bytes a
// bucket at bucket_size 4).  Per tile:
//   1. every slot's key and ptr, with an age test the live rows'
//      last_seen (one dependent round trip);
//   2. K10: the live entries that pass the age test go on a list in
//      shared memory and the CTA's warps test their rows, a warp a row
//      (every voxel's weight < min_weight: a NaN weight keeps the row, as
//      torch's amax does), all of a row's loads in one round trip.  Only
//      the rows that can be stale are read: the row maxima of all
//      num_blocks rows are what the plain version spends its time on;
//   3. the stale entries ranked by warp ballots and a scan of the
//      (bucket item, warp) segments; the tile's count published as a
//      64-bit tagged status; the stale entries of the tiles before it
//      from one snapshot of every status (at most kSnapTiles tiles, one
//      CTA each: the flagship's 65 536 buckets are 128 tiles) or a
//      decoupled look-back;
//   4. an entry ranked below the cap is freed: its ptr pushed at free_top
//      + rank (a push past the stack's end is dropped), K14 writes its key
//      and born at the rank and lists its row, the entry is cleared; every
//      bucket of the tile re-compacted stably (a slot is rewritten only
//      where it changes) and its fill written;
//   5. K14: the CTA's warps copy the listed rows' tsdf and weight out, a
//      warp a row.
// Every CTA reads free_top before it publishes its first status; only the
// CTA of the last tile, which learns the total after every tile has
// published, writes free_top += n and n.  K14's rows [n, max_evict) are
// written once n is known, EMPTY_KEY, zeros and 0, by the whole grid:
// K14 takes at least kSnapTiles tiles (those past the table empty), so
// every multiprocessor writes its share.  A CTA without a tile of its own
// could read the epoch after the last tile's CTA raised it, and wait for
// statuses that never come: every CTA holds a tile.
// The scratch is K6's layout, a separate one persisting a device and
// stream (hash_ops._maintain_scratch): the epoch word, raised by the CTA
// of the last tile, and the statuses, which the epoch's tag makes stale.
//
// K15.  One cooperative launch over a scratch that persists a device and
// stream, left as found (the count and the arrival 0; the epoch runs on),
// K5b's structure (csrc/alloc.cu, its phases A-C), its bucket hash and
// free-stack pop shared through csrc/hash_table.cuh:
//   A. the grid: a lane a key, its bucket's slots, ptrs and fill loaded in
//      one round trip; a found key is accepted and listed with its row; a
//      new key is listed as the 64-bit (bucket, input position) with its
//      bucket's fill (one atomic a warp for each list);
//   B. the CTA that arrives last sorts the listed entries (at most
//      kMaxRestore, a bitonic sort in shared memory): the order is the
//      plain version's stable argsort of the bucket.  It ranks each in its
//      bucket, counts alloc_rank over those that fit, writes the key and
//      the row free_list[free_top - 1 - alloc_rank] at bucket * S + slot
//      where alloc_rank < free_top, adds to the fills, lists the rows and
//      their sources, writes free_top and raises the epoch;
//   C. every CTA, after the epoch, a warp a row over the grid: the found
//      rows merged, the inserted rows' payload copied in with last_seen,
//      band_min and born.  A warp loads its share of a row's inputs
//      before it stores any (a store could alias a later load, so the
//      compiler would not hoist them): a row is one round trip.  (The
//      first version merged each found row in phase A by the warp that
//      probed it, one after another, the loads of each 16-byte step after
//      the stores of the last: 57-72 us on a 278-key batch, PERF.md.)
// A key that is dropped (its bucket full, the heap empty) or EMPTY_KEY
// writes nothing.  No host read in any of the three; the counts stay on
// the device.
//
// Rounding (K15's merge): old_t * old_w and t * w each rounded, then their
// sum, then an IEEE divide by clamp(old_w + w, min=1e-12) where w > 0;
// merged_w = clamp(old_w + w, max=max_weight) with torch's NaN rule;
// band_min the NaN-propagating min of |merged_t| where merged_w > 0 (inf
// elsewhere), as torch's amin.  The round-to-nearest intrinsics keep nvcc
// from contracting any of it.  K10 and K14 are integer work and copies.
//
// Bound: bytes.  K10 must read every slot's key and ptr (8 B a slot:
// 2.1 MB at the flagship), the last_seen of the live rows, and the weight
// rows of the live rows that pass the age test; it writes the fills, the
// changed slots and the pushed stack entries.  K14 reads the same less the
// weights, plus each evicted row's tsdf, weight and born, and writes
// max_evict padded rows (2 x 4 KB each at V = 512: 16 MB at max_evict
// 2048).  K15 reads the R keys, their buckets, each found row twice over
// (the map's and the input's) and each inserted row's input, and writes
// the merged and inserted rows.  chip_smoke.py counts each from its run's
// data.  Below a few MB what remains is the launch, two or three load
// round trips and the exchange of the tiles' counts (K10, K14) or one
// grid-wide arrival (K15).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_table.cuh"
#include "tile_status.cuh"

namespace {

using hash_table::kEmptyKey;
using hash_table::kFull;
using tile_status::kBackoffNs;
using tile_status::kInclusive;
using tile_status::kValueMask;
using tile_status::load_status;
using tile_status::make_status;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp's NaN rule: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
// torch.amin's NaN rule: a NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float warp_nan_min(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = nan_min(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

constexpr int kFreePtr = -1;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// K10 / K14
// ---------------------------------------------------------------------------

constexpr int kThreadsF = 256;
constexpr int kWarpsF = kThreadsF / 32;
constexpr int kBucketsPerThread = 2;
constexpr int kTileBuckets = kThreadsF * kBucketsPerThread;   // buckets a tile
constexpr int kSegmentsF = kBucketsPerThread * kWarpsF;  // (item, warp) segments
constexpr int kMaxSlots = 8;                    // bucket_size at most
constexpr int kRowChunk = 4;     // 16-byte loads a lane of a row it holds at once
constexpr int kTileSlots = kTileBuckets * kMaxSlots;

// the scratch: K6's layout (csrc/fuse.cu, csrc/tile_status.cuh): word 0
// the epoch word, then a status every kStatusStride words
constexpr int kSnapTiles = 128;
constexpr int kStatusStride = 16;

struct FreeParams {
  int* keys;               // (nb * S,) table keys
  int* ptrs;               // (nb * S,) table rows
  int* bucket_fill;        // (nb,)
  int* free_list;          // (N,) stack of free rows
  int* free_top;           // ()
  const float* tsdf;       // (N, V)
  const float* weight;     // (N, V)
  const int* last_seen;    // (N,)
  const int* born;         // (N,)
  int* n_out;              // () the entries freed
  const int* stamp_ptr;    // () frame_idx on the device, or null: `stamp`
  int* out_keys;           // K14: (cap,) keys, then (cap,) born
  int* out_born;
  float* out_tsdf;         // K14: (cap, V) tsdf, then (cap, V) weight
  float* out_weight;
  unsigned long long* scratch;   // the epoch word, then n_tiles statuses
  int nb, S, N, V, n_tiles, cap, stamp;
  int gate_age, age;       // K10: frame - last_seen >= age when gate_age;
                           // K14: frame - last_seen > age
  int snap;                // at most kSnapTiles tiles, each its own CTA
  int vec_slots;           // S == 4 and the table 16-byte aligned
  int vec_rows;            // V % 4 == 0 and the rows 16-byte aligned
  float min_weight;
};

struct FreeShared {
  int list_row[kTileSlots];   // K10: rows to test; K14: rows to copy (-1: zeros)
  int list_at[kTileSlots];    // K10: their slot in the tile; K14: their rank
  unsigned char below[kTileSlots];   // K10: the row's weights all < min_weight
  int seg[kSegmentsF];
  int n_list, before, through, top, count;
};

// a status is written with release semantics: the free_top this thread
// read before is ordered before it
__device__ __forceinline__ void publish_status(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.gpu.b64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// K10's row test, by a warp: every voxel weight of `row` < min_weight
__device__ __forceinline__ bool row_below(const FreeParams& P, int row) {
  bool below = true;
  const float* w = P.weight + static_cast<int64_t>(row) * P.V;
  if (P.vec_rows) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll 4
    for (int j = threadIdx.x & 31; j < P.V / 4; j += 32) {
      const float4 q = __ldcg(w4 + j);
      below &= q.x < P.min_weight && q.y < P.min_weight &&
               q.z < P.min_weight && q.w < P.min_weight;
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x & 31; j < P.V; j += 32)
      below &= __ldcg(w + j) < P.min_weight;
  }
  return __all_sync(kFull, below);
}

// K14's copy of row `row` (or zeros for -1) to output row `at`, by a
// warp: each lane's share of both rows loaded before any is stored
// (kRowChunk 16-byte loads of each at a time), so a row is one round trip
__device__ __forceinline__ void copy_out(const FreeParams& P, int row, int at) {
  const int64_t o = static_cast<int64_t>(at) * P.V;
  const int64_t i = static_cast<int64_t>(row < 0 ? 0 : row) * P.V;
  const int lane = threadIdx.x & 31;
  if (P.vec_rows) {
    const int V4 = P.V / 4;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4* t = reinterpret_cast<const float4*>(P.tsdf + i);
    const float4* w = reinterpret_cast<const float4*>(P.weight + i);
    float4* ot = reinterpret_cast<float4*>(P.out_tsdf + o);
    float4* ow = reinterpret_cast<float4*>(P.out_weight + o);
    for (int b = lane; b < V4; b += 32 * kRowChunk) {
      float4 a[kRowChunk], c[kRowChunk];
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) {
        const int j = b + 32 * q;
        a[q] = j < V4 && row >= 0 ? __ldcg(t + j) : z;
        c[q] = j < V4 && row >= 0 ? __ldcg(w + j) : z;
      }
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) {
        const int j = b + 32 * q;
        if (j < V4) {
          ot[j] = a[q];
          ow[j] = c[q];
        }
      }
    }
  } else {
    for (int j = lane; j < P.V; j += 32) {
      P.out_tsdf[o + j] = row < 0 ? 0.0f : __ldcg(P.tsdf + i + j);
      P.out_weight[o + j] = row < 0 ? 0.0f : __ldcg(P.weight + i + j);
    }
  }
}

// the slots of bucket b (S of them: KS, or P.S when KS is 0) into key /
// ptr; a bucket past the table reads as empty
template <int KS>
__device__ __forceinline__ void load_bucket(const FreeParams& P, int b,
                                            int (&key)[KS ? KS : kMaxSlots],
                                            int (&ptr)[KS ? KS : kMaxSlots]) {
  constexpr int kN = KS ? KS : kMaxSlots;
  const int S = KS ? KS : P.S;
  if (KS == 4 && P.vec_slots) {
    if (b < P.nb) {
      const int4 k4 = __ldcg(reinterpret_cast<const int4*>(P.keys) + b);
      const int4 p4 = __ldcg(reinterpret_cast<const int4*>(P.ptrs) + b);
      key[0] = k4.x; key[1] = k4.y; key[2] = k4.z; key[3] = k4.w;
      ptr[0] = p4.x; ptr[1] = p4.y; ptr[2] = p4.z; ptr[3] = p4.w;
    } else {
#pragma unroll
      for (int s = 0; s < kN; ++s) { key[s] = kEmptyKey; ptr[s] = kFreePtr; }
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    const bool in = b < P.nb && s < S;
    const int64_t at = static_cast<int64_t>(b) * S + s;
    key[s] = in ? __ldcg(P.keys + at) : kEmptyKey;
    ptr[s] = in ? __ldcg(P.ptrs + at) : kFreePtr;
  }
}

// Tile `tile`: its stale entries found, ranked, freed, its buckets
// re-compacted; returns the stale entries of tiles 0..tile (its inclusive
// prefix), or of every tile where the table takes a snapshot.  Every
// thread of the CTA calls it.
template <bool kEvict, int KS>
__device__ __forceinline__ int free_tile(const FreeParams& P, FreeShared& sh,
                                         int tile, unsigned tag,
                                         unsigned long long* status,
                                         int stamp) {
  constexpr int kN = KS ? KS : kMaxSlots;
  const int S = KS ? KS : P.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = tile * kTileBuckets;
  if (tid == 0) sh.n_list = 0;
  int key[kBucketsPerThread][kN], ptr[kBucketsPerThread][kN];
#pragma unroll
  for (int k = 0; k < kBucketsPerThread; ++k)
    load_bucket<KS>(P, b0 + k * kThreadsF + tid, key[k], ptr[k]);
  // the live rows' last_seen, all in one round trip
  const bool age_test = kEvict || P.gate_age;
  int seen[kBucketsPerThread][kN];
#pragma unroll
  for (int k = 0; k < kBucketsPerThread; ++k)
#pragma unroll
    for (int s = 0; s < kN; ++s)
      seen[k][s] = age_test && ptr[k][s] != kFreePtr
                       ? __ldcg(P.last_seen + min(max(ptr[k][s], 0), P.N - 1))
                       : 0;
  unsigned bits[kBucketsPerThread];   // slot s of item k: bit s
#pragma unroll
  for (int k = 0; k < kBucketsPerThread; ++k) {
    bits[k] = 0;
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const int age = static_cast<int>(static_cast<unsigned>(stamp) -
                                       static_cast<unsigned>(seen[k][s]));
      const bool live = ptr[k][s] != kFreePtr;
      const bool pass = kEvict ? age > P.age : (!P.gate_age || age >= P.age);
      if (live && pass) bits[k] |= 1u << s;
    }
  }
  if (!kEvict) {
    // the rows that can be stale, tested a warp a row
    __syncthreads();                   // n_list is 0
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kBucketsPerThread; ++k) mine += __popc(bits[k]);
    int at = mine ? atomicAdd(&sh.n_list, mine) : 0;
#pragma unroll
    for (int k = 0; k < kBucketsPerThread; ++k)
#pragma unroll
      for (int s = 0; s < kN; ++s)
        if ((bits[k] >> s) & 1u) {
          sh.list_row[at] = min(max(ptr[k][s], 0), P.N - 1);
          sh.list_at[at] = (k * kThreadsF + tid) * S + s;
          ++at;
        }
    __syncthreads();
    const int n = sh.n_list;
    for (int r = warp; r < n; r += kWarpsF) {
      const bool below = row_below(P, sh.list_row[r]);
      if (lane == 0) sh.below[sh.list_at[r]] = below;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBucketsPerThread; ++k)
#pragma unroll
      for (int s = 0; s < kN; ++s)
        if (((bits[k] >> s) & 1u) && !sh.below[(k * kThreadsF + tid) * S + s])
          bits[k] &= ~(1u << s);
  }

  // the ranks: lanes, then the (item, warp) segments, then the tiles
  int excl[kBucketsPerThread];
#pragma unroll
  for (int k = 0; k < kBucketsPerThread; ++k) {
    const int c = __popc(bits[k]);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    excl[k] = incl - c;
    if (lane == 31) sh.seg[k * kWarpsF + warp] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    static_assert(kSegmentsF <= 32, "a lane a segment");
    const int a = lane < kSegmentsF ? sh.seg[lane] : 0;
    int incl = a;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane < kSegmentsF) sh.seg[lane] = incl - a;
    const int n = __shfl_sync(kFull, incl, 31);
    int before = 0, through = 0;
    if (P.snap) {
      if (lane == 0)
        publish_status(status + kStatusStride * tile, make_status(tag, false, n));
      const int2 c = tile_status::snapshot<kStatusStride, kSnapTiles>(
          status, P.n_tiles, tile, tag, lane);
      before = c.x;
      through = c.y;
    } else {
      if (tile > 0) {
        if (lane == 0)
          publish_status(status + kStatusStride * tile,
                         make_status(tag, false, n));
        before = tile_status::look_back<kStatusStride>(status, tile, tag,
                                                        lane);
      }
      if (lane == 0)
        publish_status(status + kStatusStride * tile,
                       make_status(tag, true, before + n));
      through = before + n;
    }
    if (lane == 0) {
      sh.before = before;
      sh.through = through;
    }
  }
  __syncthreads();
  const int base = sh.before, through = sh.through, top = sh.top;

  // free what ranks below the cap; re-compact each bucket stably
#pragma unroll
  for (int k = 0; k < kBucketsPerThread; ++k) {
    const int b = b0 + k * kThreadsF + tid;
    int r = base + sh.seg[k * kWarpsF + warp] + excl[k];
    unsigned freed = 0;
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      if (!((bits[k] >> s) & 1u)) continue;
      if (r < P.cap) {
        freed |= 1u << s;
        const int64_t push = static_cast<int64_t>(top) + r;
        if (push < P.N) P.free_list[push] = ptr[k][s];
        if (kEvict) {
          const bool empty = key[k][s] == kEmptyKey;
          const int row = min(max(ptr[k][s], 0), P.N - 1);
          P.out_keys[r] = key[k][s];
          P.out_born[r] = empty ? 0 : __ldcg(P.born + row);
          const int at = atomicAdd(&sh.n_list, 1);
          sh.list_row[at] = empty ? -1 : row;
          sh.list_at[at] = r;
        }
      }
      ++r;
    }
    if (b >= P.nb) continue;
    // the occupied slots first, in their order, then the empty ones
    int fill = 0;
#pragma unroll
    for (int s = 0; s < kN; ++s)
      if (s < S && !((freed >> s) & 1u) && key[k][s] != kEmptyKey) ++fill;
    int occ = 0, emp = fill;
    const int64_t o = static_cast<int64_t>(b) * S;
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      if (s >= S) continue;
      const bool gone = (freed >> s) & 1u;
      const int kk = gone ? kEmptyKey : key[k][s];
      const int pp = gone ? kFreePtr : ptr[k][s];
      const int d = kk != kEmptyKey ? occ++ : emp++;
      if (d != s || gone) {
        P.keys[o + d] = kk;
        P.ptrs[o + d] = pp;
      }
    }
    P.bucket_fill[b] = fill;
  }
  if (kEvict) {
    __syncthreads();                   // the rows to copy are listed
    const int n = sh.n_list;
    for (int r = warp; r < n; r += kWarpsF) copy_out(P, sh.list_row[r], sh.list_at[r]);
  }
  __syncthreads();                     // the shared lists are rewritten next
  return through;
}

template <bool kEvict, int KS>
__global__ void __launch_bounds__(kThreadsF)
free_kernel(const __grid_constant__ FreeParams P) {
  __shared__ FreeShared sh;
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned long long* status = P.scratch + 1;
  // thread 0 reads free_top, then (as lane 0 of warp 0) publishes this
  // CTA's statuses with release semantics: every read of free_top comes
  // before the total is known, so before the last tile's CTA writes it
  unsigned tag = 0;
  if (tid < 32)
    tag = 0x80000000u |
          (static_cast<unsigned>(load_status(P.scratch) >> 32) & kValueMask);
  if (tid == 0) sh.top = hash_table::load_relaxed(P.free_top);
  __syncthreads();
  const int stamp = P.stamp_ptr ? __ldg(P.stamp_ptr) : P.stamp;
  // the total: every CTA's from its snapshot, else the last tile's CTA's
  int total = -1;
  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const int t = free_tile<kEvict, KS>(P, sh, tile, tag, status, stamp);
    if (P.snap || tile == P.n_tiles - 1) total = t;
    if (tile == P.n_tiles - 1 && tid == 0) {
      // every tile has published: every CTA has read free_top
      __threadfence();
      const int n = min(total, max(P.cap, 0));
      *P.n_out = n;
      *P.free_top = sh.top + n;
      publish_status(P.scratch,
                     static_cast<unsigned long long>((tag & kValueMask) + 1)
                         << 32);
    }
  }
  if (!kEvict) return;

  // K14's padding rows [n, cap), once the total is known (a CTA without
  // the last tile waits for its inclusive prefix when there is no
  // snapshot)
  if (tid < 32) {
    if (total < 0 && lane == 0) {
      unsigned long long s;
      while (static_cast<unsigned>(
                 (s = load_status(status + kStatusStride * (P.n_tiles - 1))) >>
                 32) != tag ||
             !(s & kInclusive))
        __nanosleep(kBackoffNs);
      total = static_cast<int>(s & kValueMask);
    }
    if (lane == 0) sh.count = min(total, max(P.cap, 0));
  }
  __syncthreads();
  const int n = sh.count;
  const int gtid = blockIdx.x * kThreadsF + tid, gsize = gridDim.x * kThreadsF;
  for (int r = n + gtid; r < P.cap; r += gsize) {
    P.out_keys[r] = kEmptyKey;
    P.out_born[r] = 0;
  }
  const int64_t lo = static_cast<int64_t>(n) * P.V,
                hi = static_cast<int64_t>(P.cap) * P.V;
  if (P.vec_rows) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4* t = reinterpret_cast<float4*>(P.out_tsdf);
    float4* w = reinterpret_cast<float4*>(P.out_weight);
    for (int64_t i = lo / 4 + gtid; i < hi / 4; i += gsize) {
      t[i] = z;
      w[i] = z;
    }
  } else {
    for (int64_t i = lo + gtid; i < hi; i += gsize) {
      P.out_tsdf[i] = 0.0f;
      P.out_weight[i] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

constexpr int kThreadsR = 512;    // 128 registers a thread: no spill
constexpr int kWarpsR = kThreadsR / 32;
constexpr int kMaxRestore = 4096;                  // R at most
constexpr int kItemsR = kMaxRestore / kThreadsR;   // sorted entries a thread
constexpr int kMaxProbe = 8;                       // slots a probe loads at once
constexpr uint64_t kPad = ~0ull;                   // sorts after every entry

// The persistent scratch, in ints: a header, then the listed new entries
// (kMaxRestore uint64), their fills, the inserted rows and their input
// positions, the found keys' rows and their input positions (kMaxRestore
// each).  The header's lines (128 bytes each): the counts of new and of
// found entries, the arrival count, the epoch (the flag: the allocating
// CTA raises it by one), n_alloc and the found count for the waiting
// CTAs.  Between launches the counts and the arrival are 0; the epoch
// runs on.  hash_ops.RESTORE_SCRATCH_INTS counts the ints.
constexpr int kHdrCount = 0, kHdrFound = 1, kHdrArrive = 32, kHdrEpoch = 64,
              kHdrInfo = 96, kHdrInts = 128;

struct RestoreParams {
  const int* in_keys;      // (R,) keys; EMPTY_KEY pad
  const float* in_tsdf;    // (R, V)
  const float* in_weight;  // (R, V)
  const int* in_born;      // (R,) or null: born is the stamp
  unsigned char* accepted; // (R,) bool out
  int* keys;               // (nb * S,) table keys
  int* ptrs;               // (nb * S,) table rows
  int* bucket_fill;        // (nb,)
  const int* free_list;    // (N,) stack of free rows
  int* free_top;           // ()
  float* tsdf;             // (N, V)
  float* weight;           // (N, V)
  int* last_seen;          // (N,)
  float* band_min;         // (N,)
  int* born;               // (N,)
  const int* stamp_ptr;    // () frame_idx on the device, or null: `stamp`
  int* hdr;                // scratch: the header
  unsigned long long* new_entry;   // scratch: (bucket << 32 | position)
  int* new_fill;           // scratch: each new entry's bucket fill
  int* rows;               // scratch: the inserted rows by alloc_rank
  int* src;                // scratch: their input positions
  int* found_row;          // scratch: the found keys' rows (clamped)
  int* found_src;          // scratch: their input positions
  int R, nb, S, N, V, key_bits, hash_buckets, divisor, stamp;
  int vec_rows;            // V % 4 == 0 and every row 16-byte aligned
  float max_weight;
};

struct RestoreShared {
  unsigned long long entry[kMaxRestore];   // the new entries, sorted
  uint16_t fill[kMaxRestore];    // their buckets' fills (bucket_size < 2^16)
  int red[kWarpsR];
  int last, n_alloc, n_found;
};

// one voxel of the merge, in the plain version's rounding
__device__ __forceinline__ void merge_voxel(const RestoreParams& P, float& ot,
                                            float& ow, float t, float w,
                                            float& mn) {
  const float ws = add(ow, w);
  const float mt =
      w > 0.0f ? dvd(add(mul(ot, ow), mul(t, w)), clamp_min(ws, 1e-12f)) : ot;
  const float mw = clamp_max(ws, P.max_weight);
  mn = nan_min(mn, mw > 0.0f ? fabsf(mt) : INFINITY);
  ot = mt;
  ow = mw;
}

// a found key's row `row` merged with input row i, by a warp: each
// lane's share of the four rows (the map's tsdf and weight, the input's)
// loaded before any is stored, kRowChunk 16-byte loads of each at a time
__device__ void merge_row(const RestoreParams& P, int row, int i) {
  const int lane = threadIdx.x & 31;
  const int64_t o = static_cast<int64_t>(row) * P.V;
  const int64_t q = static_cast<int64_t>(i) * P.V;
  float mn = INFINITY;
  if (P.vec_rows) {
    const int V4 = P.V / 4;
    float4* t4 = reinterpret_cast<float4*>(P.tsdf + o);
    float4* w4 = reinterpret_cast<float4*>(P.weight + o);
    const float4* it4 = reinterpret_cast<const float4*>(P.in_tsdf + q);
    const float4* iw4 = reinterpret_cast<const float4*>(P.in_weight + q);
    for (int b0 = lane; b0 < V4; b0 += 32 * kRowChunk) {
      float4 t[kRowChunk], w[kRowChunk], a[kRowChunk], c[kRowChunk];
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) {
        const int j = b0 + 32 * k;
        if (j < V4) {
          t[k] = __ldcg(t4 + j);
          w[k] = __ldcg(w4 + j);
          a[k] = __ldg(it4 + j);
          c[k] = __ldg(iw4 + j);
        }
      }
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) {
        const int j = b0 + 32 * k;
        if (j < V4) {
          merge_voxel(P, t[k].x, w[k].x, a[k].x, c[k].x, mn);
          merge_voxel(P, t[k].y, w[k].y, a[k].y, c[k].y, mn);
          merge_voxel(P, t[k].z, w[k].z, a[k].z, c[k].z, mn);
          merge_voxel(P, t[k].w, w[k].w, a[k].w, c[k].w, mn);
          t4[j] = t[k];
          w4[j] = w[k];
        }
      }
    }
  } else {
    for (int j = lane; j < P.V; j += 32) {
      float t = __ldcg(P.tsdf + o + j), w = __ldcg(P.weight + o + j);
      merge_voxel(P, t, w, __ldg(P.in_tsdf + q + j), __ldg(P.in_weight + q + j),
                  mn);
      P.tsdf[o + j] = t;
      P.weight[o + j] = w;
    }
  }
  mn = warp_nan_min(mn);
  if (lane == 0) {
    P.band_min[row] = mn;
    if (P.in_born) P.born[row] = min(__ldcg(P.born + row), __ldg(P.in_born + i));
  }
}

// input row i copied into map row `row`, by a warp, with last_seen,
// band_min (min |t| where w > 0) and born; loads staged as merge_row's
__device__ void insert_row(const RestoreParams& P, int row, int i, int stamp) {
  const int lane = threadIdx.x & 31;
  const int64_t o = static_cast<int64_t>(row) * P.V;
  const int64_t q = static_cast<int64_t>(i) * P.V;
  float mn = INFINITY;
  if (P.vec_rows) {
    const int V4 = P.V / 4;
    float4* t4 = reinterpret_cast<float4*>(P.tsdf + o);
    float4* w4 = reinterpret_cast<float4*>(P.weight + o);
    const float4* it4 = reinterpret_cast<const float4*>(P.in_tsdf + q);
    const float4* iw4 = reinterpret_cast<const float4*>(P.in_weight + q);
    for (int b0 = lane; b0 < V4; b0 += 32 * kRowChunk) {
      float4 t[kRowChunk], w[kRowChunk];
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) {
        const int j = b0 + 32 * k;
        if (j < V4) {
          t[k] = __ldg(it4 + j);
          w[k] = __ldg(iw4 + j);
        }
      }
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) {
        const int j = b0 + 32 * k;
        if (j < V4) {
          mn = nan_min(mn, w[k].x > 0.0f ? fabsf(t[k].x) : INFINITY);
          mn = nan_min(mn, w[k].y > 0.0f ? fabsf(t[k].y) : INFINITY);
          mn = nan_min(mn, w[k].z > 0.0f ? fabsf(t[k].z) : INFINITY);
          mn = nan_min(mn, w[k].w > 0.0f ? fabsf(t[k].w) : INFINITY);
          t4[j] = t[k];
          w4[j] = w[k];
        }
      }
    }
  } else {
    for (int j = lane; j < P.V; j += 32) {
      const float t = __ldg(P.in_tsdf + q + j), w = __ldg(P.in_weight + q + j);
      mn = nan_min(mn, w > 0.0f ? fabsf(t) : INFINITY);
      P.tsdf[o + j] = t;
      P.weight[o + j] = w;
    }
  }
  mn = warp_nan_min(mn);
  if (lane == 0) {
    P.band_min[row] = mn;
    P.last_seen[row] = stamp;
    P.born[row] = P.in_born ? __ldg(P.in_born + i) : stamp;
  }
}

// phase B, the CTA that arrived last: sort, rank, pop and write the new
// keys; returns n_alloc
__device__ int allocate_restore(const RestoreParams& P, RestoreShared& sh) {
  const int tid = threadIdx.x;
  const int n = __ldcg(P.hdr + kHdrCount);
  const int top = __ldcg(P.free_top);
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = tid; i < n2; i += kThreadsR) {
    sh.entry[i] = i < n ? __ldcg(P.new_entry + i) : kPad;
    sh.fill[i] = i < n ? static_cast<uint16_t>(__ldcg(P.new_fill + i)) : 0;
  }
  __syncthreads();
  hash_table::sort_pairs<kThreadsR>(sh.entry, sh.fill, n2);
  // rank in the bucket, slot, fit; alloc_rank over the entries that fit,
  // in the sorted order (thread t holds entries t kItemsR .. + kItemsR)
  int slot[kItemsR], fits = 0;
#pragma unroll
  for (int q = 0; q < kItemsR; ++q) {
    const int i = tid * kItemsR + q;
    slot[q] = P.S;
    if (i >= n) continue;
    const unsigned b = static_cast<unsigned>(sh.entry[i] >> 32);
    int rank = 0;
    for (int j = i - 1; j >= 0 && rank < P.S &&
                        static_cast<unsigned>(sh.entry[j] >> 32) == b; --j)
      ++rank;
    slot[q] = sh.fill[i] + rank;
    fits += slot[q] < P.S;
  }
  int n_fit = 0;
  int alloc_rank = hash_table::cta_exclusive_sum<kWarpsR>(fits, sh.red, n_fit);
#pragma unroll
  for (int q = 0; q < kItemsR; ++q) {
    const int i = tid * kItemsR + q;
    if (i >= n || slot[q] >= P.S) continue;
    if (alloc_rank < top) {
      const unsigned long long e = sh.entry[i];
      const int b = static_cast<int>(e >> 32);
      const int at = static_cast<int>(e & 0xffffffffu);
      const int row = hash_table::free_row(P.free_list, P.N, top, alloc_rank);
      const int64_t s = static_cast<int64_t>(b) * P.S + slot[q];
      P.keys[s] = __ldg(P.in_keys + at);
      P.ptrs[s] = row;
      atomicAdd(P.bucket_fill + b, 1);
      P.rows[alloc_rank] = row;
      P.src[alloc_rank] = at;
      P.accepted[at] = 1;
    }
    ++alloc_rank;
  }
  const int n_alloc = min(n_fit, max(top, 0));
  if (tid == 0) *P.free_top = top - n_alloc;
  return n_alloc;
}

__global__ void __launch_bounds__(kThreadsR, 1)
restore_rows_kernel(const __grid_constant__ RestoreParams P) {
  __shared__ RestoreShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int epoch = tid == 0 ? hash_table::load_relaxed(P.hdr + kHdrEpoch) : 0;
  const int stamp = P.stamp_ptr ? __ldg(P.stamp_ptr) : P.stamp;
  const int gwarp = blockIdx.x * kWarpsR + warp, gwarps = gridDim.x * kWarpsR;

  // A. a lane a key: the probe; a found key's row merged by its warp; a
  // new key listed (one atomic a warp)
  for (int i0 = gwarp * 32; i0 < P.R; i0 += gwarps * 32) {
    const int i = i0 + lane;
    const int key = i < P.R ? __ldg(P.in_keys + i) : kEmptyKey;
    int b = P.nb, fill = 0, hit = kFreePtr;
    bool found = false;
    if (key != kEmptyKey) {
      b = hash_table::spatial_bucket(key, P.key_bits, P.hash_buckets,
                                     P.divisor);
      if (b < P.nb) {
        const int64_t o = static_cast<int64_t>(b) * P.S;
        int k[kMaxProbe], p[kMaxProbe];
#pragma unroll
        for (int s = 0; s < kMaxProbe; ++s) {
          k[s] = s < P.S ? __ldcg(P.keys + o + s) : ~key;
          p[s] = s < P.S ? __ldcg(P.ptrs + o + s) : kFreePtr;
        }
        fill = __ldcg(P.bucket_fill + b);
#pragma unroll
        for (int s = 0; s < kMaxProbe; ++s)
          if (k[s] == key) {
            found = true;
            hit = p[s];
          }
        for (int s = kMaxProbe; s < P.S; ++s)     // the last match wins
          if (__ldcg(P.keys + o + s) == key) {
            found = true;
            hit = __ldcg(P.ptrs + o + s);
          }
      }
    }
    if (i < P.R) P.accepted[i] = found;
    const bool fresh = key != kEmptyKey && !found && b < P.nb;
    const unsigned mn = __ballot_sync(kFull, fresh);
    int base = 0;
    if (lane == 0 && mn) base = atomicAdd(P.hdr + kHdrCount, __popc(mn));
    base = __shfl_sync(kFull, base, 0);
    if (fresh) {
      const int at = base + __popc(mn & ((1u << lane) - 1u));
      P.new_entry[at] = (static_cast<unsigned long long>(b) << 32) |
                        static_cast<unsigned>(i);
      P.new_fill[at] = fill;
    }
    const unsigned mf = __ballot_sync(kFull, found);
    int fbase = 0;
    if (lane == 0 && mf) fbase = atomicAdd(P.hdr + kHdrFound, __popc(mf));
    fbase = __shfl_sync(kFull, fbase, 0);
    if (found) {
      const int at = fbase + __popc(mf & ((1u << lane) - 1u));
      P.found_row[at] = min(max(hit, 0), P.N - 1);
      P.found_src[at] = i;
    }
  }

  // B. the CTA that arrives last allocates, then raises the epoch
  __syncthreads();
  if (tid == 0)
    sh.last = hash_table::atomic_add_acq_rel(P.hdr + kHdrArrive, 1) ==
              static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (sh.last) {
    const int n_alloc = allocate_restore(P, sh);
    if (tid == 0) sh.n_found = __ldcg(P.hdr + kHdrFound);
    __syncthreads();
    if (tid == 0) {               // every thread has read the counts
      P.hdr[kHdrCount] = 0;
      P.hdr[kHdrFound] = 0;
      P.hdr[kHdrArrive] = 0;
      P.hdr[kHdrInfo] = n_alloc;
      P.hdr[kHdrInfo + 1] = sh.n_found;
      sh.n_alloc = n_alloc;
      hash_table::store_release(P.hdr + kHdrEpoch, epoch + 1);
    }
  } else if (tid == 0) {
    while (hash_table::load_acquire(P.hdr + kHdrEpoch) == epoch)
      __nanosleep(32);
    sh.n_alloc = __ldcg(P.hdr + kHdrInfo);
    sh.n_found = __ldcg(P.hdr + kHdrInfo + 1);
  }
  __syncthreads();

  // C. a warp a row over the grid: the found keys' rows merged (their
  // rows are live, so no inserted row is one of them), the inserted rows'
  // payload copied in
  const int n_found = sh.n_found, n_rows = n_found + sh.n_alloc;
  for (int r = gwarp; r < n_rows; r += gwarps) {
    if (r < n_found)
      merge_row(P, __ldcg(P.found_row + r), __ldcg(P.found_src + r));
    else
      insert_row(P, __ldcg(P.rows + r - n_found),
                 __ldcg(P.src + r - n_found), stamp);
  }
}

using FreeKernel = void (*)(FreeParams);

// K10 / K14's common launch: the map from the host table (HashMap order),
// the ints nb, S, N, V; `tiles` tiles, at least the buckets' (K14 asks
// for more: the tiles past the table are empty, and their CTAs share the
// padding); the grid one CTA a tile up to what the card holds
template <bool kEvict>
int launch_free(FreeParams& P, void* const* map, const int* ints, int tiles,
                unsigned long long* scratch, int scratch_words, void* stream) {
  const int nb = ints[0], S = ints[1], N = ints[2], V = ints[3];
  if (nb < 1 || S < 1 || S > kMaxSlots || N < 1 || V < 1 ||
      tiles < (nb - 1) / kTileBuckets + 1 ||
      tiles > scratch_words / kStatusStride || (kEvict && P.cap < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = tiles;
  P.keys = static_cast<int*>(map[0]);
  P.ptrs = static_cast<int*>(map[1]);
  P.bucket_fill = static_cast<int*>(map[2]);
  P.free_list = static_cast<int*>(map[3]);
  P.free_top = static_cast<int*>(map[4]);
  P.tsdf = static_cast<const float*>(map[5]);
  P.weight = static_cast<const float*>(map[6]);
  P.last_seen = static_cast<const int*>(map[7]);
  P.born = static_cast<const int*>(map[9]);
  P.scratch = scratch;
  P.nb = nb;
  P.S = S;
  P.N = N;
  P.V = V;
  P.n_tiles = n_tiles;
  P.vec_slots = S == 4 && ((reinterpret_cast<uintptr_t>(P.keys) |
                            reinterpret_cast<uintptr_t>(P.ptrs)) & 15) == 0;
  uintptr_t rows = reinterpret_cast<uintptr_t>(P.tsdf) |
                   reinterpret_cast<uintptr_t>(P.weight);
  if (kEvict)
    rows |= reinterpret_cast<uintptr_t>(P.out_tsdf) |
            reinterpret_cast<uintptr_t>(P.out_weight);
  P.vec_rows = V % 4 == 0 && (rows & 15) == 0;
  const FreeKernel kernel = S == 4 ? free_kernel<kEvict, 4> : free_kernel<kEvict, 0>;
  static int cached[2][kMaxDevices] = {};
  int capacity = 0;
  cudaError_t err =
      hash_table::capacity_of(kernel, kThreadsF, cached[S == 4], &capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = min(n_tiles, capacity);
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  P.snap = n_tiles <= kSnapTiles && ctas == n_tiles;
  kernel<<<ctas, kThreadsF, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns a CUDA error code as an int (0 = launched); an argument the
// kernel does not take returns cudaErrorInvalidValue and launches nothing.
// map: a host table of the HashMap's tensors in field order (keys, ptrs,
// bucket_fill, free_list, free_top, tsdf, weight, last_seen, band_min,
// born); ints: a host table (buckets, slots a bucket, map rows, voxels a
// row); scratch: K6's layout, its epoch word and scratch_words status
// words.

// K10.  Free up to max_free table entries whose rows' weights are all
// below min_weight (with gate_age, and frame - last_seen >= min_age),
// frame *stamp_ptr when it is not null; n_out = the entries freed.
extern "C" int gc_free(void* const* map, const int* ints, int* n_out,
                       const int* stamp_ptr, int stamp, int gate_age,
                       int min_age, int max_free, float min_weight, int tiles,
                       unsigned long long* scratch, int scratch_words,
                       void* stream) {
  FreeParams P = {};
  P.n_out = n_out;
  P.stamp_ptr = stamp_ptr;
  P.stamp = stamp;
  P.gate_age = gate_age != 0;
  P.age = gate_age ? min_age : 0;
  P.cap = max_free;
  P.min_weight = min_weight;
  return launch_free<false>(P, map, ints, tiles, scratch, scratch_words,
                            stream);
}

// K14.  Free up to max_evict table entries whose rows were last seen more
// than max_age frames before frame (*stamp_ptr when it is not null); their
// keys, born, tsdf and weight rows out at their ranks, rows [n, max_evict)
// EMPTY_KEY, 0 and zeros; n_out = n.  out_ints: keys (max_evict,) then
// born (max_evict,); out_floats: tsdf (max_evict, V) then weight.
extern "C" int evict_free(void* const* map, const int* ints, int* n_out,
                          const int* stamp_ptr, int stamp, int max_age,
                          int max_evict, int* out_ints, float* out_floats,
                          int tiles, unsigned long long* scratch,
                          int scratch_words, void* stream) {
  FreeParams P = {};
  P.n_out = n_out;
  P.stamp_ptr = stamp_ptr;
  P.stamp = stamp;
  P.age = max_age;
  P.cap = max_evict;
  P.out_keys = out_ints;
  P.out_born = out_ints + max_evict;
  P.out_tsdf = out_floats;
  P.out_weight = out_floats + static_cast<int64_t>(max_evict) * ints[3];
  return launch_free<true>(P, map, ints, tiles, scratch, scratch_words,
                           stream);
}

// K15.  Restore R keys (EMPTY_KEY pad) with their rows: found keys merged,
// new ones inserted with BucketHash(hash_buckets, divisor); accepted (R,)
// bool out; the stamp *stamp_ptr when it is not null; born_rows may be
// null.  scratch: hash_ops.RESTORE_SCRATCH_INTS ints, its count and
// arrival 0, as every launch leaves them.  ints: buckets, slots a bucket,
// map rows, voxels a row, key bits, the hash's buckets and divisor.  One
// cooperative launch, refused when its grid cannot be co-resident.
extern "C" int restore_rows(void* const* map, const int* ints,
                            const int* keys, const float* tsdf_rows,
                            const float* weight_rows, const int* born_rows,
                            unsigned char* accepted, int R,
                            const int* stamp_ptr, int stamp, float max_weight,
                            int* scratch, void* stream) {
  const int nb = ints[0], S = ints[1], N = ints[2], V = ints[3],
            key_bits = ints[4], hash_buckets = ints[5], divisor = ints[6];
  if (R < 0 || R > kMaxRestore || nb < 1 || S < 1 || S > 65535 || N < 1 ||
      V < 1 || key_bits < 1 || key_bits > 10 || hash_buckets < 1 ||
      divisor < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaGetLastError());
  RestoreParams P = {};
  P.in_keys = keys;
  P.in_tsdf = tsdf_rows;
  P.in_weight = weight_rows;
  P.in_born = born_rows;
  P.accepted = accepted;
  P.keys = static_cast<int*>(map[0]);
  P.ptrs = static_cast<int*>(map[1]);
  P.bucket_fill = static_cast<int*>(map[2]);
  P.free_list = static_cast<const int*>(map[3]);
  P.free_top = static_cast<int*>(map[4]);
  P.tsdf = static_cast<float*>(map[5]);
  P.weight = static_cast<float*>(map[6]);
  P.last_seen = static_cast<int*>(map[7]);
  P.band_min = static_cast<float*>(map[8]);
  P.born = static_cast<int*>(map[9]);
  P.stamp_ptr = stamp_ptr;
  P.hdr = scratch;
  P.new_entry = reinterpret_cast<unsigned long long*>(scratch + kHdrInts);
  P.new_fill = scratch + kHdrInts + 2 * kMaxRestore;
  P.rows = P.new_fill + kMaxRestore;
  P.src = P.rows + kMaxRestore;
  P.found_row = P.src + kMaxRestore;
  P.found_src = P.found_row + kMaxRestore;
  P.R = R;
  P.nb = nb;
  P.S = S;
  P.N = N;
  P.V = V;
  P.key_bits = key_bits;
  P.hash_buckets = hash_buckets;
  P.divisor = divisor;
  P.stamp = stamp;
  P.max_weight = max_weight;
  P.vec_rows = V % 4 == 0 &&
               ((reinterpret_cast<uintptr_t>(P.tsdf) |
                 reinterpret_cast<uintptr_t>(P.weight) |
                 reinterpret_cast<uintptr_t>(tsdf_rows) |
                 reinterpret_cast<uintptr_t>(weight_rows)) & 15) == 0;
  static int cached[kMaxDevices] = {};
  int resident = 0;
  cudaError_t err = hash_table::capacity_of(restore_rows_kernel, kThreadsR,
                                            cached, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a lane a key in phase A; a warp a row in phase C (rows of 4 KB at
  // V = 512): a CTA (16 warps) for every 32 keys, up to one row a warp
  const int ctas = min(resident, max(1, (R + 31) / 32));
  if (ctas < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kThreadsR);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, restore_rows_kernel, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
