// Block allocation for Hopper (sm_90a), two kernels:
//
//   alloc_candidates (K5a): the packed block keys of the frame's
//     truncation band, band_steps samples along each strided pixel ray.
//     Replaces what XLA fused on the TPU in voxelhashing_demo_tpu/ops/
//     hash_ops.py: frame_candidate_keys (:151).
//   insert_blocks (K5b): the distinct keys, capped at max_new_per_frame
//     (the smallest kept), probed against the table; the new ones ordered
//     by (bucket, key), ranked in their bucket, given heap rows from the
//     free stack and scattered into the table, their rows reset.  Replaces
//     _unique_compact (:200), insert_blocks (:218) and the probe of
//     lookup_keys (:115) as allocate_from_frame (:875) and fuse_frame
//     (:893) call them, and the sharded step's owner-routed insert
//     (voxelhashing_demo_tpu/parallel/sharded.py:96, _local_bucket_fn).
//
// No PyTorch call computes either.
//
// K5a.  One thread a strided ray, all its band samples: an elementwise
// pass.  Each thread reads its pixel's depth and vertex, and writes
// band_steps keys at (band, ray), so the writes of a warp are coalesced.
//
// K5b.  One cooperative launch of four phases with a grid barrier between
// each two:
//   1. the grid clears a scratch open-addressing set of P >= 2M slots
//      (a power of two; EMPTY_KEY marks a free slot) and the distinct
//      counter;
//   2. the grid puts the M keys into the set with atomicCAS (a warp
//      first merges its equal keys with __match_any_sync) and appends each
//      key it is first to insert to a list of the U distinct keys.  The
//      set's contents do not depend on the order of the atomics, so
//      neither does anything below;
//   3. one CTA: if U > max_new, a radix select (4 passes of 8 bits over
//      the list, keys compared as signed int32, as torch.sort does) finds
//      the max_new-th smallest key and keeps the keys up to it; it probes
//      each kept key's bucket (all bucket_size slots), packs each new one
//      as the 64-bit (bucket, key) and sorts them in shared memory (a
//      bitonic sort over the next power of two of their count: the
//      stable argsort of the bucket over the key-sorted unique keys is
//      this order, since the keys are distinct); ranks each in its bucket
//      by looking back over at most bucket_size entries; counts alloc_rank
//      over the entries that fit by a block scan; and writes each kept
//      entry's key and row (free_list[free_top - 1 - alloc_rank]) at
//      bucket * S + slot, adds to bucket_fill, and lists the new rows;
//   4. the grid resets the new rows: tsdf and weight 0, band_min inf,
//      last_seen and born the stamp (an int, or read from a 0-d device
//      int through a pointer).
// A dropped key (past the cap, its bucket full, the heap empty) writes
// nothing: the kernel skips it.  Integers throughout, so the state is
// bit-exact against the plain version and repeats from run to run.  The
// count n_alloc stays on the device; free_top drops by it.
//
// Rounding (K5a): every product, sum and quotient of the plain PyTorch
// version (ops/hash_ops.py frame_candidate_keys_reference) on the card is
// written with the round-to-nearest intrinsics, in its order, so nvcc
// contracts nothing the plain version rounds: _norm's size-3 sum as torch
// sums a last axis of three on the card, (x0 + x2) + x1, then sqrt;
// 1.0 / clamp(len, 1e-9) as reciprocal() * 1.0; the ray, the band offset
// steps * trunc, ray_dir * that and verts + it, each rounded; trunc as
// trunc_scale * depth, then + truncation; torch.linspace's values as its
// CUDA kernel computes them; the (M, 3) @ (3, 3) product of se3.apply as
// the library sums it on the card (csrc/fuse.cu's dot_mm), then + t;
// world2voxel's p * recip(voxel), + -0.5 / 0.5, truncation to int32 (the
// conversion saturates and takes NaN to 0, as torch's does on the card);
// voxel2block's floor division.  chip_rounding_probe.py checks each at
// the rows the step gives it.
//
// Bound: K5a moves bytes (each strided pixel's depth and vertex, 16 B,
// and 4 B a key), ~1 MB at the flagship: ~0.3 us at 3.35 TB/s, below the
// launch floor.  K5b must read the M keys (4 B each), the kept keys'
// bucket slots and fills, the heap rows it pops, and write each new
// entry (key, ptr, fill) and row (2 x 2 KB at 8^3 voxels): ~0.4-2 MB on
// the step's frames (chip_smoke.py counts them from its run's data), so
// its least time is the launch floor plus its three grid barriers.  What
// the pair replaces is ~60 eager launches and ~16 host reads a frame.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp's NaN rule: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// a0 b0 + a1 b1 + a2 b2 as the card's (N, 3) @ (3, 3) matmul sums it
// (a copy of csrc/fuse.cu's, so that each source's hash covers what it runs)
__device__ __forceinline__ float dot_mm(float a0, float b0, float a1, float b1,
                                        float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}

constexpr int kEmptyKey = 0x7FFFFFFF;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSign = 0x80000000u;   // key ^ kSign: signed order as unsigned

// floor division by a positive divisor (C's / truncates)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// ---------------------------------------------------------------------------
// K5a
// ---------------------------------------------------------------------------

constexpr int kThreadsA = 256;

struct CandidateParams {
  const float* verts;      // (H, W, 3) camera-space vertices
  const float* depth;      // (H, W) metric depth; 0 invalid
  const float* T_wc;       // (4, 4) row-major camera-to-world
  int* keys;               // (band_steps, h, w) out
  int H, W, stride, h, w, band_steps, key_bits, bs;
  // float32 of the plain version's Python doubles: truncation, its depth
  // scale, recip(voxel size)
  float trunc, trunc_scale, inv_voxel;
};

// torch.linspace(-1, 1, n)[s] as its CUDA kernel computes it: the step
// rounded, then start + step * s below the halfway index and end - step *
// (n - 1 - s) from it, each one fused multiply-add
__device__ __forceinline__ float band_step(int s, int n) {
  if (n == 1) return -1.0f;
  const float step = dvd(2.0f, static_cast<float>(n - 1));
  return s < n / 2 ? __fmaf_rn(step, static_cast<float>(s), -1.0f)
                   : __fmaf_rn(-step, static_cast<float>(n - 1 - s), 1.0f);
}

// world2block of one world coordinate: trunc(p * recip(voxel) +- 0.5) to
// int32, then floor division by the block size
__device__ __forceinline__ int world_block(const CandidateParams& P, float w) {
  const float p = mul(w, P.inv_voxel);
  return floor_div(__float2int_rz(add(p, p >= 0.0f ? 0.5f : -0.5f)), P.bs);
}

__global__ void __launch_bounds__(kThreadsA)
alloc_candidates_kernel(const __grid_constant__ CandidateParams P) {
  const int R = P.h * P.w;
  const int r = blockIdx.x * kThreadsA + threadIdx.x;
  if (r >= R) return;
  const int y = r / P.w, x = r - (r / P.w) * P.w;
  const int64_t pix = static_cast<int64_t>(y) * P.stride * P.W +
                      static_cast<int64_t>(x) * P.stride;
  const float d = __ldg(P.depth + pix);
  if (!(d > 0.0f)) {                     // an invalid ray: EMPTY_KEY throughout
    for (int s = 0; s < P.band_steps; ++s) P.keys[s * R + r] = kEmptyKey;
    return;
  }
  const float v0 = __ldg(P.verts + 3 * pix), v1 = __ldg(P.verts + 3 * pix + 1),
              v2 = __ldg(P.verts + 3 * pix + 2);
  // _norm, the reciprocal, the unit ray
  const float len = __fsqrt_rn(add(add(mul(v0, v0), mul(v2, v2)), mul(v1, v1)));
  const float inv = dvd(1.0f, clamp_min(len, 1e-9f));
  const float d0 = mul(v0, inv), d1 = mul(v1, inv), d2 = mul(v2, inv);
  const float tr = add(mul(d, P.trunc_scale), P.trunc);
  float R_[3][3], t[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) R_[j][k] = __ldg(P.T_wc + 4 * j + k);
    t[j] = __ldg(P.T_wc + 4 * j + 3);
  }
  const int bias = 1 << (P.key_bits - 1), lim = (1 << P.key_bits) - 1;
  for (int s = 0; s < P.band_steps; ++s) {
    const float st = mul(band_step(s, P.band_steps), tr);
    const float p0 = add(v0, mul(d0, st)), p1 = add(v1, mul(d1, st)),
                p2 = add(v2, mul(d2, st));
    int b[3];
    bool in_range = true;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w = add(dot_mm(p0, R_[j][0], p1, R_[j][1], p2, R_[j][2]), t[j]);
      b[j] = world_block(P, w) + bias;
      in_range = in_range && b[j] >= 0 && b[j] <= lim;
    }
    P.keys[s * R + r] = in_range
        ? (b[0] << (2 * P.key_bits)) | (b[1] << P.key_bits) | b[2]
        : kEmptyKey;
  }
}

// ---------------------------------------------------------------------------
// K5b
// ---------------------------------------------------------------------------

constexpr int kThreadsB = 1024;
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kMaxNew = 4096;                     // max_new_per_frame at most
constexpr int kItemsB = kMaxNew / kThreadsB;      // sorted entries a thread
constexpr uint64_t kPad = ~0ull;                  // sorts after every entry

struct InsertParams {
  const int* cand;         // (M,) keys; EMPTY_KEY none
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
  int* n_alloc;            // () out
  const int* stamp_ptr;    // () the stamp on the device, or null: `stamp`
  int* set;                // (P,) scratch: the open-addressing set
  int* distinct;           // (M,) scratch: the distinct keys, any order
  int* rows;               // (max_new,) scratch: the new rows by alloc_rank
  int* n_distinct;         // () scratch: U
  int M, set_bits, nb, S, N, V, key_bits;
  int hash_buckets, divisor;   // BucketHash: spatial_hash(b, hash_buckets) // divisor
  int max_new, stamp;
};

// the bucket of a packed key: BucketHash (ops/hash_ops.py) of the unpacked
// block, int32 products wrapping, the floor modulo, then the floor
// division by the divisor; clamped into the table
__device__ __forceinline__ int bucket_of(const InsertParams& P, int key) {
  const int mask = (1 << P.key_bits) - 1, bias = 1 << (P.key_bits - 1);
  const unsigned x = static_cast<unsigned>(((key >> (2 * P.key_bits)) & mask) - bias);
  const unsigned y = static_cast<unsigned>(((key >> P.key_bits) & mask) - bias);
  const unsigned z = static_cast<unsigned>((key & mask) - bias);
  const int h = static_cast<int>((x * 73856093u) ^ (y * 19349669u) ^ (z * 83492791u));
  int m = h % P.hash_buckets;
  if (m < 0) m += P.hash_buckets;
  return min(max(m / P.divisor, 0), P.nb - 1);
}

// put `key` in the set; true if this call put it there first
__device__ __forceinline__ bool set_insert(const InsertParams& P, int key) {
  const unsigned mask = (1u << P.set_bits) - 1u;
  unsigned s = (static_cast<unsigned>(key) * 2654435761u) >> (32 - P.set_bits);
  while (true) {
    const int prev = atomicCAS(P.set + s, kEmptyKey, key);
    if (prev == kEmptyKey) return true;
    if (prev == key) return false;
    s = (s + 1u) & mask;
  }
}

// exclusive prefix sum of x over the CTA; `total` gets the sum.  red holds
// kWarpsB ints and is free again when this returns
__device__ __forceinline__ int cta_exclusive_sum(int x, int* red, int& total) {
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
    int w = red[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += o;
    }
    red[lane] = w;                       // inclusive over the warps
  }
  __syncthreads();
  const int before = warp ? red[warp - 1] : 0;
  total = red[kWarpsB - 1];
  __syncthreads();
  return before + incl - x;
}

struct AllocShared {
  uint64_t entry[kMaxNew];   // (bucket, key ^ kSign) of the new keys, sorted
  int hist[256];
  int red[kWarpsB];
  int n_new, digit, rank_left;
};

// phase 3, one CTA: select, probe, sort, rank, pop and scatter
__device__ void allocate_cta(const InsertParams& P, AllocShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int U = __ldcg(P.n_distinct);
  if (tid == 0) sh.n_new = 0;
  __syncthreads();

  // the cap: the max_new-th smallest distinct key, by 8 bits a pass
  const bool capped = U > P.max_new;
  unsigned cap = 0xffffffffu, prefix = 0, pmask = 0;
  if (capped && P.max_new > 0) {
    if (tid == 0) sh.rank_left = P.max_new;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kThreadsB) sh.hist[i] = 0;
      __syncthreads();
      for (int i = tid; i < U; i += kThreadsB) {
        const unsigned u = static_cast<unsigned>(__ldcg(P.distinct + i)) ^ kSign;
        if ((u & pmask) == prefix) atomicAdd(&sh.hist[(u >> shift) & 255u], 1);
      }
      __syncthreads();
      if (warp == 0) {                   // the digit holding rank_left
        const int k = sh.rank_left;
        int mine = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) mine += sh.hist[8 * lane + j];
        int incl = mine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int o = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += o;
        }
        const int excl = incl - mine;
        if (excl < k && k <= incl) {
          int c = excl, j = 0;
          while (c + sh.hist[8 * lane + j] < k) c += sh.hist[8 * lane + j++];
          sh.digit = 8 * lane + j;
          sh.rank_left = k - c;
        }
      }
      __syncthreads();
      prefix |= static_cast<unsigned>(sh.digit) << shift;
      pmask |= 255u << shift;
    }
    cap = prefix;
  }

  // the kept keys' probe; the new ones packed as (bucket, key)
  if (!capped || P.max_new > 0) {
    for (int i0 = warp * 32; i0 < U; i0 += kThreadsB) {
      const int i = i0 + lane;
      bool fresh = false;
      uint64_t e = kPad;
      if (i < U) {
        const int key = __ldcg(P.distinct + i);
        if ((static_cast<unsigned>(key) ^ kSign) <= cap) {
          const int b = bucket_of(P, key);
          bool found = false;
          for (int s = 0; s < P.S; ++s) found |= P.keys[b * P.S + s] == key;
          fresh = !found;
          e = (static_cast<uint64_t>(b) << 32) | (static_cast<unsigned>(key) ^ kSign);
        }
      }
      const unsigned put = __ballot_sync(kFull, fresh);
      int base = 0;
      if (lane == 0 && put) base = atomicAdd(&sh.n_new, __popc(put));
      base = __shfl_sync(kFull, base, 0);
      if (fresh) sh.entry[base + __popc(put & ((1u << lane) - 1u))] = e;
    }
  }
  __syncthreads();
  const int n = sh.n_new;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + tid; i < n2; i += kThreadsB) sh.entry[i] = kPad;
  __syncthreads();

  // bitonic sort of entry[0, n2)
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n2; i += kThreadsB) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = sh.entry[i], b = sh.entry[ixj];
          if ((a > b) == ((i & k) == 0)) {
            sh.entry[i] = b;
            sh.entry[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // rank in the bucket, slot, fit; alloc_rank over the entries that fit
  int slot[kItemsB], fits = 0;
#pragma unroll
  for (int q = 0; q < kItemsB; ++q) {
    const int i = tid * kItemsB + q;
    slot[q] = P.S;
    if (i >= n) continue;
    const unsigned b = static_cast<unsigned>(sh.entry[i] >> 32);
    int rank = 0;
    for (int j = i - 1; j >= 0 && rank < P.S &&
                        static_cast<unsigned>(sh.entry[j] >> 32) == b; --j)
      ++rank;
    slot[q] = P.bucket_fill[b] + rank;
    fits += slot[q] < P.S;
  }
  int n_fit = 0;
  int alloc_rank = cta_exclusive_sum(fits, sh.red, n_fit);
  const int top = *P.free_top;
  __syncthreads();                       // every fill and free_top read
#pragma unroll
  for (int q = 0; q < kItemsB; ++q) {
    const int i = tid * kItemsB + q;
    if (i >= n || slot[q] >= P.S) continue;
    if (alloc_rank < top) {
      const uint64_t e = sh.entry[i];
      const int b = static_cast<int>(e >> 32);
      const int key = static_cast<int>(static_cast<unsigned>(e) ^ kSign);
      const int row = P.free_list[min(max(top - 1 - alloc_rank, 0), P.N - 1)];
      P.keys[b * P.S + slot[q]] = key;
      P.ptrs[b * P.S + slot[q]] = row;
      atomicAdd(P.bucket_fill + b, 1);
      P.rows[alloc_rank] = row;
    }
    ++alloc_rank;
  }
  if (tid == 0) {
    const int n_alloc = min(n_fit, max(top, 0));
    *P.n_alloc = n_alloc;
    *P.free_top = top - n_alloc;
  }
}

__global__ void __launch_bounds__(kThreadsB, 1)
insert_blocks_kernel(const __grid_constant__ InsertParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ AllocShared sh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gtid = blockIdx.x * kThreadsB + tid, gsize = gridDim.x * kThreadsB;

  // 1. clear the set and the count
  const int n_set = 1 << P.set_bits;
  int4* set4 = reinterpret_cast<int4*>(P.set);
  const int4 empty4 = make_int4(kEmptyKey, kEmptyKey, kEmptyKey, kEmptyKey);
  for (int i = gtid; i < n_set / 4; i += gsize) set4[i] = empty4;
  if (gtid == 0) *P.n_distinct = 0;
  grid.sync();

  // 2. the distinct keys: a warp merges its equal keys, its leaders insert
  for (int i0 = gtid - lane; i0 < P.M; i0 += gsize) {
    const int i = i0 + lane;
    const int key = i < P.M ? __ldg(P.cand + i) : kEmptyKey;
    const unsigned peers = __match_any_sync(kFull, key);
    const bool first = key != kEmptyKey && (__ffs(peers) - 1) == lane &&
                       set_insert(P, key);
    const unsigned put = __ballot_sync(kFull, first);
    int base = 0;
    if (lane == 0 && put) base = atomicAdd(P.n_distinct, __popc(put));
    base = __shfl_sync(kFull, base, 0);
    if (first) P.distinct[base + __popc(put & ((1u << lane) - 1u))] = key;
  }
  grid.sync();

  // 3. one CTA allocates
  if (blockIdx.x == 0) allocate_cta(P, sh);
  grid.sync();

  // 4. the new rows reset, a CTA a row
  const int n_alloc = __ldcg(P.n_alloc);
  const int stamp = P.stamp_ptr ? __ldg(P.stamp_ptr) : P.stamp;
  for (int r = blockIdx.x; r < n_alloc; r += gridDim.x) {
    const int row = __ldcg(P.rows + r);
    const int64_t o = static_cast<int64_t>(row) * P.V;
    for (int v = tid; v < 2 * P.V; v += kThreadsB)
      (v < P.V ? P.tsdf : P.weight)[o + (v < P.V ? v : v - P.V)] = 0.0f;
    if (tid == 0) {
      P.band_min[row] = INFINITY;
      P.last_seen[row] = stamp;
      P.born[row] = stamp;
    }
  }
}

// co-resident CTAs of `kernel` at `threads` on the current device (asked
// once a device); 0 with the error set on failure
template <typename Kernel>
cudaError_t capacity_of(Kernel kernel, int threads, int* capacity) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static int cached[kMaxDevices] = {};
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

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns a CUDA error code as an int (0 = launched); an argument the
// kernel does not take returns cudaErrorInvalidValue and launches nothing.

// K5a.  The (band_steps, ceil(H / stride), ceil(W / stride)) packed keys
// of the frame (vertices (H, W, 3), depth (H, W)) at pose T_wc.
extern "C" int alloc_candidates(const float* verts, const float* depth,
                                const float* T_wc, int* keys, int H, int W,
                                int stride, int band_steps, int key_bits,
                                int block_size, float trunc,
                                float trunc_scale, float inv_voxel,
                                void* stream) {
  if (H < 1 || W < 1 || stride < 1 || band_steps < 1 || key_bits < 1 ||
      key_bits > 10 || block_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CandidateParams P = {};
  P.verts = verts;
  P.depth = depth;
  P.T_wc = T_wc;
  P.keys = keys;
  P.H = H;
  P.W = W;
  P.stride = stride;
  P.h = (H + stride - 1) / stride;
  P.w = (W + stride - 1) / stride;
  P.band_steps = band_steps;
  P.key_bits = key_bits;
  P.bs = block_size;
  P.trunc = trunc;
  P.trunc_scale = trunc_scale;
  P.inv_voxel = inv_voxel;
  const int R = P.h * P.w;
  alloc_candidates_kernel<<<(R + kThreadsA - 1) / kThreadsA, kThreadsA, 0,
                            static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K5b.  Insert the distinct keys of cand (M,) into the table (nb buckets of
// S slots) with BucketHash(hash_buckets, divisor), at most max_new of them
// (the smallest); reset the new rows with the stamp (*stamp_ptr when it is
// not null); n_alloc = the rows taken.  scratch: 2^set_bits + M + max_new
// + 1 ints, 2^set_bits >= 2 M, set_bits >= 2.  One cooperative launch,
// refused (cudaErrorCooperativeLaunchTooLarge) when its grid cannot be
// co-resident.
extern "C" int insert_blocks(const int* cand, int* keys, int* ptrs,
                             int* bucket_fill, const int* free_list,
                             int* free_top, float* tsdf, float* weight,
                             int* last_seen, float* band_min, int* born,
                             int* n_alloc, const int* stamp_ptr, int* scratch,
                             int M, int set_bits, int nb, int S, int N, int V,
                             int key_bits, int hash_buckets, int divisor,
                             int max_new, int stamp, void* stream) {
  if (M < 0 || set_bits < 2 || set_bits > 30 ||
      (static_cast<int64_t>(1) << set_bits) < 2 * static_cast<int64_t>(M) ||
      nb < 1 || S < 1 || N < 1 || V < 0 || key_bits < 1 || key_bits > 10 ||
      hash_buckets < 1 || divisor < 1 || max_new < 0 || max_new > kMaxNew)
    return static_cast<int>(cudaErrorInvalidValue);
  InsertParams P = {};
  P.cand = cand;
  P.keys = keys;
  P.ptrs = ptrs;
  P.bucket_fill = bucket_fill;
  P.free_list = free_list;
  P.free_top = free_top;
  P.tsdf = tsdf;
  P.weight = weight;
  P.last_seen = last_seen;
  P.band_min = band_min;
  P.born = born;
  P.n_alloc = n_alloc;
  P.stamp_ptr = stamp_ptr;
  P.set = scratch;
  P.distinct = scratch + (1 << set_bits);
  P.rows = P.distinct + M;
  P.n_distinct = P.rows + max_new;
  P.M = M;
  P.set_bits = set_bits;
  P.nb = nb;
  P.S = S;
  P.N = N;
  P.V = V;
  P.key_bits = key_bits;
  P.hash_buckets = hash_buckets;
  P.divisor = divisor;
  P.max_new = max_new;
  P.stamp = stamp;
  int capacity = 0;
  cudaError_t err = capacity_of(insert_blocks_kernel, kThreadsB, &capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = min(capacity, max(1, (M + kThreadsB - 1) / kThreadsB));
  if (ctas < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kThreadsB);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, insert_blocks_kernel, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
