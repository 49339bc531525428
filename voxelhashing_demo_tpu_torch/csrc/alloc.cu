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
// K5a.  An elementwise pass whose cost at the flagship's size (34 240
// rays, 3 band steps) is the launch, the round trips a thread waits for
// and its instructions, not bytes.  So a thread takes one (band step,
// ray) pair, three times the warps of a thread a ray: CTA (x, y, s) holds
// 8 warps, each 32 rays of one strided row, at band step s.  At entry
// each thread loads its pixel's depth, its vertex (whatever the depth
// says: the address is valid) and the pose together; the arithmetic
// follows and the key is stored at (band, ray), so the stores of a warp
// are coalesced.  The ray's position needs no integer division (the
// grid's x and y) and linspace's step comes from the host, divided there
// in float32 (no divide a thread); an instantiation for block size 8 (the
// floor division a shift) beside the generic one.  (PR 17's design, a
// thread a ray and its band steps, 134 CTAs of 256, waited for the depth,
// then the vertex, then the pose, one after another.  A warp's span
// staged in shared memory through coalesced loads, with a thread a ray
// and its steps or a warp a step, lost: chip_splat_breakdown.py's design
// trees, PERF.md.)
//
// K5b.  One cooperative launch over a persistent scratch (its layout in
// the K5b section) that every launch leaves as it found it: the set
// empty, the counts 0.  No grid barrier: one arrival count and one flag.
// What bounds it is a chain of dependent round trips to L2, so each phase
// keeps its loads in flight together:
//   A. the grid puts the M keys into an open-addressing set of 2^set_bits
//      >= 2 M slots (EMPTY_KEY free; a warp first merges its equal keys
//      with __match_any_sync).  Each inserting thread sends its atomicCAS
//      and loads its key's bucket (all bucket_size slots, and the fill) in
//      the same round trip; the thread that put a key there lists it (key
//      and slot) among the U distinct keys, and a key the table lacks
//      among the new keys as the 64-bit (bucket, key ^ sign) with its
//      bucket's fill, one atomic on a 64-bit pair of counts appending to
//      both lists for the warp.  The set's contents, and so everything
//      below, do not depend on the atomics' order;
//   B. the last CTA to arrive (an acq_rel atomic count) allocates: one
//      round trip brings the counts and the first 1 024 entries and slots
//      (it empties those set slots at once).  If U > max_new, a radix
//      select (4 passes of 8 bits over the distinct list, keys compared as
//      signed int32, as torch.sort does) finds the max_new-th smallest key
//      and only new keys up to it are kept (the plain version keeps the
//      max_new smallest distinct keys and drops the ones it finds).  It
//      sorts the kept new entries by (bucket, key) (the stable argsort of
//      the bucket over the key-sorted unique keys is this order, since the
//      keys are distinct): one warp in registers when they are at most 32,
//      else a bitonic sort in shared memory; ranks each in its bucket (the
//      warp's matching lanes, or a look-back over at most bucket_size
//      entries); counts alloc_rank over the entries that fit (a ballot,
//      or a block scan); writes each kept entry's key and row
//      (free_list[free_top - 1 - alloc_rank], read ahead during A) at
//      bucket * S + slot, adds to bucket_fill and lists the new rows; then
//      n_alloc and free_top, zeroes the counts, and raises the epoch (a
//      release store);
//   C. the new rows are reset (tsdf and weight 0, band_min inf, last_seen
//      and born the stamp: an int, or read from a 0-d device int through a
//      pointer): by the last CTA alone when there are at most kSmallRows
//      of them, else by every CTA; the other CTAs wait for the epoch
//      (acquire), and empty the set's slots past the first 1 024 with it.
// So the serial part (B) handles only the new keys: the probe of every
// distinct key runs in A, spread over the grid.  A dropped key (past the
// cap, its bucket full, the heap empty) writes nothing: the kernel skips
// it.  Integers throughout, so the state is bit-exact against the plain
// version and repeats from run to run.  The count n_alloc stays on the
// device; free_top drops by it.  Launches that share a scratch must be
// ordered (one stream, or a CUDA graph on it): the wrapper keeps one
// scratch a device and stream.
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
// its least time is the launch floor plus one grid-wide arrival (a
// barrier's cost).  What the pair replaces is ~60 eager launches and ~16
// host reads a frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

constexpr int kThreadsA = 256;   // K5a's CTA: 8 warps, 32 rays of a row each
constexpr int kRowsA = kThreadsA / 32;
constexpr int kMaxGridYZ = 65535;

struct CandidateParams {
  const float* verts;      // (H, W, 3) camera-space vertices
  const float* depth;      // (H, W) metric depth; 0 invalid
  const float* T_wc;       // (4, 4) row-major camera-to-world
  int* keys;               // (band_steps, h, w) out
  int H, W, stride, h, w, band_steps, key_bits, bs;
  // float32 of the plain version's Python doubles: truncation, its depth
  // scale, recip(voxel size); and torch.linspace(-1, 1, band_steps)'s
  // step, 2 / (band_steps - 1) divided in float32 on the host
  float trunc, trunc_scale, inv_voxel, step;
};

// torch.linspace(-1, 1, n)[s] as its CUDA kernel computes it from its
// step: start + step * s below the halfway index and end - step *
// (n - 1 - s) from it, each one fused multiply-add
__device__ __forceinline__ float band_step(int s, int n, float step) {
  if (n == 1) return -1.0f;
  return s < n / 2 ? __fmaf_rn(step, static_cast<float>(s), -1.0f)
                   : __fmaf_rn(-step, static_cast<float>(n - 1 - s), 1.0f);
}

// world2block of one world coordinate: trunc(p * recip(voxel) +- 0.5) to
// int32, then floor division by the block size (BS, or P.bs when 0)
template <int BS>
__device__ __forceinline__ int world_block(const CandidateParams& P, float w) {
  const float p = mul(w, P.inv_voxel);
  const int v = __float2int_rz(add(p, p >= 0.0f ? 0.5f : -0.5f));
  return BS != 0 ? floor_div(v, BS) : floor_div(v, P.bs);
}

// CTA (x, y, s): rays x 32 .. + 32 (a warp's lanes) of strided rows y
// kRowsA .. + kRowsA (one a warp) at band step s; rows past the grid's y
// and steps past its z taken in turn
template <int BS>
__global__ void __launch_bounds__(kThreadsA)
alloc_candidates_kernel(const __grid_constant__ CandidateParams P) {
  const int x = blockIdx.x * 32 + (threadIdx.x & 31);
  if (x >= P.w) return;
  const int64_t R = static_cast<int64_t>(P.h) * P.w;
  for (int y = blockIdx.y * kRowsA + (threadIdx.x >> 5); y < P.h;
       y += gridDim.y * kRowsA) {
    const int64_t pix = (static_cast<int64_t>(y) * P.W + x) * P.stride;
    // every load at entry, together: the depth, the vertex (whatever the
    // depth says: its address is valid), the pose
    const float d = __ldg(P.depth + pix);
    const float v0 = __ldg(P.verts + 3 * pix),
                v1 = __ldg(P.verts + 3 * pix + 1),
                v2 = __ldg(P.verts + 3 * pix + 2);
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = __ldg(P.T_wc + k);
    // _norm, the reciprocal, the unit ray
    const float len =
        __fsqrt_rn(add(add(mul(v0, v0), mul(v2, v2)), mul(v1, v1)));
    const float inv = dvd(1.0f, clamp_min(len, 1e-9f));
    const float d0 = mul(v0, inv), d1 = mul(v1, inv), d2 = mul(v2, inv);
    const float tr = add(mul(d, P.trunc_scale), P.trunc);
    const int bias = 1 << (P.key_bits - 1), lim = (1 << P.key_bits) - 1;
    for (int s = blockIdx.z; s < P.band_steps; s += gridDim.z) {
      const float st = mul(band_step(s, P.band_steps, P.step), tr);
      const float p0 = add(v0, mul(d0, st)), p1 = add(v1, mul(d1, st)),
                  p2 = add(v2, mul(d2, st));
      int b[3];
      bool in_range = true;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float w = add(dot_mm(p0, T[4 * j], p1, T[4 * j + 1], p2,
                                   T[4 * j + 2]), T[4 * j + 3]);
        b[j] = world_block<BS>(P, w) + bias;
        in_range = in_range && b[j] >= 0 && b[j] <= lim;
      }
      // an invalid ray (depth not > 0) or a block out of key range:
      // EMPTY_KEY
      P.keys[s * R + static_cast<int64_t>(y) * P.w + x] =
          d > 0.0f && in_range
              ? (b[0] << (2 * P.key_bits)) | (b[1] << P.key_bits) | b[2]
              : kEmptyKey;
    }
  }
}

// ---------------------------------------------------------------------------
// K5b
// ---------------------------------------------------------------------------

constexpr int kThreadsB = 1024;
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kMaxNew = 4096;                     // max_new_per_frame at most
constexpr int kItemsB = kMaxNew / kThreadsB;      // sorted entries a thread
constexpr int kSmallRows = 64;   // new rows the allocating CTA resets alone
constexpr int kProbe = 8;        // bucket slots a probe loads at once
constexpr uint64_t kPad = ~0ull;                  // sorts after every entry

// The persistent scratch, in ints: a header, then for a capacity of C
// keys the new entries (C uint64), the set (2^set_bits), the distinct
// keys and their slots (C each), the new entries' fills (C) and the new
// rows (kMaxNew).  The header's lines (128 bytes each): the counts of the
// distinct and the new keys (one uint64, so one atomic appends to both),
// the arrival count, the epoch (the flag: the allocating CTA raises it by
// one), and what the waiting CTAs read after it (n_alloc, and the distinct
// keys whose set slots they empty).  Between launches the set holds
// EMPTY_KEY and the counts are 0 (the wrapper makes it so; each launch
// restores it); the epoch runs on.  hash_ops.insert_scratch_size counts
// the ints.
constexpr int kHdrCounts = 0, kHdrArrive = 32, kHdrEpoch = 64,
              kHdrInfo = 96, kHdrInts = 128;

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
  int* hdr;                // scratch: the header
  unsigned long long* new_entry;   // scratch: (bucket, key ^ kSign)
  int* set;                // scratch: the open-addressing set
  int* distinct;           // scratch: the distinct keys, any order
  int* slot_of;            // scratch: each distinct key's set slot
  int* new_fill;           // scratch: each new entry's bucket fill
  int* rows;               // scratch: the new rows by alloc_rank
  int M, set_bits, nb, S, N, V, key_bits;
  int hash_buckets, divisor;   // BucketHash: spatial_hash(b, hash_buckets) // divisor
  int max_new, stamp;
};

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
  unsigned long long entry[kMaxNew];   // the kept new entries, sorted
  uint16_t fill[kMaxNew];    // their buckets' fills (bucket_size < 2^16)
  int rows[kSmallRows];      // the new rows, when at most kSmallRows
  int hist[256];
  int red[kWarpsB];
  int n_new, digit, rank_left, last, n_alloc, top, info[2];
};

// the cap: the max_new-th smallest of the U distinct keys (as key ^
// kSign), by 8 bits a pass; every thread of the CTA calls it
__device__ unsigned radix_cap(const InsertParams& P, AllocShared& sh, int U) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0, pmask = 0;
  if (tid == 0) sh.rank_left = P.max_new;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreadsB) sh.hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < U; i += kThreadsB) {
      const unsigned u = static_cast<unsigned>(__ldcg(P.distinct + i)) ^ kSign;
      if ((u & pmask) == prefix) atomicAdd(&sh.hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (warp == 0) {                     // the digit holding rank_left
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
  return prefix;
}

// write one kept entry: key and row at its slot, the fill, the row list
__device__ __forceinline__ void put_entry(const InsertParams& P,
                                          AllocShared& sh,
                                          unsigned long long e, int slot,
                                          int alloc_rank, int row) {
  const int b = static_cast<int>(e >> 32);
  P.keys[b * P.S + slot] = static_cast<int>(static_cast<unsigned>(e) ^ kSign);
  P.ptrs[b * P.S + slot] = row;
  atomicAdd(P.bucket_fill + b, 1);
  P.rows[alloc_rank] = row;
  if (alloc_rank < kSmallRows) sh.rows[alloc_rank] = row;
}

__device__ __forceinline__ int free_row(const InsertParams& P, int top, int r) {
  return __ldcg(P.free_list + min(max(top - 1 - r, 0), P.N - 1));
}

// at most 32 kept new entries, one a lane of warp 0 (valid where `valid`):
// a register bitonic sort of (entry, fill), each one's rank in its bucket
// from the lanes of the same bucket, alloc_rank from a ballot, its row
// from the lane that read it ahead (pre = free_list[top - 1 - lane])
__device__ void allocate_warp(const InsertParams& P, AllocShared& sh,
                              unsigned long long e, int f, bool valid,
                              int top, int pre) {
  const int lane = threadIdx.x & 31;
  if (!valid) e = kPad;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long oe = __shfl_xor_sync(kFull, e, j);
      const int of = __shfl_xor_sync(kFull, f, j);
      const bool take = ((lane & j) == 0) == ((lane & k) == 0) ? oe < e : oe > e;
      if (take) {
        e = oe;
        f = of;
      }
    }
  }
  valid = e != kPad;
  const unsigned lt = (1u << lane) - 1u;
  const unsigned same = __match_any_sync(kFull, static_cast<unsigned>(e >> 32));
  const int slot = f + __popc(same & lt);
  const bool fits = valid && slot < P.S;
  const unsigned fit_mask = __ballot_sync(kFull, fits);
  const int alloc_rank = __popc(fit_mask & lt);
  const int row = __shfl_sync(kFull, pre, alloc_rank & 31);
  if (fits && alloc_rank < top) put_entry(P, sh, e, slot, alloc_rank, row);
  if (lane == 0) {
    const int n_alloc = min(__popc(fit_mask), max(top, 0));
    *P.n_alloc = n_alloc;
    *P.free_top = top - n_alloc;
    sh.n_alloc = n_alloc;
  }
}

// phase B, the CTA that arrived last: cap, sort, rank, pop and scatter
// the new keys; returns U.  Thread 0 holds the epoch, warp 0 free_top and
// its read-ahead rows
__device__ int allocate_cta(const InsertParams& P, AllocShared& sh, int top,
                            int pre) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // one round trip: the counts, and the first kThreadsB entries, fills
  // and set slots on the chance that the counts cover them
  const unsigned long long counts =
      __ldcg(reinterpret_cast<const unsigned long long*>(P.hdr + kHdrCounts));
  const unsigned long long e0 = __ldcg(P.new_entry + tid);
  const int f0 = __ldcg(P.new_fill + tid);
  const int s0 = __ldcg(P.slot_of + tid);
  const int U = static_cast<int>(counts & 0xffffffffu);
  const int n_new = static_cast<int>(counts >> 32);
  if (U <= kThreadsB && tid < U) P.set[s0] = kEmptyKey;   // more: the grid's
  if (tid == 0) {
    sh.top = top;
    sh.n_new = 0;
  }
  const bool capped = U > P.max_new;
  if (!capped && n_new <= 32) {          // the frame step's case
    if (warp == 0) allocate_warp(P, sh, e0, f0, lane < n_new, top, pre);
    return U;
  }
  unsigned cap = 0xffffffffu;
  if (capped && P.max_new > 0) cap = radix_cap(P, sh, U);
  __syncthreads();
  top = sh.top;

  // the kept new entries and their fills into shared memory
  if (!capped || P.max_new > 0) {
    for (int i0 = warp * 32; i0 < n_new; i0 += kThreadsB) {
      const int i = i0 + lane;
      unsigned long long e = kPad;
      int f = 0;
      if (i < n_new) {
        e = i < kThreadsB ? e0 : __ldcg(P.new_entry + i);
        f = i < kThreadsB ? f0 : __ldcg(P.new_fill + i);
      }
      const bool keep = i < n_new && static_cast<unsigned>(e) <= cap;
      const unsigned m = __ballot_sync(kFull, keep);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(&sh.n_new, __popc(m));
      base = __shfl_sync(kFull, base, 0);
      if (keep) {
        const int at = base + __popc(m & ((1u << lane) - 1u));
        sh.entry[at] = e;
        sh.fill[at] = static_cast<uint16_t>(f);
      }
    }
  }
  __syncthreads();
  const int n = sh.n_new;
  if (n <= 32) {
    if (warp == 0)
      allocate_warp(P, sh, lane < n ? sh.entry[lane] : kPad,
                    lane < n ? sh.fill[lane] : 0, lane < n, top, pre);
    return U;
  }

  // the CTA: a bitonic sort of (entry, fill)[0, n2) in shared memory
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + tid; i < n2; i += kThreadsB) sh.entry[i] = kPad;
  int ahead[kItemsB];                                 // read ahead
#pragma unroll
  for (int q = 0; q < kItemsB; ++q)
    ahead[q] = tid * kItemsB + q < n ? free_row(P, top, tid * kItemsB + q) : 0;
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n2; i += kThreadsB) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = sh.entry[i], c = sh.entry[ixj];
          if ((a > c) == ((i & k) == 0)) {
            sh.entry[i] = c;
            sh.entry[ixj] = a;
            const uint16_t t = sh.fill[i];   // the fill moves with it
            sh.fill[i] = sh.fill[ixj];
            sh.fill[ixj] = t;
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
    slot[q] = sh.fill[i] + rank;
    fits += slot[q] < P.S;
  }
  int n_fit = 0;
  int alloc_rank = cta_exclusive_sum(fits, sh.red, n_fit);
#pragma unroll
  for (int q = 0; q < kItemsB; ++q) {
    const int i = tid * kItemsB + q;
    if (i >= n || slot[q] >= P.S) continue;
    if (alloc_rank < top)
      put_entry(P, sh, sh.entry[i], slot[q], alloc_rank,
                alloc_rank == i ? ahead[q] : free_row(P, top, alloc_rank));
    ++alloc_rank;
  }
  if (tid == 0) {
    const int n_alloc = min(n_fit, max(top, 0));
    *P.n_alloc = n_alloc;
    *P.free_top = top - n_alloc;
    sh.n_alloc = n_alloc;
  }
  return U;
}

// reset rows[r] for r = first, first + step, ... < n_alloc, `group`
// threads a row (this thread `t` of them); the list in shared memory, or
// in the scratch (written by another CTA: read from L2)
template <bool kSharedRows>
__device__ __forceinline__ void reset_rows(const InsertParams& P,
                                           const int* rows, int n_alloc,
                                           int first, int step, int t,
                                           int group, int stamp) {
  const bool vec = (P.V & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(P.tsdf) |
                     reinterpret_cast<uintptr_t>(P.weight)) & 15) == 0;
  for (int r = first; r < n_alloc; r += step) {
    const int row = kSharedRows ? rows[r] : __ldcg(rows + r);
    const int64_t o = static_cast<int64_t>(row) * P.V;
    if (vec) {
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4* a = reinterpret_cast<float4*>(P.tsdf + o);
      float4* b = reinterpret_cast<float4*>(P.weight + o);
      for (int v = t; v < P.V / 4; v += group) {
        a[v] = z;
        b[v] = z;
      }
    } else {
      for (int v = t; v < P.V; v += group) {
        P.tsdf[o + v] = 0.0f;
        P.weight[o + v] = 0.0f;
      }
    }
    if (t == 0) {
      P.band_min[row] = INFINITY;
      P.last_seen[row] = stamp;
      P.born[row] = stamp;
    }
  }
}

__global__ void __launch_bounds__(kThreadsB, 1)
insert_blocks_kernel(const __grid_constant__ InsertParams P) {
  __shared__ AllocShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gtid = blockIdx.x * kThreadsB + tid, gsize = gridDim.x * kThreadsB;
  // read ahead, for the CTA that will allocate: the epoch, the stamp and
  // free_top now, the top 32 rows of the free stack after phase A
  const int epoch = tid == 0 ? load_relaxed(P.hdr + kHdrEpoch) : 0;
  const int stamp = P.stamp_ptr ? __ldg(P.stamp_ptr) : P.stamp;
  const int top = warp == 0 ? __ldcg(P.free_top) : 0;

  // A. the distinct keys, each probed by the thread that inserts it: its
  // bucket's slots and fill loaded, and the set's atomicCAS sent, at once
  for (int i0 = gtid - lane; i0 < P.M; i0 += gsize) {
    const int i = i0 + lane;
    const int key = i < P.M ? __ldg(P.cand + i) : kEmptyKey;
    const unsigned peers = __match_any_sync(kFull, key);
    const bool leader = key != kEmptyKey && (__ffs(peers) - 1) == lane;
    int slot = -1, b = 0, fill = 0;
    bool found = false;
    if (leader) {
      b = bucket_of(P, key);
      const int* bk = P.keys + b * P.S;
      int k[kProbe];
#pragma unroll
      for (int s = 0; s < kProbe; ++s) k[s] = s < P.S ? bk[s] : ~key;
      fill = P.bucket_fill[b];
      const unsigned mask = (1u << P.set_bits) - 1u;
      unsigned s = (static_cast<unsigned>(key) * 2654435761u) >> (32 - P.set_bits);
      int prev = atomicCAS(P.set + s, kEmptyKey, key);
#pragma unroll
      for (int q = 0; q < kProbe; ++q) found |= k[q] == key;
      for (int q = kProbe; q < P.S; ++q) found |= bk[q] == key;
      while (prev != kEmptyKey && prev != key) {
        s = (s + 1u) & mask;
        prev = atomicCAS(P.set + s, kEmptyKey, key);
      }
      if (prev == kEmptyKey) slot = static_cast<int>(s);
    }
    // one atomic appends the warp's distinct and new keys
    const bool first = slot >= 0, fresh = first && !found;
    const unsigned mf = __ballot_sync(kFull, first);
    const unsigned mn = __ballot_sync(kFull, fresh);
    unsigned long long base = 0;
    if (lane == 0 && mf)
      base = atomicAdd(reinterpret_cast<unsigned long long*>(P.hdr + kHdrCounts),
                       static_cast<unsigned long long>(__popc(mf)) |
                           (static_cast<unsigned long long>(__popc(mn)) << 32));
    base = __shfl_sync(kFull, base, 0);
    const unsigned lt = (1u << lane) - 1u;
    if (first) {
      const int at = static_cast<int>(base & 0xffffffffu) + __popc(mf & lt);
      P.distinct[at] = key;
      P.slot_of[at] = slot;
    }
    if (fresh) {
      const int at = static_cast<int>(base >> 32) + __popc(mn & lt);
      P.new_entry[at] = (static_cast<unsigned long long>(b) << 32) |
                        (static_cast<unsigned>(key) ^ kSign);
      P.new_fill[at] = fill;
    }
  }
  const int pre = warp == 0 ? free_row(P, top, lane) : 0;

  // B. the CTA that arrives last allocates, then raises the epoch
  __syncthreads();
  if (tid == 0)
    sh.last = atomic_add_acq_rel(P.hdr + kHdrArrive, 1) ==
              static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  const bool last = sh.last;
  if (last) {
    const int U = allocate_cta(P, sh, top, pre);
    __syncthreads();
    if (tid == 0) {               // every thread has read the counts
      *reinterpret_cast<unsigned long long*>(P.hdr + kHdrCounts) = 0ull;
      P.hdr[kHdrArrive] = 0;
      sh.info[0] = sh.n_alloc;
      sh.info[1] = U > kThreadsB ? U : 0;
      P.hdr[kHdrInfo] = sh.info[0];
      P.hdr[kHdrInfo + 1] = sh.info[1];
      store_release(P.hdr + kHdrEpoch, epoch + 1);
    }
  } else if (tid == 0) {
    while (load_acquire(P.hdr + kHdrEpoch) == epoch) __nanosleep(32);
    sh.info[0] = __ldcg(P.hdr + kHdrInfo);
    sh.info[1] = __ldcg(P.hdr + kHdrInfo + 1);
  }
  __syncthreads();

  // C. the new rows reset: by the last CTA alone when few, else by the
  // grid; the set's slots past the last CTA's kThreadsB by the grid
  const int n_alloc = sh.info[0], U_grid = sh.info[1];
  if (n_alloc <= kSmallRows) {
    if (last)
      reset_rows<true>(P, sh.rows, n_alloc, warp, kWarpsB, lane, 32, stamp);
  } else {
    reset_rows<false>(P, P.rows, n_alloc, blockIdx.x, gridDim.x, tid,
                      kThreadsB, stamp);
  }
  for (int i = gtid; i < U_grid; i += gsize)
    P.set[__ldcg(P.slot_of + i)] = kEmptyKey;
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
// of the frame (vertices (H, W, 3), depth (H, W)) at pose T_wc.  Host
// tables (built once a configuration): ints = stride, band steps, key
// bits, block size; floats = truncation, its depth scale, recip(voxel
// size), linspace's step 2 / (band steps - 1) as float32 (0 for one step).
extern "C" int alloc_candidates(const float* verts, const float* depth,
                                const float* T_wc, int* keys, int H, int W,
                                const int* ints, const float* floats,
                                void* stream) {
  const int stride = ints[0], band_steps = ints[1], key_bits = ints[2],
            block_size = ints[3];
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
  P.trunc = floats[0];
  P.trunc_scale = floats[1];
  P.inv_voxel = floats[2];
  P.step = floats[3];
  const dim3 grid((P.w + 31) / 32,
                  min((P.h + kRowsA - 1) / kRowsA, kMaxGridYZ),
                  min(band_steps, kMaxGridYZ));
  using CandidateKernel = void (*)(CandidateParams);
  const CandidateKernel kernel = block_size == 8 ? alloc_candidates_kernel<8>
                                                 : alloc_candidates_kernel<0>;
  kernel<<<grid, kThreadsA, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K5b.  Insert the distinct keys of cand (M,) into the table (nb buckets of
// S slots) with BucketHash(hash_buckets, divisor), at most max_new of them
// (the smallest); reset the new rows with the stamp (*stamp_ptr when it is
// not null); n_alloc = the rows taken.  scratch: kHdrInts + 5 capacity +
// 2^set_bits + kMaxNew ints for up to `capacity` keys (2^set_bits >= 2
// capacity, set_bits >= 2), its set EMPTY_KEY and its counts 0, as every
// launch leaves them.  Host tables (built once a map and configuration):
// map = the HashMap's tensors in field order (keys, ptrs, bucket_fill,
// free_list, free_top, tsdf, weight, last_seen, band_min, born); ints = nb,
// S, N, V, key_bits, hash_buckets, divisor, max_new.  One cooperative
// launch, refused (cudaErrorCooperativeLaunchTooLarge) when its grid
// cannot be co-resident.
extern "C" int insert_blocks(const int* cand, int M, int* n_alloc,
                             const int* stamp_ptr, int stamp, int* scratch,
                             int capacity, int set_bits,
                             void* const* map, const int* ints,
                             void* stream) {
  const int nb = ints[0], S = ints[1], N = ints[2], V = ints[3],
            key_bits = ints[4], hash_buckets = ints[5], divisor = ints[6],
            max_new = ints[7];
  if (M < 0 || M > capacity || set_bits < 2 || set_bits > 30 ||
      (static_cast<int64_t>(1) << set_bits) < 2 * static_cast<int64_t>(capacity) ||
      nb < 1 || S < 1 || S > 65535 || N < 1 || V < 0 || key_bits < 1 ||
      key_bits > 10 || hash_buckets < 1 || divisor < 1 || max_new < 0 ||
      max_new > kMaxNew)
    return static_cast<int>(cudaErrorInvalidValue);
  InsertParams P = {};
  P.cand = cand;
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
  P.n_alloc = n_alloc;
  P.stamp_ptr = stamp_ptr;
  P.hdr = scratch;
  P.new_entry = reinterpret_cast<unsigned long long*>(scratch + kHdrInts);
  P.set = scratch + kHdrInts + 2 * static_cast<int64_t>(capacity);
  P.distinct = P.set + (static_cast<int64_t>(1) << set_bits);
  P.slot_of = P.distinct + capacity;
  P.new_fill = P.slot_of + capacity;
  P.rows = P.new_fill + capacity;
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
  int resident = 0;
  cudaError_t err = capacity_of(insert_blocks_kernel, kThreadsB, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = min(resident, max(1, (M + kThreadsB - 1) / kThreadsB));
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
