// Visible-set compaction and TSDF integration for Hopper (sm_90a), two
// kernels:
//
//   compact_visible (K6): the frustum test of every table entry and the
//     stream compaction of the visible ones into the padded ActiveSet.
//     Replaces what XLA fused on the TPU in voxelhashing_demo_tpu/ops/
//     hash_ops.py: block_in_frustum (:319) and compact_visible (:365).
//   integrate_rows (K7): the Curless-Levoy update of every voxel of
//     active[:count], with the window depth gather and the visibility stamp
//     fused in.  Replaces _integrate_rows (:405) through integrate (:511),
//     the Pallas window gather it calls (voxelhashing_demo_tpu/ops/
//     pallas_gather.py:88, gather_depth_window, whose `covered` becomes the
//     voxel's in-image flag) and touch_active (:648), as fuse_frame (:893)
//     and defuse_frame (:915) call them.
//
// No PyTorch call computes either.
//
// K6.  One launch, no grid barrier.  The table is cut into tiles of
// kTile entries, CTA b taking tiles b, b + gridDim.x, ...; the grid is one
// CTA a tile up to the CTAs the card holds at once, so every CTA runs and
// a CTA only ever waits for tiles that running CTAs hold.  Item k of
// thread t in a tile is entry k * kThreads + t, so every load is
// coalesced; the keys are loaded with the ptrs, in the same round trip,
// and warp 0 reads the launch's epoch under them.  Each CTA tests its
// entries (the keys unpacked, the block centre moved into the camera, the
// z-adaptive pixel margin), counts the visible ones of each (item, warp)
// segment by warp ballots, and warp 0 scans the 64 segments (their
// exclusive offsets and the tile's count) and publishes the count as the
// tile's status.  Then the counts of the tiles before it:
//   - a table of at most kSnapTiles tiles (the step's 262 144 entries are
//     128) takes one snapshot of every tile's status (4 a lane, loaded
//     together), polled until all carry this launch's tag: the tiles
//     before and the set's size in one round trip, so every CTA writes
//     its share of the pad rows [count, max_active) at once;
//   - a larger one looks back (a decoupled look-back): 32 predecessors'
//     statuses a round, summed up to the nearest one that holds its
//     inclusive prefix, then publishes its own; after its last tile every
//     CTA waits for the last tile's inclusive prefix, the set's size, and
//     writes its share of the pad rows.
// The exclusive rank of a visible entry is the sum of the tiles before its
// own, of the segments before its own, and of the lanes below it in its
// ballot.  Integers throughout, so the order is exact and repeats.
// Entries ranked at or past max_active are dropped; the pad rows (zero
// blocks, FREE_PTR, 16-byte stores) make every row past `count` padding,
// as touch_active and splat's row skip assume; the CTA of the last tile
// writes the count.  A status is one 64-bit word (the launch's tag, an
// inclusive flag, a value), written and read whole, so no fence orders
// it; statuses lie kStatusStride words (128 bytes) apart, since 128 CTAs
// polling one status line were slower by ~0.8 us on an H100 (PERF.md
// section 6).  The tag is the launch's epoch, which the CTA of the last
// tile raises once every tile has published: a status left by an earlier
// launch never passes for this one's, and nothing clears the scratch.
// The earlier design ran the same tiles and ranks as one cooperative
// launch with a grid barrier between the counts and the ranks, then two
// reads of every tile's count (~1.2 us of the barrier alone on an H100);
// one with a tile counter (an atomic ticket a tile) was slower, its 128
// atomics on one word in series.
//
// K7.  A row group takes a row, each thread 4 neighbouring voxels
// (16-byte loads and stores of tsdf and weight; voxel i = lx + bs (ly + bs
// lz), so voxels 4k..4k+3 are contiguous), 128 threads at block size 8; a
// V that is not a multiple of 4 takes an instantiation of one voxel a
// thread.  A CTA holds several row groups (512 threads: 4 at block size
// 8), each with a named barrier of its own, so they run apart.  Group g of
// CTA b takes rows b + g gridDim.x, then G gridDim.x on: the rows spread
// evenly over the CTAs and the multiprocessors.  The grid is as many CTAs
// as the card holds at once (264 at block size 8), no more than the rows
// need, so the step's ~770 rows are all in flight in one wave.  The CTAs
// launched cost time of their own, those that find no row too (PERF.md
// section 6: a grid of 1 056 CTAs of a row each was ~1.2 us slower at the
// step's rows than one of 792; a group of consecutive rows a CTA bunched
// the rows on a third of the multiprocessors).  A row is a chain of
// dependent reads; the design shortens it: the first row's ptr and block
// are read before the count, the row's tsdf, weight and born right after
// its ptr (they depend on nothing else, so their round trip overlaps the
// projection and the window's reduction), and the depth under each voxel
// in the image before that reduction, which only decides which reads
// count.  At most 64 registers a thread keep two CTAs a multiprocessor.  Per voxel, in the plain
// version's order: project it (project_rows), in the window mode reduce
// the row's minimum (v, u) over its in-image voxels in the group and apply
// the window's coverage (K1, csrc/window_gather.cu: integers, exact), read
// the depth, apply the update (both signs, the max_born row gate), store
// tsdf and weight only where their bits change (a voxel that takes no
// sample keeps its bits, but for the inverse update's clamp), reduce
// band_min (min |fused| over voxels with weight > 0, rewritten for every
// row, as the plain version does) and, with a stamp, write last_seen.  A
// FREE_PTR row is skipped whole.  Rows are distinct, so no two groups
// touch one map row.
//
// Rounding: every product, sum and quotient of the plain PyTorch versions
// (ops/hash_ops.py block_in_frustum, project_rows, _integrate_rows; ops/
// tsdf.py sample_weight) on the card is written with the round-to-nearest
// intrinsics, in their order, so nvcc contracts nothing the plain versions
// round: the (N, 3) @ (3, 3) product and se3.inverse's einsum as the
// library's kernels sum them (dot_mm, dot_inv; K8's measurement, probed
// again at the table's and the visible rows' sizes by chip_rounding_probe.py),
// then + t; x / z * fx + cx; the frustum margin radius * fx / zm as
// reciprocal(zm) * (radius * fx), since a Python double over a tensor is
// Tensor.__rtruediv__; Python doubles cast to float32 where they meet a
// float32 tensor (comparisons too); trunc as trunc_scale * depth, then +
// truncation; sample_weight's chain; the update's two products, their sum
// or difference and one IEEE divide.  torch.round is rintf (half to even).
//
// Bound: bytes, far below the launches they replace.  K6 must read every
// ptr (4 B an entry: 1.05 MB at the flagship) and the keys of the live
// entries only, and write the set (16 B a row): ~0.34 us at 3.35 TB/s,
// below the launch floor (~1 us); what it cannot go below is the launch,
// one load round trip and the round trip that exchanges the tiles'
// counts.  K7 must
// read each live voxel's tsdf and weight (8 B), write the values the
// update changes, and read the depth pixels that covered voxels reach
// (L2-resident): ~1.8 us at the step's ~770 rows (chip_smoke.py counts
// both from its run's data); its time is the launch and one row's chain
// of dependent reads and two CTA reductions, since every row is in
// flight at once.  What the pair replaces is ~130 eager
// launches and ~14 host reads a frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_status.cuh"

namespace {

using tile_status::kBackoffNs;
using tile_status::kInclusive;
using tile_status::kValueMask;
using tile_status::load_status;
using tile_status::make_status;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp's NaN rule: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// a0 b0 + a1 b1 + a2 b2 as the card's (N, 3) @ (3, 3) matmul sums it
// (a copy of csrc/splat.cu's, so that each source's hash covers what it runs)
__device__ __forceinline__ float dot_mm(float a0, float b0, float a1, float b1,
                                        float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}

// a0 b0 + a1 b1 + a2 b2 as se3.inverse's einsum("ij,j->i") sums it on the
// card (a matrix-vector product)
__device__ __forceinline__ float dot_inv(float a0, float b0, float a1,
                                         float b1, float a2, float b2) {
  return add(__fmaf_rn(a1, b1, mul(a0, b0)), mul(a2, b2));
}

// world -> camera of se3.apply(se3.inverse(T_wc), p): R^T and -(R^T t)
struct Pose {
  float R[3][3];      // T_wc's rotation: pc_j = sum_i p_i R[i][j] + t_cw[j]
  float t_cw[3];
};

__device__ __forceinline__ Pose load_pose(const float* T) {
  Pose P;
  float t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P.R[k][j] = __ldg(T + 4 * k + j);
    t[k] = __ldg(T + 4 * k + 3);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    P.t_cw[j] = -dot_inv(P.R[0][j], t[0], P.R[1][j], t[1], P.R[2][j], t[2]);
  return P;
}

__device__ __forceinline__ float to_camera(const Pose& P, int j, float w0,
                                           float w1, float w2) {
  return add(dot_mm(w0, P.R[0][j], w1, P.R[1][j], w2, P.R[2][j]), P.t_cw[j]);
}

constexpr int kFreePtr = -1;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

constexpr int kThreads6 = 256;
constexpr int kWarps6 = kThreads6 / 32;
constexpr int kItems = 8;                    // entries a thread in a tile
constexpr int kTile = kThreads6 * kItems;    // entries a tile
constexpr int kSegments = kItems * kWarps6;  // (item, warp) segments a tile

// K6's scratch, persistent a device and stream (ops/hash_ops.py keeps
// it): 64-bit words, word 0 the epoch word (the epoch in the high half, 0
// in the low half), then a status every kStatusStride words
// (csrc/tile_status.cuh: the tile's count, or with the flag the visible
// entries of tiles 0..t).  An epoch's tag comes back after 2^31
// launches, and every launch rewrites the statuses of its own tiles.
constexpr int kSnapTiles = 128;   // tables of at most this many tiles: one
                                  // snapshot of every tile's count
constexpr int kStatusStride = 16; // 64-bit words from a status to the next

struct CompactParams {
  const int* keys;         // (T,) packed block keys
  const int* ptrs;         // (T,) map rows; FREE_PTR free
  const float* T_wc;       // (4, 4) row-major camera-to-world
  int* out;                // blocks (A, 3), then ptrs (A,), then the count
  unsigned long long* scratch;   // the epoch word, then n_tiles statuses
  int T, A, n_tiles, key_bits, bs;
  int snap;                // one CTA a tile and at most kSnapTiles tiles
  // block_in_frustum's constants, each the float32 of the plain version's
  // Python double: voxel size, half a block, the camera, the pixel margin,
  // radius * fx and radius * fy, the near and far planes
  float voxel_size, half, fx, fy, cx, cy, width, height, margin, rfx, rfy,
      znear, zfar;
};

// block_in_frustum of a table entry, and ptr != FREE_PTR
__device__ __forceinline__ bool visible(const CompactParams& P,
                                        const Pose& pose, int key, int ptr) {
  if (ptr == kFreePtr) return false;
  const int mask = (1 << P.key_bits) - 1, bias = 1 << (P.key_bits - 1);
  const int b0 = ((key >> (2 * P.key_bits)) & mask) - bias;
  const int b1 = ((key >> P.key_bits) & mask) - bias;
  const int b2 = (key & mask) - bias;
  // block2world + half
  const float c0 = add(mul(static_cast<float>(b0 * P.bs), P.voxel_size), P.half);
  const float c1 = add(mul(static_cast<float>(b1 * P.bs), P.voxel_size), P.half);
  const float c2 = add(mul(static_cast<float>(b2 * P.bs), P.voxel_size), P.half);
  const float x = to_camera(pose, 0, c0, c1, c2);
  const float y = to_camera(pose, 1, c0, c1, c2);
  const float z = to_camera(pose, 2, c0, c1, c2);
  const float safe_z = clamp_min(z, 1e-6f);
  const float u = add(mul(dvd(x, safe_z), P.fx), P.cx);
  const float v = add(mul(dvd(y, safe_z), P.fy), P.cy);
  // margin + (radius * f) / zm, the quotient as reciprocal * numerator
  const float r = dvd(1.0f, clamp_min(z, 0.05f));
  const float mu = add(mul(r, P.rfx), P.margin);
  const float mv = add(mul(r, P.rfy), P.margin);
  return z > P.znear && z < P.zfar && u >= -mu && u < add(mu, P.width) &&
         v >= -mv && v < add(mv, P.height);
}

// the tile's entries of this thread (item k: entry k * kThreads6 + t) and
// their visible flags as bits; the pose is read after the entries' loads
// are sent, so that its round trip and its arithmetic run under theirs
__device__ __forceinline__ unsigned test_tile(const CompactParams& P,
                                              int tile, int* key, int* ptr) {
  const int base = tile * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads6;
    key[k] = i < P.T ? __ldg(P.keys + i) : 0;
    ptr[k] = i < P.T ? __ldg(P.ptrs + i) : kFreePtr;
  }
  const Pose pose = load_pose(P.T_wc);
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (visible(P, pose, key[k], ptr[k])) bits |= 1u << k;
  return bits;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// p[lo, hi) = v over the grid: 16-byte stores over the aligned middle
// (p is 16-byte aligned), ints at the ends
__device__ __forceinline__ void fill_ints(int* p, int lo, int hi, int v,
                                          int gtid, int gsize) {
  const int a = min(hi, (lo + 3) & ~3), b = max(a, hi & ~3);
  for (int i = lo + gtid; i < a; i += gsize) p[i] = v;
  for (int i = b + gtid; i < hi; i += gsize) p[i] = v;
  const int4 q = make_int4(v, v, v, v);
  for (int i = a / 4 + gtid; i < b / 4; i += gsize)
    reinterpret_cast<int4*>(p)[i] = q;
}

// Tile `tile` of a launch whose statuses carry `tag`: its entries tested,
// ranked and written; returns the visible entries of tiles 0..tile (its
// inclusive prefix), or of every tile where the table takes a snapshot.
// Every thread of the CTA calls it; seg and sh (2 ints) are the CTA's
// shared scratch.
__device__ __forceinline__ int compact_tile(const CompactParams& P,
                                            int tile, unsigned tag,
                                            unsigned long long* status,
                                            int* seg, int* sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int key[kItems], ptr[kItems];
  const unsigned bits = test_tile(P, tile, key, ptr);
  unsigned ballot[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    ballot[k] = __ballot_sync(kFull, (bits >> k) & 1u);
    if (lane == 0) seg[k * kWarps6 + warp] = __popc(ballot[k]);
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the 64 segments: their offsets, the tile's count
    static_assert(kSegments == 64, "two segments a lane");
    const int a = seg[2 * lane], b = seg[2 * lane + 1];
    int incl = a + b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    const int excl = incl - a - b;
    seg[2 * lane] = excl;
    seg[2 * lane + 1] = excl + a;
    const int n = __shfl_sync(kFull, incl, 31);
    int before = 0, through = 0;
    if (P.snap) {
      if (lane == 0)
        store_status(status + kStatusStride * tile, make_status(tag, false, n));
      const int2 c = tile_status::snapshot<kStatusStride, kSnapTiles>(
          status, P.n_tiles, tile, tag, lane);
      before = c.x;
      through = c.y;             // every tile's: the set's size
    } else {
      if (tile > 0) {
        if (lane == 0)
        store_status(status + kStatusStride * tile, make_status(tag, false, n));
        before = tile_status::look_back<kStatusStride>(status, tile, tag,
                                                        lane);
      }
      if (lane == 0)
        store_status(status + kStatusStride * tile,
                     make_status(tag, true, before + n));
      through = before + n;
    }
    if (lane == 0) {
      sh[0] = before;
      sh[1] = through;
    }
  }
  __syncthreads();
  const int base = sh[0], total = sh[1];
  if (P.snap) {
    // every CTA knows the set's size: its share of the pad rows now
    const int count = min(total, P.A);
    const int gtid = blockIdx.x * kThreads6 + tid;
    const int gsize = gridDim.x * kThreads6;
    fill_ints(P.out, 3 * count, 3 * P.A, 0, gtid, gsize);
    fill_ints(P.out, 3 * P.A + count, 4 * P.A, kFreePtr, gtid, gsize);
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (!((bits >> k) & 1u)) continue;
    const int pos = base + seg[k * kWarps6 + warp] + __popc(ballot[k] & below);
    if (pos >= P.A) continue;
    const int mask = (1 << P.key_bits) - 1, bias = 1 << (P.key_bits - 1);
    P.out[3 * pos] = ((key[k] >> (2 * P.key_bits)) & mask) - bias;
    P.out[3 * pos + 1] = ((key[k] >> P.key_bits) & mask) - bias;
    P.out[3 * pos + 2] = (key[k] & mask) - bias;
    P.out[3 * P.A + pos] = ptr[k];
  }
  __syncthreads();                     // seg and sh are rewritten next
  return total;
}

__global__ void __launch_bounds__(kThreads6)
compact_visible_kernel(const __grid_constant__ CompactParams P) {
  __shared__ int seg[kSegments];
  __shared__ int sh[2];
  __shared__ int sh_count;
  const int tid = threadIdx.x;
  unsigned long long* status = P.scratch + 1;
  // warp 0 (which alone publishes and looks back) reads the epoch, its
  // round trip under the table's loads
  unsigned tag = 0;
  if (tid < 32)
    tag = 0x80000000u |
          (static_cast<unsigned>(load_status(P.scratch) >> 32) & kValueMask);
  int total = -1;              // known to the CTA that ranked the last tile
  // tile b, b + gridDim.x, ...: the grid is co-resident at most, so the
  // tiles a snapshot or look-back waits for are held by CTAs that run; the
  // CTA of the last tile raises the epoch once every tile has published
  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    const int t = compact_tile(P, tile, tag, status, seg, sh);
    if (tile == P.n_tiles - 1) {
      total = t;
      if (tid == 0) {
        store_status(P.scratch,
                     static_cast<unsigned long long>((tag & kValueMask) + 1)
                         << 32);
        P.out[4 * P.A] = min(total, P.A);
      }
    }
  }

  if (P.snap) return;           // the pad rows are written
  // the count and the pad rows: every tile is held by a running CTA, so
  // the last tile's inclusive prefix comes
  if (tid == 0) {
    if (total < 0) {
      unsigned long long s;
      while (static_cast<unsigned>(
                 (s = load_status(status + kStatusStride * (P.n_tiles - 1))) >>
                 32) != tag ||
             !(s & kInclusive))
        __nanosleep(32);
      total = static_cast<int>(s & kValueMask);
    }
    sh_count = min(total, P.A);
  }
  __syncthreads();
  const int count = sh_count;
  const int gtid = blockIdx.x * kThreads6 + tid, gsize = gridDim.x * kThreads6;
  fill_ints(P.out, 3 * count, 3 * P.A, 0, gtid, gsize);
  fill_ints(P.out, 3 * P.A + count, 4 * P.A, kFreePtr, gtid, gsize);
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

constexpr int kMaxVoxels = 1024;                   // voxels a block at most
constexpr int kMaxWarps7 = 32;
constexpr int kCtaThreads7 = 512;    // a CTA's threads: row groups of a row each
constexpr int kMaxGroups7 = 8;       // row groups a CTA (named barriers 1..8)

// threads of a K7 CTA for V voxels, vpt a thread: whole warps, at least one
__host__ __device__ constexpr int threads7(int V, int vpt) {
  return ((V + vpt - 1) / vpt + 31) / 32 * 32;
}

struct IntegrateParams {
  const int* blocks;       // (A, 3) block coords
  const int* ptrs;         // (A,) map rows; FREE_PTR pad
  const int* count;        // () rows in use (device)
  float* tsdf;             // (N, V)
  float* weight;           // (N, V)
  float* band_min;         // (N,)
  const int* born;         // (N,)
  int* last_seen;          // (N,)
  const float* depth;      // (H, W) metric depth
  const float* T_wc;       // (4, 4) row-major camera-to-world
  const int* stamp_ptr;    // () the stamp on the device, or null: `stamp`
  int rows, n_map_rows, bs, V, H, W, wh, ww;
  int groups, group_threads;   // row groups a CTA, threads a group
  int window;              // the window gather's coverage (K1's mode)
  int sign;                // +1 integrate, -1 de-integrate
  int gate_born, max_born; // rows with born > max_born take no sample
  int stamp_on, stamp;     // last_seen[ptr] = stamp
  int falloff;             // FusionConfig.depth_weight_falloff
  // float32 of the plain version's Python doubles: voxel size, camera,
  // truncation and its depth scale, weight_sample, weight_sample * 1.5,
  // depth_min, recip(depth_max - depth_min), max_weight, the inverse
  // update's clamp truncation + trunc_scale * depth_max
  float voxel_size, fx, fy, cx, cy, trunc, trunc_scale, w_sample, w_sample15,
      dmin, rdrange, max_weight, tmax;
};

// tsdf.sample_weight of one depth
__device__ __forceinline__ float sample_weight(const IntegrateParams& P,
                                               float d) {
  if (!P.falloff) return P.w_sample;
  const float d01 = clamp(mul(sub(d, P.dmin), P.rdrange), 0.0f, 1.0f);
  return clamp_min(mul(P.w_sample15, sub(1.0f, d01)), 1.0f);
}

// VPT values of a row at voxel i0 (16-byte loads and stores at VPT 4)
template <int VPT>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[VPT]) {
  if constexpr (VPT == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) v[k] = p[k];
  }
}

template <int VPT>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[VPT]) {
  if constexpr (VPT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) p[k] = v[k];
  }
}

// A thread's voxels' offsets in the block (the same for every row):
// voxel i = lx + bs (ly + bs lz)
template <int VPT>
struct Local {
  int lx[VPT], ly[VPT], lz[VPT];
};

template <int VPT>
__device__ __forceinline__ Local<VPT> local_offsets(int i0, int bs) {
  Local<VPT> L;
  if (VPT > 1 && bs % VPT == 0) {     // one row of the block: one division
    const int t = i0 / bs;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      L.lx[k] = i0 - t * bs + k;
      L.ly[k] = t % bs;
      L.lz[k] = t / bs;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = i0 + k;
      L.lx[k] = i % bs;
      L.ly[k] = (i / bs) % bs;
      L.lz[k] = i / (bs * bs);
    }
  }
  return L;
}

// A row group's barrier: a warp's own, or named barrier 1 + g over the
// group's threads (barrier 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int g, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(threads) : "memory");
}

// One row of the active set for row group g (its threads' ids gtid, VPT
// neighbouring voxels each; its warps wf .. wf + warps - 1 of the CTA);
// parity picks the reduction slots (two rows in flight at most).
template <int VPT>
__device__ __forceinline__ void integrate_row(const IntegrateParams& P,
                                              const Pose& pose,
                                              const Local<VPT>& L, int ptr,
                                              int bx, int by, int bz,
                                              int stamp, int parity, int g,
                                              int gtid,
                                              int (&red_v)[2][kMaxWarps7],
                                              int (&red_u)[2][kMaxWarps7],
                                              float (&red_b)[2][kMaxWarps7]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = P.group_threads >> 5, wf = warp - (gtid >> 5);
  const int row = min(max(ptr, 0), P.n_map_rows - 1);
  const int i0 = gtid * VPT;
  const bool act = i0 < P.V;            // V is a multiple of VPT
  const int64_t o = static_cast<int64_t>(row) * P.V + i0;

  // the row's values and its born gate first: they depend on the row alone
  float old_s[VPT], old_w[VPT];
  if (act) {
    load_vals<VPT>(P.tsdf + o, old_s);
    load_vals<VPT>(P.weight + o, old_w);
  }
  const bool born_ok = !P.gate_born || __ldg(P.born + row) <= P.max_born;

  // project_rows: the voxel's camera depth and clamped pixel
  const float fW1 = static_cast<float>(P.W - 1), fH1 = static_cast<float>(P.H - 1);
  float z[VPT];
  int vi[VPT], ui[VPT];
  bool in_img[VPT];
  int mv = P.H, mu = P.W;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    in_img[k] = false;
    vi[k] = 0;
    ui[k] = 0;
    z[k] = 0.0f;
    if (!act) continue;
    const float w0 = mul(static_cast<float>(bx + L.lx[k]), P.voxel_size);
    const float w1 = mul(static_cast<float>(by + L.ly[k]), P.voxel_size);
    const float w2 = mul(static_cast<float>(bz + L.lz[k]), P.voxel_size);
    const float x = to_camera(pose, 0, w0, w1, w2);
    const float y = to_camera(pose, 1, w0, w1, w2);
    const float zz = to_camera(pose, 2, w0, w1, w2);
    // camera.project_nearest
    const float safe_z = fabsf(zz) > 1e-12f ? zz : 1e-12f;
    const float u = add(mul(dvd(x, safe_z), P.fx), P.cx);
    const float v = add(mul(dvd(y, safe_z), P.fy), P.cy);
    // u in [0, W - 1] puts rint(u) there too: the pixel needs no test
    in_img[k] = zz > 0.0f && u >= 0.0f && u <= fW1 && v >= 0.0f && v <= fH1;
    ui[k] = min(max(static_cast<int>(rintf(u)), 0), P.W - 1);
    vi[k] = min(max(static_cast<int>(rintf(v)), 0), P.H - 1);
    z[k] = zz;
    if (in_img[k]) {
      mv = min(mv, vi[k]);
      mu = min(mu, ui[k]);
    }
  }

  // the depth under each voxel in the image, read before the window's
  // reduction (which only decides which of these reads count), so that
  // the round trip overlaps it
  float d[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    d[k] = in_img[k] ? __ldg(P.depth + vi[k] * P.W + ui[k]) : 0.0f;

  // K1's window: the row's minimum (v, u) over its in-image voxels,
  // clamped, then coverage replaces the in-image flag
  if (P.window) {
    mv = __reduce_min_sync(kFull, mv);
    mu = __reduce_min_sync(kFull, mu);
    if (lane == 0) {
      red_v[parity][warp] = mv;
      red_u[parity][warp] = mu;
    }
    group_sync(g, P.group_threads);
    for (int w = wf; w < wf + warps; ++w) {
      mv = min(mv, red_v[parity][w]);
      mu = min(mu, red_u[parity][w]);
    }
    const int v0 = min(max(mv, 0), max(P.H - P.wh, 0));
    const int u0 = min(max(mu, 0), max(P.W - P.ww, 0));
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int dv = vi[k] - v0, du = ui[k] - u0;
      in_img[k] = in_img[k] && dv >= 0 && dv < P.wh && du >= 0 && du < P.ww;
    }
  }

  // the update; a value is stored only where its bits
  // change (a voxel with no sample keeps them, but for the inverse
  // update's clamp)
  float bmin = INFINITY;
  if (act) {
#pragma unroll
    for (int k = 0; k < VPT; ++k)   // a voxel the window leaves out: no sample
      if (!in_img[k]) d[k] = 0.0f;
    float fused[VPT], new_w[VPT];
    bool ch_s = false, ch_w = false;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float sdf = sub(d[k], z[k]);
      const float trunc = add(mul(d[k], P.trunc_scale), P.trunc);
      const bool valid = in_img[k] && born_ok && d[k] > 0.0f && z[k] > 0.0f &&
                         sdf > -trunc;
      const float sc = fminf(fmaxf(sdf, -trunc), trunc);
      const float w_new = valid ? sample_weight(P, d[k]) : 0.0f;
      if (P.sign > 0) {
        const float w_sum = add(old_w[k], w_new);
        fused[k] = w_new > 0.0f
            ? dvd(add(mul(old_s[k], old_w[k]), mul(sc, w_new)),
                  clamp_min(w_sum, 1e-12f))
            : old_s[k];
        new_w[k] = w_new > 0.0f ? clamp(w_sum, -INFINITY, P.max_weight)
                                : old_w[k];
      } else {
        const float w_rem = clamp_min(sub(old_w[k], w_new), 0.0f);
        float f = w_new > 0.0f
            ? (w_rem > 1e-6f ? dvd(sub(mul(old_s[k], old_w[k]), mul(sc, w_new)),
                                   clamp_min(w_rem, 1e-12f))
                             : 0.0f)
            : old_s[k];
        fused[k] = clamp(f, -P.tmax, P.tmax);
        new_w[k] = w_new > 0.0f ? w_rem : old_w[k];
      }
      ch_s |= __float_as_int(fused[k]) != __float_as_int(old_s[k]);
      ch_w |= __float_as_int(new_w[k]) != __float_as_int(old_w[k]);
      if (new_w[k] > 0.0f) bmin = fminf(bmin, fabsf(fused[k]));
    }
    if (ch_s) store_vals<VPT>(P.tsdf + o, fused);
    if (ch_w) store_vals<VPT>(P.weight + o, new_w);
  }

  // band_min of the row, and the stamp
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    bmin = fminf(bmin, __shfl_xor_sync(kFull, bmin, s));
  if (lane == 0) red_b[parity][warp] = bmin;
  group_sync(g, P.group_threads);
  if (gtid == 0) {
    for (int w = wf; w < wf + warps; ++w) bmin = fminf(bmin, red_b[parity][w]);
    P.band_min[row] = bmin;
    if (P.stamp_on) P.last_seen[row] = stamp;
  }
}

// Row group g of CTA b takes rows b + g gridDim.x, then G gridDim.x on,
// ... below the device count: the rows spread over the CTAs (and so over
// the multiprocessors) evenly, each in flight at once when the grid holds
// them all; a FREE_PTR row is skipped whole.  The first row's ptr and
// block are read before the count; a group that finds no row leaves.
template <int VPT>
__global__ void __launch_bounds__(VPT == 1 ? kMaxVoxels : kCtaThreads7,
                                  VPT == 1 ? 1 : 2)
integrate_rows_kernel(const __grid_constant__ IntegrateParams P) {
  __shared__ int red_v[2][kMaxWarps7], red_u[2][kMaxWarps7];   // by parity
  __shared__ float red_b[2][kMaxWarps7];
  const int g = threadIdx.x / P.group_threads;
  const int gtid = threadIdx.x - g * P.group_threads;
  int r = blockIdx.x + g * gridDim.x;
  int ptr = kFreePtr, bx = 0, by = 0, bz = 0;
  if (r < P.rows) {
    ptr = __ldg(P.ptrs + r);
    bx = __ldg(P.blocks + 3 * r);
    by = __ldg(P.blocks + 3 * r + 1);
    bz = __ldg(P.blocks + 3 * r + 2);
  }
  const int count = min(__ldg(P.count), P.rows);
  if (r >= count) return;
  const int stamp = P.stamp_ptr ? __ldg(P.stamp_ptr) : P.stamp;
  const Pose pose = load_pose(P.T_wc);
  const Local<VPT> L = local_offsets<VPT>(gtid * VPT, P.bs);
  for (int parity = 0; r < count; parity ^= 1) {
    if (ptr != kFreePtr)
      integrate_row<VPT>(P, pose, L, ptr, bx * P.bs, by * P.bs, bz * P.bs,
                         stamp, parity, g, gtid, red_v, red_u, red_b);
    r += gridDim.x * P.groups;
    if (r < count) {
      ptr = __ldg(P.ptrs + r);
      bx = __ldg(P.blocks + 3 * r);
      by = __ldg(P.blocks + 3 * r + 1);
      bz = __ldg(P.blocks + 3 * r + 2);
    }
  }
}

// the instantiations: 4 voxels a thread (16-byte rows) where V is a
// multiple of 4, 1 elsewhere
using IntegrateKernel = void (*)(IntegrateParams);

__host__ __forceinline__ int integrate_vpt(int V) { return V % 4 == 0 ? 4 : 1; }

__host__ __forceinline__ IntegrateKernel integrate_kernel(int V) {
  return integrate_vpt(V) == 4 ? integrate_rows_kernel<4>
                               : integrate_rows_kernel<1>;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns a CUDA error code as an int (0 = launched); an argument the
// kernel does not take returns cudaErrorInvalidValue and launches nothing.

// K6.  The visible entries of the (T,) table at pose T_wc in table order
// into out (16-byte aligned): blocks (A, 3), then ptrs (A,), then the
// count min(visible, A); the rows past the count padded.  scratch: K6's
// persistent scratch (the epoch word, then scratch_words words of
// statuses) as the previous launch left it, or zeroed.  Host tables:
// ints = A, key bits, block size; floats = block_in_frustum's constants
// in CompactParams' order.  The grid is one CTA a tile of kTile (2048)
// entries, at most as many as the card holds at once.

extern "C" int compact_visible(const int* keys, const int* ptrs,
                               const float* T_wc, int* out,
                               unsigned long long* scratch, int scratch_words,
                               int T, const int* ints, const float* floats,
                               void* stream) {
  const int A = ints[0], key_bits = ints[1], block_size = ints[2];
  const int n_tiles = T < 1 ? 0 : (T - 1) / kTile + 1;
  if (T < 1 || A < 0 || A > (INT32_MAX - 1) / 4 || key_bits < 1 ||
      key_bits > 10 || block_size < 1 ||
      n_tiles > scratch_words / kStatusStride ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CompactParams P = {};
  P.keys = keys;
  P.ptrs = ptrs;
  P.T_wc = T_wc;
  P.out = out;
  P.scratch = scratch;
  P.T = T;
  P.A = A;
  P.n_tiles = n_tiles;
  P.key_bits = key_bits;
  P.bs = block_size;
  P.voxel_size = floats[0];
  P.half = floats[1];
  P.fx = floats[2];
  P.fy = floats[3];
  P.cx = floats[4];
  P.cy = floats[5];
  P.width = floats[6];
  P.height = floats[7];
  P.margin = floats[8];
  P.rfx = floats[9];
  P.rfy = floats[10];
  P.znear = floats[11];
  P.zfar = floats[12];
  static int capacity[kMaxDevices] = {};   // co-resident CTAs; 0: not asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (capacity[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, compact_visible_kernel, kThreads6, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    capacity[dev] = per_sm * sms;
  }
  const int ctas = min(P.n_tiles, capacity[dev]);
  P.snap = P.n_tiles <= kSnapTiles && ctas == P.n_tiles;
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  compact_visible_kernel<<<ctas, kThreads6, 0,
                           static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K7.  Fuse depth (H, W) at pose T_wc into the map rows of
// active[:count] (sign +1) or take it out (sign -1), rows born after
// max_born gated out when gate_born; stamp_on: last_seen[ptr] = stamp
// (*stamp_ptr when it is not null).  map: a host table of the map's
// pointers (tsdf, weight, band_min, born, last_seen); ints: a host table
// (map rows, block size, H, W, the window's h and w, window, falloff);
// floats: a host table (voxel size, fx, fy, cx, cy, truncation, its depth
// scale, weight_sample, weight_sample * 1.5, depth_min, 1 / (depth_max -
// depth_min), max_weight, the inverse update's clamp).  rows: the active
// set's padded length (the grid is launched before the count is known).
extern "C" int integrate_rows(const int* blocks, const int* ptrs,
                              const int* count, void* const* map,
                              const float* depth, const float* T_wc,
                              const int* stamp_ptr, int rows, int sign,
                              int gate_born, int max_born, int stamp_on,
                              int stamp, const int* ints, const float* floats,
                              void* stream) {
  const int bs = ints[1], V = bs * bs * bs;
  if (rows < 0 || ints[0] < 1 || bs < 1 || V > kMaxVoxels || ints[2] < 1 ||
      ints[3] < 1 || ints[4] < 1 || ints[5] < 1 || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  IntegrateParams P = {};
  P.blocks = blocks;
  P.ptrs = ptrs;
  P.count = count;
  P.tsdf = static_cast<float*>(map[0]);
  P.weight = static_cast<float*>(map[1]);
  P.band_min = static_cast<float*>(map[2]);
  P.born = static_cast<const int*>(map[3]);
  P.last_seen = static_cast<int*>(map[4]);
  P.depth = depth;
  P.T_wc = T_wc;
  P.stamp_ptr = stamp_ptr;
  P.rows = rows;
  P.n_map_rows = ints[0];
  P.bs = bs;
  P.V = V;
  P.H = ints[2];
  P.W = ints[3];
  P.wh = ints[4];
  P.ww = ints[5];
  P.window = ints[6] != 0;
  P.falloff = ints[7] != 0;
  P.sign = sign;
  P.gate_born = gate_born != 0;
  P.max_born = max_born;
  P.stamp_on = stamp_on != 0;
  P.stamp = stamp;
  P.voxel_size = floats[0];
  P.fx = floats[1];
  P.fy = floats[2];
  P.cx = floats[3];
  P.cy = floats[4];
  P.trunc = floats[5];
  P.trunc_scale = floats[6];
  P.w_sample = floats[7];
  P.w_sample15 = floats[8];
  P.dmin = floats[9];
  P.rdrange = floats[10];
  P.max_weight = floats[11];
  P.tmax = floats[12];
  // row groups of a row each, as many CTAs as the card holds at once, no
  // more than the rows need
  const IntegrateKernel kernel = integrate_kernel(V);
  const int group = threads7(V, integrate_vpt(V));
  const int groups = max(1, min(kMaxGroups7, kCtaThreads7 / group));
  const int threads = groups * group;
  P.groups = groups;
  P.group_threads = group;
  static int capacity[kMaxDevices][kMaxVoxels / 32 + 1][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int& cap = capacity[dev][group / 32][integrate_vpt(V) == 4];
  if (cap == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap = max(per_sm, 1) * sms;
  }
  kernel<<<min((rows + groups - 1) / groups, cap), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K7's instantiation for block size bs on the current device: out[0]
// registers a thread, out[1] local (spilled) bytes a thread, out[2]
// resident CTAs a multiprocessor, out[3] threads a CTA, out[4] shared
// memory bytes a CTA.
extern "C" int integrate_rows_info(int bs, int* out) {
  const int V = bs * bs * bs;
  if (bs < 1 || V > kMaxVoxels) return static_cast<int>(cudaErrorInvalidValue);
  const IntegrateKernel kernel = integrate_kernel(V);
  const int group = threads7(V, integrate_vpt(V));
  const int threads = max(1, min(kMaxGroups7, kCtaThreads7 / group)) * group;
  cudaFuncAttributes fa = {};
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = per_sm;
  out[3] = threads;
  out[4] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
}
