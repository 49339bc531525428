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
// K6.  One cooperative launch.  The table is cut into tiles of kTile
// entries; item k of thread t in a tile is entry k * kThreads + t, so
// every load is coalesced.  Each CTA tests its tile's entries (the keys
// unpacked, the block centre moved into the camera, the z-adaptive pixel
// margin) and writes the tile's visible count; one grid barrier; then each
// CTA sums the counts of the tiles before its own (the tiles are few:
// 128 at the flagship's 262 144 entries) and ranks its tile's entries by
// warp ballots: the exclusive rank of a visible entry is the sum of the
// counts before its tile, of the (item, warp) segments before its own, and
// of the lanes below it in its ballot.  Integers throughout, so the order
// is exact and repeats.  Entries ranked at or past max_active are dropped;
// the grid then writes the pad rows [count, max_active) itself (zero
// blocks, FREE_PTR), so that every row past `count` is padding, as
// touch_active and splat's row skip assume.  A grid of one tile a CTA
// keeps its entries in registers across the barrier; a table of more
// tiles than the card holds CTAs re-tests its tiles after it.  A single
// pass with decoupled look-back would save the barrier (~1 us) but chains
// 128 CTAs through flags in memory; two launches would cost a launch and
// a host-side ordering point.  The barrier is the simplest exact form.
//
// K7.  A grid of resident CTAs (as many as the card holds at once, no more
// than there are rows) strides over the rows below the DEVICE count, K8's
// layout (csrc/splat.cu): a grid of one CTA a row would launch max_active
// CTAs of which most exit.  A CTA of 512 threads takes a row, one voxel a
// thread at block size 8 (two at most), neighbouring threads on
// neighbouring voxels, and per voxel, in the plain version's order:
// projects it (project_rows), in the window mode reduces the row's minimum
// (v, u) over its in-image voxels in the CTA and applies the window's
// coverage (K1, csrc/window_gather.cu: integers, exact), reads the depth,
// applies the update (both signs, the max_born row gate), writes tsdf and
// weight for every voxel of the row, reduces band_min (min |fused| over
// voxels with weight > 0, rewritten for every row, as the plain version
// does) and, with a stamp, writes last_seen.  A FREE_PTR row is skipped
// whole.  Rows are distinct, so no two CTAs touch one map row.
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
// below the launch floor and its one grid barrier (~1 us each).  K7 must
// read each live voxel's tsdf and weight (8 B), write the values the
// update changes, and read the depth pixels that covered voxels reach
// (L2-resident): ~1.8 us at the step's ~770 rows (chip_smoke.py counts
// both from its run's data).  What the pair replaces is ~130 eager
// launches and ~14 host reads a frame.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

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

struct CompactParams {
  const int* keys;         // (T,) packed block keys
  const int* ptrs;         // (T,) map rows; FREE_PTR free
  const float* T_wc;       // (4, 4) row-major camera-to-world
  int* blocks;             // (A, 3) out
  int* out_ptrs;           // (A,) out
  int* count;              // () out: min(visible, A)
  int* tile_counts;        // (n_tiles,) scratch
  int T, A, n_tiles, key_bits, bs;
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
// their visible flags as bits
__device__ __forceinline__ unsigned test_tile(const CompactParams& P,
                                              const Pose& pose, int tile,
                                              int* key, int* ptr) {
  const int base = tile * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k * kThreads6;
    key[k] = i < P.T ? __ldg(P.keys + i) : 0;
    ptr[k] = i < P.T ? __ldg(P.ptrs + i) : kFreePtr;
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (visible(P, pose, key[k], ptr[k])) bits |= 1u << k;
  return bits;
}

// the CTA's sum of x (every thread gets it); red holds kWarps6 ints
__device__ __forceinline__ int cta_sum(int x, int* red) {
  x = __reduce_add_sync(kFull, x);
  __syncthreads();                     // red's previous readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps6; ++w) s += red[w];
  return s;
}

// sum of tile_counts[0, n) over the CTA (written by other CTAs before the
// grid barrier: read through L2)
__device__ __forceinline__ int counts_before(const CompactParams& P, int n,
                                             int* red) {
  int s = 0;
  for (int j = threadIdx.x; j < n; j += kThreads6) s += __ldcg(P.tile_counts + j);
  return cta_sum(s, red);
}

__global__ void __launch_bounds__(kThreads6)
compact_visible_kernel(const __grid_constant__ CompactParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int red[kWarps6];
  __shared__ int seg[kSegments];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Pose pose = load_pose(P.T_wc);
  const bool keep = P.n_tiles <= static_cast<int>(gridDim.x);
  int key[kItems], ptr[kItems];
  unsigned bits = 0;

  // 1. each tile's visible count
  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    bits = test_tile(P, pose, tile, key, ptr);
    const int n = cta_sum(__popc(bits), red);
    if (tid == 0) P.tile_counts[tile] = n;
  }
  grid.sync();

  // 2. rank and write: the tiles before, the segments before, the lanes below
  const int count = min(counts_before(P, P.n_tiles, red), P.A);
  const unsigned below = (1u << lane) - 1u;
  for (int tile = blockIdx.x; tile < P.n_tiles; tile += gridDim.x) {
    if (!keep) bits = test_tile(P, pose, tile, key, ptr);
    const int base = counts_before(P, tile, red);
    unsigned ballot[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      ballot[k] = __ballot_sync(kFull, (bits >> k) & 1u);
      if (lane == 0) seg[k * kWarps6 + warp] = __popc(ballot[k]);
    }
    __syncthreads();
    if (warp == 0) {                   // exclusive scan of the 64 segments
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
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!((bits >> k) & 1u)) continue;
      const int pos = base + seg[k * kWarps6 + warp] + __popc(ballot[k] & below);
      if (pos >= P.A) continue;
      const int mask = (1 << P.key_bits) - 1, bias = 1 << (P.key_bits - 1);
      P.blocks[3 * pos] = ((key[k] >> (2 * P.key_bits)) & mask) - bias;
      P.blocks[3 * pos + 1] = ((key[k] >> P.key_bits) & mask) - bias;
      P.blocks[3 * pos + 2] = (key[k] & mask) - bias;
      P.out_ptrs[pos] = ptr[k];
    }
    __syncthreads();                   // seg is rewritten by the next tile
  }

  // 3. the pad rows [count, A) and the count
  for (int r = count + blockIdx.x * kThreads6 + tid; r < P.A;
       r += gridDim.x * kThreads6) {
    P.blocks[3 * r] = 0;
    P.blocks[3 * r + 1] = 0;
    P.blocks[3 * r + 2] = 0;
    P.out_ptrs[r] = kFreePtr;
  }
  if (blockIdx.x == 0 && tid == 0) *P.count = count;
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

constexpr int kThreads7 = 512;
constexpr int kWarps7 = kThreads7 / 32;
constexpr int kPerThread = 2;                      // voxels a thread at most
constexpr int kMaxVoxels = kThreads7 * kPerThread;

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
  int rows, n_map_rows, bs, V, H, W, wh, ww;
  int window;              // the window gather's coverage (K1's mode)
  int sign;                // +1 integrate, -1 de-integrate
  int gate_born, max_born; // rows with born > max_born take no sample
  int stamp_on, stamp;     // last_seen[ptr] = stamp
  const int* stamp_ptr;    // () the stamp on the device, or null: `stamp`
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

__global__ void __launch_bounds__(kThreads7)
integrate_rows_kernel(const __grid_constant__ IntegrateParams P) {
  __shared__ int red_v[2][kWarps7], red_u[2][kWarps7];   // by row parity
  __shared__ float red_b[2][kWarps7];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int count = min(__ldg(P.count), P.rows);
  const int stamp = P.stamp_ptr ? __ldg(P.stamp_ptr) : P.stamp;
  const Pose pose = load_pose(P.T_wc);
  const float fW1 = static_cast<float>(P.W - 1), fH1 = static_cast<float>(P.H - 1);
  int parity = 0;
  for (int r = blockIdx.x; r < count; r += gridDim.x, parity ^= 1) {
    const int ptr = __ldg(P.ptrs + r);
    if (ptr == kFreePtr) continue;
    const int row = min(max(ptr, 0), P.n_map_rows - 1);
    const bool born_ok = !P.gate_born || __ldg(P.born + row) <= P.max_born;
    const int* b = P.blocks + 3 * r;
    const int bx = __ldg(b) * P.bs, by = __ldg(b + 1) * P.bs,
              bz = __ldg(b + 2) * P.bs;

    // project_rows: the voxel's camera depth and clamped pixel
    float z[kPerThread];
    int vi[kPerThread], ui[kPerThread];
    bool in_img[kPerThread];
    int mv = P.H, mu = P.W;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid + k * kThreads7;
      in_img[k] = false;
      vi[k] = 0;
      ui[k] = 0;
      z[k] = 0.0f;
      if (i >= P.V) continue;
      const int lx = i % P.bs, ly = (i / P.bs) % P.bs, lz = i / (P.bs * P.bs);
      const float w0 = mul(static_cast<float>(bx + lx), P.voxel_size);
      const float w1 = mul(static_cast<float>(by + ly), P.voxel_size);
      const float w2 = mul(static_cast<float>(bz + lz), P.voxel_size);
      const float x = to_camera(pose, 0, w0, w1, w2);
      const float y = to_camera(pose, 1, w0, w1, w2);
      const float zz = to_camera(pose, 2, w0, w1, w2);
      // camera.project_nearest
      const float safe_z = fabsf(zz) > 1e-12f ? zz : 1e-12f;
      const float u = add(mul(dvd(x, safe_z), P.fx), P.cx);
      const float v = add(mul(dvd(y, safe_z), P.fy), P.cy);
      const int iu = static_cast<int>(rintf(u)), iv = static_cast<int>(rintf(v));
      in_img[k] = zz > 0.0f && u >= 0.0f && u <= fW1 && v >= 0.0f && v <= fH1 &&
                  iu >= 0 && iu < P.W && iv >= 0 && iv < P.H;
      ui[k] = min(max(iu, 0), P.W - 1);
      vi[k] = min(max(iv, 0), P.H - 1);
      z[k] = zz;
      if (in_img[k]) {
        mv = min(mv, vi[k]);
        mu = min(mu, ui[k]);
      }
    }

    // K1's window: the row's minimum (v, u) over its in-image voxels,
    // clamped, then coverage replaces the in-image flag
    if (P.window) {
      mv = __reduce_min_sync(kFull, mv);
      mu = __reduce_min_sync(kFull, mu);
      if (lane == 0) {
        red_v[parity][warp] = mv;
        red_u[parity][warp] = mu;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps7; ++w) {
        mv = min(mv, red_v[parity][w]);
        mu = min(mu, red_u[parity][w]);
      }
      const int v0 = min(max(mv, 0), max(P.H - P.wh, 0));
      const int u0 = min(max(mu, 0), max(P.W - P.ww, 0));
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int dv = vi[k] - v0, du = ui[k] - u0;
        in_img[k] = in_img[k] && dv >= 0 && dv < P.wh && du >= 0 && du < P.ww;
      }
    }

    // the gather and the update
    float bmin = INFINITY;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid + k * kThreads7;
      if (i >= P.V) continue;
      // a voxel outside the image (or window) takes no sample, whatever
      // its depth: the read is skipped
      const float d = in_img[k] ? __ldg(P.depth + vi[k] * P.W + ui[k]) : 0.0f;
      const float sdf = sub(d, z[k]);
      const float trunc = add(mul(d, P.trunc_scale), P.trunc);
      const bool valid = in_img[k] && born_ok && d > 0.0f && z[k] > 0.0f &&
                         sdf > -trunc;
      const float s = fminf(fmaxf(sdf, -trunc), trunc);
      const float w_new = valid ? sample_weight(P, d) : 0.0f;
      const int64_t o = static_cast<int64_t>(row) * P.V + i;
      const float old_sdf = P.tsdf[o], old_w = P.weight[o];
      float fused, new_w;
      if (P.sign > 0) {
        const float w_sum = add(old_w, w_new);
        fused = w_new > 0.0f
            ? dvd(add(mul(old_sdf, old_w), mul(s, w_new)), clamp_min(w_sum, 1e-12f))
            : old_sdf;
        new_w = w_new > 0.0f ? clamp(w_sum, -INFINITY, P.max_weight) : old_w;
      } else {
        const float w_rem = clamp_min(sub(old_w, w_new), 0.0f);
        fused = w_new > 0.0f
            ? (w_rem > 1e-6f ? dvd(sub(mul(old_sdf, old_w), mul(s, w_new)),
                                   clamp_min(w_rem, 1e-12f))
                             : 0.0f)
            : old_sdf;
        new_w = w_new > 0.0f ? w_rem : old_w;
        fused = clamp(fused, -P.tmax, P.tmax);
      }
      P.tsdf[o] = fused;
      P.weight[o] = new_w;
      if (new_w > 0.0f) bmin = fminf(bmin, fabsf(fused));
    }

    // band_min of the row, and the stamp
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      bmin = fminf(bmin, __shfl_xor_sync(kFull, bmin, d));
    if (lane == 0) red_b[parity][warp] = bmin;
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int w = 0; w < kWarps7; ++w) bmin = fminf(bmin, red_b[parity][w]);
      P.band_min[row] = bmin;
      if (P.stamp_on) P.last_seen[row] = stamp;
    }
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns a CUDA error code as an int (0 = launched); an argument the
// kernel does not take returns cudaErrorInvalidValue and launches nothing.

// K6.  The visible entries of the (T,) table at pose T_wc in table order
// into blocks (A, 3) and out_ptrs (A,), the rows past the count padded,
// count = min(visible, A); scratch: one int a tile of kTile (2048)
// entries.  One cooperative launch, refused
// (cudaErrorCooperativeLaunchTooLarge) when its grid cannot be co-resident.

extern "C" int compact_visible(const int* keys, const int* ptrs,
                               const float* T_wc, int* blocks, int* out_ptrs,
                               int* count, int* scratch, int T, int A,
                               int key_bits, int block_size, float voxel_size,
                               float half, float fx, float fy, float cx,
                               float cy, float width, float height,
                               float margin, float rfx, float rfy,
                               float znear, float zfar, void* stream) {
  if (T < 1 || A < 0 || key_bits < 1 || key_bits > 10 || block_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CompactParams P = {};
  P.keys = keys;
  P.ptrs = ptrs;
  P.T_wc = T_wc;
  P.blocks = blocks;
  P.out_ptrs = out_ptrs;
  P.count = count;
  P.tile_counts = scratch;
  P.T = T;
  P.A = A;
  P.n_tiles = (T + kTile - 1) / kTile;
  P.key_bits = key_bits;
  P.bs = block_size;
  P.voxel_size = voxel_size;
  P.half = half;
  P.fx = fx;
  P.fy = fy;
  P.cx = cx;
  P.cy = cy;
  P.width = width;
  P.height = height;
  P.margin = margin;
  P.rfx = rfx;
  P.rfy = rfy;
  P.znear = znear;
  P.zfar = zfar;
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
  if (ctas < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kThreads6);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, compact_visible_kernel, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K7.  Fuse depth (H, W) at pose T_wc into the map rows of
// active[:count] (sign +1) or take it out (sign -1), rows born after
// max_born gated out when gate_born; window: K1's coverage rule with a
// (wh, ww) window; stamp_on: last_seen[ptr] = stamp (*stamp_ptr when it is
// not null).  rows: the active
// set's padded length (the grid is launched before the count is known).
extern "C" int integrate_rows(
    const int* blocks, const int* ptrs, const int* count, float* tsdf,
    float* weight, float* band_min, const int* born, int* last_seen,
    const float* depth, const float* T_wc, int rows, int n_map_rows,
    int block_size, int H, int W, int wh, int ww, int window, int sign,
    int gate_born, int max_born, int stamp_on, int stamp,
    const int* stamp_ptr, int falloff,
    float voxel_size, float fx, float fy, float cx, float cy, float trunc,
    float trunc_scale, float w_sample, float w_sample15, float dmin,
    float rdrange, float max_weight, float tmax, void* stream) {
  const int V = block_size * block_size * block_size;
  if (rows < 0 || n_map_rows < 1 || block_size < 1 || V > kMaxVoxels ||
      H < 1 || W < 1 || wh < 1 || ww < 1 || (sign != 1 && sign != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  IntegrateParams P = {};
  P.blocks = blocks;
  P.ptrs = ptrs;
  P.count = count;
  P.tsdf = tsdf;
  P.weight = weight;
  P.band_min = band_min;
  P.born = born;
  P.last_seen = last_seen;
  P.depth = depth;
  P.T_wc = T_wc;
  P.rows = rows;
  P.n_map_rows = n_map_rows;
  P.bs = block_size;
  P.V = V;
  P.H = H;
  P.W = W;
  P.wh = wh;
  P.ww = ww;
  P.window = window != 0;
  P.sign = sign;
  P.gate_born = gate_born != 0;
  P.max_born = max_born;
  P.stamp_on = stamp_on != 0;
  P.stamp = stamp;
  P.stamp_ptr = stamp_ptr;
  P.falloff = falloff != 0;
  P.voxel_size = voxel_size;
  P.fx = fx;
  P.fy = fy;
  P.cx = cx;
  P.cy = cy;
  P.trunc = trunc;
  P.trunc_scale = trunc_scale;
  P.w_sample = w_sample;
  P.w_sample15 = w_sample15;
  P.dmin = dmin;
  P.rdrange = rdrange;
  P.max_weight = max_weight;
  P.tmax = tmax;
  // as many CTAs as the card holds at once, no more than there are rows
  static int capacity[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (capacity[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, integrate_rows_kernel, kThreads7, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    capacity[dev] = max(per_sm, 1) * sms;
  }
  integrate_rows_kernel<<<min(rows, capacity[dev]), kThreads7, 0,
                          static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
