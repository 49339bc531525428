// The splat surface prediction for Hopper (sm_90a), two kernels:
//
//   splat_zbuffer (K8): the scatter-min z-buffer over the visible set.
//     Replaces what XLA fused on the TPU in voxelhashing_demo_tpu/ops/
//     splat.py: surface_filter (:252), splat_depth_from_map (:141),
//     splat_depth_estimates (:84) and _splat_rows_into (:187), as
//     splat_raycast (:279) calls them.
//   splat_finalize (K9): the raw depth buffer to the model's depth, points,
//     normals and hit mask.  Replaces finalize_depth (:229) of the same
//     file: _min_fill (:48), _edge_preserving_smooth (:66),
//     camera.pixel_rays and preprocess.compute_normals
//     (voxelhashing_demo_tpu/ops/preprocess.py:50).
//
// No Pallas kernel; no PyTorch call computes either.
//
// K8.  A CTA takes a row of the active set at a time, its 256 threads a
// voxel each in turn (two at block size 8), the reference's layout; a
// grid of eight CTAs a multiprocessor, all resident, strides over the
// rows, since the row count stays on the device (a grid of one CTA a row,
// 4 096 at the flagship's max_active, spent 3.6 us launching CTAs that
// exit; two CTAs a multiprocessor walked ~3 rows each one after another).  Rows at or past `count` are
// never read; a row whose ptr is FREE_PTR and, with the band filter on, a
// row whose band_min is not below the band is skipped whole.  That skip is
// surface_filter: a filtered row holds no voxel with weight > 0 and |sdf|
// < band, so it adds no update (JAX splat.py:252-262), and no row is
// compacted or counted on the host.  A
// voxel's surface depth z + sdf goes into the buffer by atomicMin on the
// float's int32 bits: exact, since z + sdf > near >= 0 and +inf, the
// buffer's reset value, orders above every finite positive float.  A voxel
// that fails a gate writes nothing, so the buffer has no drop slot.
//
// K9.  A CTA of 512 threads stages 64 columns by 16 + 2R rows of the raw
// depth in shared memory, R = fill_rounds + 2, and writes the tile of
// 64 - 2R columns (down to a multiple of 4) by 16 rows inside them; the
// stages run there one after another, a __syncthreads between two:
//   1. the raw buffer (not finite -> 0: "no estimate");
//   2. each round of the 3 x 3 valid-min hole fill, over the whole staged
//      region: a cell within `round` of its edge reads the padding, is
//      wrong and is never read by an output (the halo is the rounds plus
//      the smooth and the normals' reach);
//   3. the edge-preserving smooth, over the tile and a halo of 1;
//   4. points, normals, depth and hit of each pixel of the tile, into a
//      staging area laid out as the outputs lie in memory;
//   5. the staged outputs to memory, each warp's stores on neighbouring
//      addresses: 16 bytes a thread where the width is a multiple of 4,
//      4 or 1 elsewhere.  (Each thread writing its own pixels' 12-byte
//      points and normals, as 16-byte stores 48 bytes apart or 4-byte
//      stores 12 bytes apart, took the card's write rate down to
//      ~1.4 TB/s: chip_splat_breakdown.py's design trees, PERF.md.)
// In stages 1-3 a thread owns one column of a strip of rows (64 columns x
// 8 strips): it reads the strip's rows and the two beside it into
// registers once, then writes its outputs, so a stencil reads three
// shared values a cell, not nine, and every read is in flight at once.
// The fill is a minimum, so it is taken as the rows' 3-wide minima, each
// once, then their minimum over three rows, with holes held as +inf
// (exact: a min in any order).  The border is
// where the two stencils differ.  The smooth reads the filled depth of the
// wrapped pixel (torch.roll), but the fill does not wrap: reduce_window's
// SAME padding (max_pool2d's) puts +inf outside the image.  So every
// staged cell holds the wrapped pixel, and a fill reads a neighbour only
// if it lies inside the image in the cell's own, wrapped, coordinates;
// the cell beside it may lie across the border and is never read then.
// Each stage computed at a halo cell therefore equals the stage at the
// wrapped pixel.  The normals need no wrap: compute_normals' interior mask
// zeroes the border rows and columns.  A tile whose staged region lies
// inside the image, one pixel in from each edge, takes an instantiation
// without the wrap and the in-image tests (at 640 x 480, 280 of 360
// tiles).  One instantiation a fill-round count up to 3, then one that
// reads the count at run time: every count 0..16 is taken.
//
// Rounding: every product, sum and quotient of the plain PyTorch version
// (ops/splat.py) on the card is written with the round-to-nearest
// intrinsics, in its order, so nvcc contracts nothing the plain version
// rounds: voxel2world's vox * voxel_size; the (N, 3) @ (3, 3) product and
// se3.inverse's einsum as the library's kernels sum them (dot_mm, dot_inv,
// measured on an H100 with torch 2.11 / CUDA 12.8 by chip_rounding_probe.py,
// bit for bit over 2^20 rows and 512 poses), then + t; z + sdf;
// x / z * fx + cx; the smooth's acc + n and cnt + ok in (dy, dx) order,
// then acc / max(cnt, 1); points ((u - cx) * (1 / fx)) * d; the normals as
// torch.linalg.cross and the size-3 sum round on the card (csrc/
// preprocess.cu, K3a).  torch.round is rintf (half to even).  So both
// kernels equal their plain versions on the card bit for bit; on the CPU
// the plain version rounds as the CPU does.
//
// Bound: bytes, far below the launches they replace.  At 640 x 480 with
// ~930 visible rows, K8 reads each live row's tsdf and weight (4 KB) and
// the active set's ptrs and band_min (~4 MB) and scatters into the 1.2 MB
// buffer: ~1.5 us at 3.35 TB/s.  K9 reads the 1.2 MB buffer and writes
// depth, points, normals and hit (~9.5 MB): ~3 us; its arithmetic, the
// smooth's nine taps and the normal's cross product, square root and
// three divides a pixel, takes about as long at the card's issue rate.  What the pair
// replaces is ~200 eager launches and 5 host reads a frame: the design is
// one launch each and no host read, every intermediate in shared memory
// or registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// i modulo n, for i within a halo of the image: a compare and an add (the
// modulo only when the halo is wider than the image)
__device__ __forceinline__ int wrap(int i, int n) {
  if (i < 0) i += n;
  else if (i >= n) i -= n;
  if (i < 0 || i >= n) i = (i % n + n) % n;
  return i;
}

// a0 b0 + a1 b1 + a2 b2 as the card's (N, 3) @ (3, 3) matmul sums it
__device__ __forceinline__ float dot_mm(float a0, float b0, float a1, float b1,
                                        float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}

// a0 b0 + a1 b1 + a2 b2 as se3.inverse's einsum("ij,j->i") sums it on the
// card (it runs as a matrix-vector product: the second product fused, the
// third rounded and added)
__device__ __forceinline__ float dot_inv(float a0, float b0, float a1,
                                         float b1, float a2, float b2) {
  return add(__fmaf_rn(a1, b1, mul(a0, b0)), mul(a2, b2));
}

// x0 + x1 + x2 as torch.sum adds a last axis of three on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(x0, x2), x1);
}

// a_i b_j - a_j b_i as torch.linalg.cross computes it on the card
__device__ __forceinline__ float cross1(float ai, float bj, float aj, float bi) {
  return __fmaf_rn(ai, bj, -mul(aj, bi));
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int kFreePtr = -1;
constexpr int kMaxVoxels = 1024;     // voxels a block
constexpr int kZThreads = 256;       // K8's CTA: a thread every 256 voxels
constexpr int kCtasPerSm = 8;        // K8's grid: CTAs a multiprocessor
constexpr int kMaxDevices = 64;

struct ZbufferParams {
  const int* blocks;       // (A, 3) block coords
  const int* ptrs;         // (A,) map rows; FREE_PTR pad
  const int* count;        // () rows in use (device)
  const float* tsdf;       // (N, V)
  const float* weight;     // (N, V)
  const float* band_min;   // (N,)
  const float* T_wc;       // (4, 4) row-major camera-to-world
  float* zbuf;             // (H * W), +inf where nothing landed
  int rows, n_map_rows, bs, V, H, W, filter;
  float voxel_size, fx, fy, cx, cy, znear, zfar, band;
};

// one voxel's surface depth into the z-buffer, if it passes every gate
__device__ __forceinline__ void splat_voxel(const ZbufferParams& P, int r,
                                            int row, int i) {
  const int64_t o = static_cast<int64_t>(row) * P.V + i;
  const float w = __ldg(P.weight + o);
  const float sdf = __ldg(P.tsdf + o);
  if (!(w > 0.0f) || !(fabsf(sdf) < P.band)) return;

  // T_cw = se3.inverse(T_wc): R^T and -(R^T t)
  const float* T = P.T_wc;
  float R[3][3], t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[k][j] = __ldg(T + 4 * k + j);
    t[k] = __ldg(T + 4 * k + 3);
  }
  // the voxel's world position: voxel2world(block2voxel(block) + local)
  const int lx = i % P.bs, ly = (i / P.bs) % P.bs, lz = i / (P.bs * P.bs);
  const int* b = P.blocks + 3 * r;
  const float w0 = mul(static_cast<float>(__ldg(b) * P.bs + lx), P.voxel_size);
  const float w1 = mul(static_cast<float>(__ldg(b + 1) * P.bs + ly),
                       P.voxel_size);
  const float w2 = mul(static_cast<float>(__ldg(b + 2) * P.bs + lz),
                       P.voxel_size);
  // pc = world @ R_cw^T + t_cw, R_cw^T = R
  float pc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float tcw = -dot_inv(R[0][j], t[0], R[1][j], t[1], R[2][j], t[2]);
    pc[j] = add(dot_mm(w0, R[0][j], w1, R[1][j], w2, R[2][j]), tcw);
  }
  const float z = pc[2];
  if (!(z > P.znear && z < P.zfar)) return;
  const float z_surf = add(z, sdf);
  if (!(z_surf > P.znear && z_surf < P.zfar)) return;
  // camera.project_nearest
  const float safe_z = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float u = add(mul(dvd(pc[0], safe_z), P.fx), P.cx);
  const float v = add(mul(dvd(pc[1], safe_z), P.fy), P.cy);
  if (!(z > 0.0f && u >= 0.0f && u <= static_cast<float>(P.W - 1) &&
        v >= 0.0f && v <= static_cast<float>(P.H - 1)))
    return;
  const int iu = static_cast<int>(rintf(u)), iv = static_cast<int>(rintf(v));
  if (iu < 0 || iu >= P.W || iv < 0 || iv >= P.H) return;
  atomicMin(reinterpret_cast<int*>(P.zbuf) + iv * P.W + iu,
            __float_as_int(z_surf));
}

// CTA b takes rows b, b + gridDim.x, ... below the device count; a row
// whose ptr is FREE_PTR or (filter) whose band_min is not below the band
// adds nothing and is skipped whole
__global__ void __launch_bounds__(kZThreads)
splat_zbuffer_kernel(const __grid_constant__ ZbufferParams P) {
  const int count = min(__ldg(P.count), P.rows);
  for (int r = blockIdx.x; r < count; r += gridDim.x) {
    const int ptr = __ldg(P.ptrs + r);
    if (ptr == kFreePtr) continue;
    const int row = min(max(ptr, 0), P.n_map_rows - 1);
    if (P.filter && !(__ldg(P.band_min + row) < P.band)) continue;
    for (int i = threadIdx.x; i < P.V; i += kZThreads)
      splat_voxel(P, r, row, i);
  }
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

constexpr int kCols = 64;                 // staged columns a CTA: two warps
constexpr int kStrips = 8;                // row strips: 64 columns x 8 strips
constexpr int kThreads = kCols * kStrips;
constexpr int kTileH = 16;                // output rows a tile
constexpr int kPitch = kCols + 2;         // a padding column on each side
constexpr int kMaxFillRounds = 16;
constexpr int kGeneric = -1;              // ROUNDS that reads the rounds at run time
constexpr int kSpan = 64;                 // stage 5: threads a row (>= 3 TW / 4)

// output columns a tile for halo R: what the 64 staged columns leave, a
// multiple of 4 (a thread of the epilogue owns 4 neighbouring pixels)
__host__ __device__ constexpr int tile_w(int R) { return (kCols - 2 * R) & ~3; }

struct FinalizeParams {
  const float* raw;        // (H, W) raw depth: not finite or 0 = none
  float* depth;            // (H, W)
  float* points;           // (H, W, 3)
  float* normals;          // (H, W, 3)
  uint8_t* hit;            // (H, W) bool
  int H, W, rounds;
  float sigma, cx, cy, rfx, rfy;
};

// the staged cell (row, col), row -1..SH and col -1..kCols (padding)
__device__ __forceinline__ int cell(int row, int col) {
  return (row + 1) * kPitch + col + 1;
}

// rows a strip takes of a staged region of n rows
__host__ __device__ constexpr int strip_rows(int n) {
  return (n + kStrips - 1) / kStrips;
}

// the halo and the strips' register arrays of an instantiation: the
// generic one sizes them for the most fill rounds
template <int ROUNDS>
struct Shape {
  static constexpr int kR = (ROUNDS == kGeneric ? kMaxFillRounds : ROUNDS) + 2;
  static constexpr int kStrip = strip_rows(kTileH + 2 * kR);     // stages 1-2
  static constexpr int kSmooth = strip_rows(kTileH + 2);         // stage 3
};

// the fill's 3-wide minimum of one staged row at column c (holes hold
// +inf), the columns outside the image left out (BORDER); and the centre
__device__ __forceinline__ float hmin(const float* a, int row, int c,
                                      bool left, bool right, float* centre) {
  const float m = a[cell(row, c)];
  float h = m;
  if (left) h = fminf(h, a[cell(row, c - 1)]);
  if (right) h = fminf(h, a[cell(row, c + 1)]);
  *centre = m;
  return h;
}

// one smooth tap: n counts when it is an estimate within sigma of d
template <bool ZERO_HOLES>
__device__ __forceinline__ void tap(float n, float d, float sigma, float& acc,
                                    float& cnt) {
  const bool ok = (!ZERO_HOLES || n > 0.0f) && fabsf(sub(n, d)) < sigma;
  if (ok) {
    acc = add(acc, n);
    cnt = add(cnt, 1.0f);
  }
}

struct Row3 {
  float l, c, r;
};

__device__ __forceinline__ Row3 row3(const float* a, int row, int c) {
  return {a[cell(row, c - 1)], a[cell(row, c)], a[cell(row, c + 1)]};
}

// _edge_preserving_smooth at one cell from its 3 x 3 neighbourhood: tap
// (dy, dx) reads the pixel that torch.roll(depth, (dy, dx)) brings here,
// depth[y - dy, x - dx], in the plain order.  After a fill round a hole
// is +inf, which no tap takes (|inf - d| is not below sigma), and becomes
// 0 again; without one, holes are 0 or below and the taps test n > 0
__device__ __forceinline__ float smooth_at(const Row3& up, const Row3& mid,
                                           const Row3& dn, float sigma,
                                           bool filled) {
  const float d = mid.c;
  if (!(filled ? d < INFINITY : d > 0.0f)) return filled ? 0.0f : d;
  float acc = 0.0f, cnt = 0.0f;
  if (filled) {
    tap<false>(dn.r, d, sigma, acc, cnt);
    tap<false>(dn.c, d, sigma, acc, cnt);
    tap<false>(dn.l, d, sigma, acc, cnt);
    tap<false>(mid.r, d, sigma, acc, cnt);
    tap<false>(mid.c, d, sigma, acc, cnt);
    tap<false>(mid.l, d, sigma, acc, cnt);
    tap<false>(up.r, d, sigma, acc, cnt);
    tap<false>(up.c, d, sigma, acc, cnt);
    tap<false>(up.l, d, sigma, acc, cnt);
  } else {
    tap<true>(dn.r, d, sigma, acc, cnt);
    tap<true>(dn.c, d, sigma, acc, cnt);
    tap<true>(dn.l, d, sigma, acc, cnt);
    tap<true>(mid.r, d, sigma, acc, cnt);
    tap<true>(mid.c, d, sigma, acc, cnt);
    tap<true>(mid.l, d, sigma, acc, cnt);
    tap<true>(up.r, d, sigma, acc, cnt);
    tap<true>(up.c, d, sigma, acc, cnt);
    tap<true>(up.l, d, sigma, acc, cnt);
  }
  return cnt > 0.0f ? dvd(acc, fmaxf(cnt, 1.0f)) : d;
}

// the staging area of a tile's outputs, laid out as they lie in memory:
// points and normals (kTileH rows of 3 TW floats), depth (kTileH x TW) and
// hit (kTileH x TW bytes)
__host__ __device__ constexpr int staged_floats(int TW) {
  return 7 * kTileH * TW + kTileH * TW / 4;
}

// A tile: stage, fill, smooth, outputs (see the notes at the top).
// BORDER: the staged region reaches past the image's first or last row or
// column (wrapped reads, the fill's in-image tests); otherwise neither is
// needed.
template <int ROUNDS, bool BORDER>
__device__ __forceinline__ void finalize_tile(const FinalizeParams& P,
                                              float* smem, int rounds) {
  using S = Shape<ROUNDS>;
  const int R = rounds + 2;
  const int TW = tile_w(R), SH = kTileH + 2 * R;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * kTileH;
  const int x0 = tx0 - R, y0 = ty0 - R;       // pixel of staged (0, 0)
  const int H = P.H, W = P.W;
  const int tid = threadIdx.x, c = tid % kCols, s = tid / kCols;
  const int size = kPitch * (SH + 2);
  float* a = smem;
  float* b = smem + size;
  float* pts = smem + 2 * size;
  float* nrm = pts + 3 * kTileH * TW;
  float* dep = nrm + 3 * kTileH * TW;
  uint8_t* hits = reinterpret_cast<uint8_t*>(dep + kTileH * TW);

  // 1. the raw buffer, halo R: thread (c, s) a column of strip s, every
  // load in flight at once; holes as +inf for the fill (0 without a fill
  // round: the smooth and the normals read the buffer as it is then)
  const int r0 = s * strip_rows(SH), r1 = min(r0 + strip_rows(SH), SH);
  const int gx = BORDER ? wrap(x0 + c, W) : x0 + c;
#pragma unroll
  for (int j = 0; j < S::kStrip; ++j) {
    const int row = r0 + j;
    if (row < r1) {
      const int gy = BORDER ? wrap(y0 + row, H) : y0 + row;
      const float d = __ldg(P.raw + gy * W + gx);
      const float v = isfinite(d) ? d : 0.0f;
      a[cell(row, c)] = rounds == 0 ? v : (v > 0.0f ? v : INFINITY);
    }
  }
  __syncthreads();

  // 2. _min_fill, each round over the whole staged region (a cell within
  // `round` of its edge reads the padding and is never used): a hole
  // takes the minimum of the estimates among its 3 x 3 neighbours inside
  // the image in its own (wrapped) coordinates, as the rows' 3-wide
  // minima, each computed once, then their minimum over 3 rows.  A strip's
  // rows r0 - 1 .. r1 are read into registers first, then its outputs
  // written
  const bool left = !BORDER || gx > 0, right = !BORDER || gx < W - 1;
  for (int round = 0; round < rounds; ++round) {
    float h[S::kStrip + 2], centre[S::kStrip + 2];
#pragma unroll
    for (int j = 0; j < S::kStrip + 2; ++j)
      if (r0 - 1 + j <= r1) h[j] = hmin(a, r0 - 1 + j, c, left, right, &centre[j]);
#pragma unroll
    for (int j = 0; j < S::kStrip; ++j) {
      const int row = r0 + j;
      if (row < r1) {
        float m = h[j + 1];
        if (BORDER) {
          const int gy = wrap(y0 + row, H);
          if (gy > 0) m = fminf(m, h[j]);
          if (gy < H - 1) m = fminf(m, h[j + 2]);
        } else {
          m = fminf(fminf(m, h[j]), h[j + 2]);
        }
        b[cell(row, c)] = centre[j + 1] < INFINITY ? centre[j + 1] : m;
      }
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }

  // 3. the smooth over rows R - 1 .. R + kTileH (halo 1), every column
  {
    const int q0 = R - 1 + s * S::kSmooth;
    const int q1 = min(q0 + S::kSmooth, R + kTileH + 1);
    Row3 rows[S::kSmooth + 2];
#pragma unroll
    for (int j = 0; j < S::kSmooth + 2; ++j)
      if (q0 - 1 + j <= q1) rows[j] = row3(a, q0 - 1 + j, c);
#pragma unroll
    for (int j = 0; j < S::kSmooth; ++j)
      if (q0 + j < q1)
        b[cell(q0 + j, c)] = smooth_at(rows[j], rows[j + 1], rows[j + 2],
                                       P.sigma, rounds > 0);
  }
  __syncthreads();

  // 4. depth, points, normals and hit a pixel into the staging area
  for (int p = tid; p < kTileH * TW; p += kThreads) {
    const int ty = p / TW, tx = p - ty * TW;
    const int v = ty0 + ty, u = tx0 + tx;
    if (v >= H || u >= W) continue;
    const int sr = R + ty, sc = R + tx;
    const float d = b[cell(sr, sc)];
    const float du = b[cell(sr - 1, sc)], dd = b[cell(sr + 1, sc)];
    const float dl = b[cell(sr, sc - 1)], dr = b[cell(sr, sc + 1)];
    // (u - cx) * (1 / fx) of a column: a ray's first factor
    const float cf = mul(sub(static_cast<float>(u), P.cx), P.rfx);
    const float rf = mul(sub(static_cast<float>(v), P.cy), P.rfy);
    const bool ok = (!BORDER || (v > 0 && v < H - 1 && u > 0 && u < W - 1)) &&
                    d != 0.0f && du != 0.0f && dd != 0.0f && dl != 0.0f &&
                    dr != 0.0f;
    // compute_normals: cross(down - up, right - left), normalised
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (ok) {
      const float cfl = mul(sub(static_cast<float>(u - 1), P.cx), P.rfx);
      const float cfr = mul(sub(static_cast<float>(u + 1), P.cx), P.rfx);
      const float rfu = mul(sub(static_cast<float>(v - 1), P.cy), P.rfy);
      const float rfd = mul(sub(static_cast<float>(v + 1), P.cy), P.rfy);
      const float ax = sub(mul(cf, dd), mul(cf, du));
      const float ay = sub(mul(rfd, dd), mul(rfu, du));
      const float az = sub(dd, du);
      const float bx = sub(mul(cfr, dr), mul(cfl, dl));
      const float by = sub(mul(rf, dr), mul(rf, dl));
      const float bz = sub(dr, dl);
      const float cx_ = cross1(ay, bz, az, by);
      const float cy_ = cross1(az, bx, ax, bz);
      const float cz_ = cross1(ax, by, ay, bx);
      const float len = __fsqrt_rn(sum3(mul(cx_, cx_), mul(cy_, cy_),
                                        mul(cz_, cz_)));
      if (len > 1e-12f) {
        const float l = fmaxf(len, 1e-12f);
        nx = dvd(cx_, l);
        ny = dvd(cy_, l);
        nz = dvd(cz_, l);
      }
    }
    const bool hit = d > 0.0f;
    float* pp = pts + ty * 3 * TW + 3 * tx;
    float* pn = nrm + ty * 3 * TW + 3 * tx;
    pp[0] = hit ? mul(cf, d) : 0.0f;
    pp[1] = hit ? mul(rf, d) : 0.0f;
    pp[2] = hit ? d : 0.0f;
    pn[0] = nx;
    pn[1] = ny;
    pn[2] = nz;
    dep[ty * TW + tx] = d;
    hits[ty * TW + tx] = hit ? 1 : 0;
  }
  __syncthreads();

  // 5. the staged outputs to memory, each warp on neighbouring addresses:
  // 16-byte stores where the width is a multiple of 4 (every staged row
  // then starts 16-byte aligned, here and in memory), 4- and 1-byte
  // stores elsewhere
  // kSpan threads a row, kThreads / kSpan rows at once
  const int vw = min(TW, W - tx0), vh = min(kTileH, H - ty0);
  const int j = tid % kSpan;
  if ((W & 3) == 0) {
    const int f4 = 3 * vw / 4, d4 = vw / 4;
    for (int ty = tid / kSpan; ty < vh; ty += kThreads / kSpan) {
      const int o = (ty0 + ty) * W + tx0;
      if (j < f4) {
        reinterpret_cast<float4*>(P.points + 3 * o)[j] =
            reinterpret_cast<const float4*>(pts + ty * 3 * TW)[j];
        reinterpret_cast<float4*>(P.normals + 3 * o)[j] =
            reinterpret_cast<const float4*>(nrm + ty * 3 * TW)[j];
      }
      if (j < d4) {
        reinterpret_cast<float4*>(P.depth + o)[j] =
            reinterpret_cast<const float4*>(dep + ty * TW)[j];
        reinterpret_cast<uint32_t*>(P.hit + o)[j] =
            reinterpret_cast<const uint32_t*>(hits + ty * TW)[j];
      }
    }
  } else {
    for (int ty = tid / kSpan; ty < vh; ty += kThreads / kSpan) {
      const int o = (ty0 + ty) * W + tx0;
      for (int e = j; e < 3 * vw; e += kSpan) {
        P.points[3 * o + e] = pts[ty * 3 * TW + e];
        P.normals[3 * o + e] = nrm[ty * 3 * TW + e];
      }
      for (int e = j; e < vw; e += kSpan) {
        P.depth[o + e] = dep[ty * TW + e];
        P.hit[o + e] = hits[ty * TW + e];
      }
    }
  }
}

template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
splat_finalize_kernel(const __grid_constant__ FinalizeParams P) {
  extern __shared__ float smem[];
  const int rounds = ROUNDS == kGeneric ? P.rounds : ROUNDS;
  const int R = rounds + 2;
  const int x0 = blockIdx.x * tile_w(R) - R, y0 = blockIdx.y * kTileH - R;
  const bool interior = x0 >= 1 && x0 + kCols <= P.W - 1 && y0 >= 1 &&
                        y0 + kTileH + 2 * R <= P.H - 1;
  if (interior)
    finalize_tile<ROUNDS, false>(P, smem, rounds);
  else
    finalize_tile<ROUNDS, true>(P, smem, rounds);
}

// the instantiations: one a fill-round count up to 3 (the flagship takes
// 2), then one that reads the count at run time
using FinalizeKernel = void (*)(FinalizeParams);
constexpr int kSpecialised = 4;
const FinalizeKernel kFinalizeKernels[kSpecialised + 1] = {
    splat_finalize_kernel<0>, splat_finalize_kernel<1>,
    splat_finalize_kernel<2>, splat_finalize_kernel<3>,
    splat_finalize_kernel<kGeneric>};

__host__ __forceinline__ FinalizeKernel finalize_kernel(int rounds) {
  return kFinalizeKernels[rounds < kSpecialised ? rounds : kSpecialised];
}

__host__ __forceinline__ size_t finalize_smem(int rounds) {
  const int R = rounds + 2;
  return sizeof(float) * (2 * kPitch * (kTileH + 2 * R + 2) +
                          staged_floats(tile_w(R)));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns cudaGetLastError() as an int (0 = launched); an argument the
// kernel does not take returns cudaErrorInvalidValue and launches nothing.

// K8.  Scatter-min the surface depth of active[:count]'s voxels into zbuf
// (H * W floats, reset to +inf by the caller).  rows: the active set's
// padded length (the grid); filter: skip rows whose band_min >= band.
extern "C" int splat_zbuffer(const int* blocks, const int* ptrs,
                             const int* count, const float* tsdf,
                             const float* weight, const float* band_min,
                             const float* T_wc, float* zbuf, int rows,
                             int n_map_rows, int block_size, int H, int W,
                             float voxel_size, float fx, float fy, float cx,
                             float cy, float znear, float zfar, float band,
                             int filter, void* stream) {
  const int V = block_size * block_size * block_size;
  if (rows < 0 || n_map_rows < 1 || block_size < 1 || V > kMaxVoxels ||
      H < 1 || W < 1 || !(znear >= 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  ZbufferParams P = {};
  P.blocks = blocks;
  P.ptrs = ptrs;
  P.count = count;
  P.tsdf = tsdf;
  P.weight = weight;
  P.band_min = band_min;
  P.T_wc = T_wc;
  P.zbuf = zbuf;
  P.rows = rows;
  P.n_map_rows = n_map_rows;
  P.bs = block_size;
  P.V = V;
  P.H = H;
  P.W = W;
  P.filter = filter != 0;
  P.voxel_size = voxel_size;
  P.fx = fx;
  P.fy = fy;
  P.cx = cx;
  P.cy = cy;
  P.znear = znear;
  P.zfar = zfar;
  P.band = band;
  // enough CTAs to fill the card (kCtasPerSm a multiprocessor), no more
  // than there are rows: the grid is launched before the count is known
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0)
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                           device);
  const int ctas = min(rows, kCtasPerSm * max(sms[device], 1));
  splat_zbuffer_kernel<<<ctas, kZThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K9.  raw (H, W) -> out: depth (H, W), then points and normals (H, W, 3)
// float32 (one buffer of 7 H W floats), and hit (H, W) bool; rounds of
// hole fill 0..kMaxFillRounds; floats, a host table: the smooth's depth
// gate sigma (metres), cx, cy, 1/fx, 1/fy.
extern "C" int splat_finalize(const float* raw, float* out, uint8_t* hit,
                              int H, int W, int rounds, const float* floats,
                              void* stream) {
  if (H < 1 || W < 1 || rounds < 0 || rounds > kMaxFillRounds)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(H) * W;
  FinalizeParams P = {};
  P.raw = raw;
  P.depth = out;
  P.points = out + n;
  P.normals = out + 4 * n;
  P.hit = hit;
  P.H = H;
  P.W = W;
  P.rounds = rounds;
  P.sigma = floats[0];
  P.cx = floats[1];
  P.cy = floats[2];
  P.rfx = floats[3];
  P.rfy = floats[4];
  const int tw = tile_w(rounds + 2);
  const dim3 grid((W + tw - 1) / tw, (H + kTileH - 1) / kTileH);
  finalize_kernel(rounds)<<<grid, kThreads, finalize_smem(rounds),
                            static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K9's instantiation for `rounds` fill rounds on the current device:
// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2]
// resident CTAs a multiprocessor, out[3] threads a CTA, out[4] shared
// memory bytes a CTA.
extern "C" int splat_finalize_info(int rounds, int* out) {
  if (rounds < 0 || rounds > kMaxFillRounds)
    return static_cast<int>(cudaErrorInvalidValue);
  const FinalizeKernel kernel = finalize_kernel(rounds);
  cudaFuncAttributes fa = {};
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, finalize_smem(rounds));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = per_sm;
  out[3] = kThreads;
  out[4] = static_cast<int>(finalize_smem(rounds) + fa.sharedSizeBytes);
  return 0;
}
