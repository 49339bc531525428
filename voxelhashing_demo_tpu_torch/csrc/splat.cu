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
// K9.  A CTA owns a 32 x 16 tile of outputs and stages the raw depth with
// a halo of R = fill_rounds + 2 in shared memory; the stages then run one
// after another there, each over a region one stage's reach smaller:
//   1. the raw buffer (not finite -> 0: "no estimate"), halo R;
//   2. each round of the 3 x 3 valid-min hole fill, halo R - 1 ... 2;
//   3. the edge-preserving smooth, halo 1;
//   4. points, normals, depth and hit of the tile.
// The border is where the two stencils differ.  The smooth reads the
// filled depth of the wrapped pixel (torch.roll), but the fill does not
// wrap: reduce_window's SAME padding (max_pool2d's) puts +inf outside the
// image.  So every halo cell holds the wrapped pixel, and a fill reads a
// neighbour only if it lies inside the image in the cell's own, wrapped,
// coordinates; the cell beside it in the tile may lie across the border
// and is never read then.  Each stage computed at a halo cell therefore
// equals the stage at the wrapped pixel.  The normals need no wrap:
// compute_normals' interior mask zeroes the border rows and columns.
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
// depth, points, normals and hit (~9.5 MB): ~3 us.  What the pair
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

// i / n for 0 <= i < 2^16 and 0 < n <= 128, by the float reciprocal
// rn = 1 / n: (i + 0.5) / n lies at least 1 / 256 from an integer, far
// beyond the product's rounding, so truncating it is exact
__device__ __forceinline__ int div_small(int i, float rn) {
  return __float2int_rz(__fmul_rn(static_cast<float>(i) + 0.5f, rn));
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

// ((u - c) * rf) * d: a point coordinate from the pixel's ray
__device__ __forceinline__ float ray(int u, float c, float rf, float d) {
  return mul(mul(sub(static_cast<float>(u), c), rf), d);
}

struct Normal {
  float x, y, z;
};

// x0 + x1 + x2 as torch.sum adds a last axis of three on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(x0, x2), x1);
}

// a_i b_j - a_j b_i as torch.linalg.cross computes it on the card
__device__ __forceinline__ float cross1(float ai, float bj, float aj, float bi) {
  return __fmaf_rn(ai, bj, -mul(aj, bi));
}

// compute_normals at one pixel from its four neighbours' depths (the
// interior mask and the validity of all five are the caller's `ok`):
// cross(down - up, right - left), normalised; zero when not ok.  A copy of
// csrc/preprocess.cu's, so that each source's hash covers what it runs.
__device__ __forceinline__ Normal normal_at(bool ok, int u, int v, float d_up,
                                            float d_down, float d_left,
                                            float d_right, float cx, float cy,
                                            float rfx, float rfy) {
  Normal n = {0.0f, 0.0f, 0.0f};
  if (!ok) return n;
  const float ax = sub(ray(u, cx, rfx, d_down), ray(u, cx, rfx, d_up));
  const float ay = sub(ray(v + 1, cy, rfy, d_down), ray(v - 1, cy, rfy, d_up));
  const float az = sub(d_down, d_up);
  const float bx = sub(ray(u + 1, cx, rfx, d_right), ray(u - 1, cx, rfx, d_left));
  const float by = sub(ray(v, cy, rfy, d_right), ray(v, cy, rfy, d_left));
  const float bz = sub(d_right, d_left);
  const float cx_ = cross1(ay, bz, az, by);
  const float cy_ = cross1(az, bx, ax, bz);
  const float cz_ = cross1(ax, by, ay, bx);
  const float len = __fsqrt_rn(sum3(mul(cx_, cx_), mul(cy_, cy_),
                                    mul(cz_, cz_)));
  if (len > 1e-12f) {
    const float l = fmaxf(len, 1e-12f);
    n.x = dvd(cx_, l);
    n.y = dvd(cy_, l);
    n.z = dvd(cz_, l);
  }
  return n;
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

constexpr int kTileW = 32;        // K9's output tile
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kMaxFillRounds = 16;

struct FinalizeParams {
  const float* raw;        // (H, W) raw depth: not finite or 0 = none
  float* depth;            // (H, W)
  float* points;           // (H, W, 3)
  float* normals;          // (H, W, 3)
  uint8_t* hit;            // (H, W) bool
  int H, W, rounds;
  float sigma, cx, cy, rfx, rfy;
};

__global__ void __launch_bounds__(kThreads)
splat_finalize_kernel(const __grid_constant__ FinalizeParams P) {
  extern __shared__ float smem[];
  const int R = P.rounds + 2;
  const int sw = kTileW + 2 * R;              // every stage's row pitch
  const int size = (kTileH + 2 * R) * sw;
  float* src = smem;                          // the fill's ping-pong pair
  float* dst = smem + size;
  float* smooth = smem + 2 * size;
  const int y0 = blockIdx.y * kTileH - R;     // unwrapped row of smem row 0
  const int x0 = blockIdx.x * kTileW - R;
  const int tid = threadIdx.x;

  // 1. the raw buffer, halo R (wrapped reads)
  const float rsw = 1.0f / static_cast<float>(sw);
  for (int i = tid; i < size; i += kThreads) {
    const int ly = div_small(i, rsw), lx = i - ly * sw;
    const float d =
        __ldg(P.raw + wrap(y0 + ly, P.H) * P.W + wrap(x0 + lx, P.W));
    src[i] = isfinite(d) ? d : 0.0f;
  }
  __syncthreads();

  // 2. _min_fill: round r writes halo R - r from halo R - r + 1; a
  // neighbour counts only inside the image, in the cell's own (wrapped)
  // coordinates (+inf padding)
  for (int r = 1; r <= P.rounds; ++r) {
    const int h = R - r;
    const int rw = kTileW + 2 * h, n_out = (kTileH + 2 * h) * rw;
    const float rrw = 1.0f / static_cast<float>(rw);
    for (int i = tid; i < n_out; i += kThreads) {
      const int ry = div_small(i, rrw), rx = i - ry * rw;
      const int ly = ry + R - h, lx = rx + R - h;
      const int c = ly * sw + lx;
      const float d = src[c];
      if (d > 0.0f) {
        dst[c] = d;
        continue;
      }
      const int gy = wrap(y0 + ly, P.H), gx = wrap(x0 + lx, P.W);
      // which of the rows and columns dy, dx = -1, 0, 1 lie in the image
      const bool row_ok[3] = {gy > 0, true, gy < P.H - 1};
      const bool col_ok[3] = {gx > 0, true, gx < P.W - 1};
      float m = INFINITY;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const float n = src[c + dy * sw + dx];
          const bool in = row_ok[dy + 1] && col_ok[dx + 1] && n > 0.0f;
          m = fminf(m, in ? n : INFINITY);
        }
      }
      dst[c] = isfinite(m) ? m : 0.0f;
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  // 3. _edge_preserving_smooth, halo 1: tap (dy, dx) reads the pixel that
  // torch.roll(depth, (dy, dx)) brings here, depth[y - dy, x - dx]
  {
    const int rw = kTileW + 2, n_out = (kTileH + 2) * rw;
    for (int i = tid; i < n_out; i += kThreads) {
      const int ry = i / (kTileW + 2), rx = i - ry * rw;
      const int c = (ry + R - 1) * sw + (rx + R - 1);
      const float d = src[c];
      float acc = 0.0f, cnt = 0.0f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const float n = src[c - dy * sw - dx];
          const bool ok = n > 0.0f && fabsf(sub(n, d)) < P.sigma;
          acc = add(acc, ok ? n : 0.0f);
          cnt = add(cnt, ok ? 1.0f : 0.0f);
        }
      }
      smooth[c] = (d > 0.0f && cnt > 0.0f) ? dvd(acc, fmaxf(cnt, 1.0f)) : d;
    }
  }
  __syncthreads();

  // 4. depth, points, normals and hit of the tile
  for (int i = tid; i < kTileW * kTileH; i += kThreads) {
    const int ty = i / kTileW, tx = i - ty * kTileW;
    const int v = blockIdx.y * kTileH + ty, u = blockIdx.x * kTileW + tx;
    if (v >= P.H || u >= P.W) continue;
    const int c = (ty + R) * sw + (tx + R);
    const float d = smooth[c];
    const float du = smooth[c - sw], dd = smooth[c + sw];
    const float dl = smooth[c - 1], dr = smooth[c + 1];
    const bool ok = v > 0 && v < P.H - 1 && u > 0 && u < P.W - 1 &&
                    d != 0.0f && du != 0.0f && dd != 0.0f && dl != 0.0f &&
                    dr != 0.0f;
    const Normal n = normal_at(ok, u, v, du, dd, dl, dr, P.cx, P.cy, P.rfx,
                               P.rfy);
    const bool hit = d > 0.0f;
    const int o = v * P.W + u;
    P.depth[o] = d;
    P.points[3 * o] = hit ? ray(u, P.cx, P.rfx, d) : 0.0f;
    P.points[3 * o + 1] = hit ? ray(v, P.cy, P.rfy, d) : 0.0f;
    P.points[3 * o + 2] = hit ? d : 0.0f;
    P.normals[3 * o] = n.x;
    P.normals[3 * o + 1] = n.y;
    P.normals[3 * o + 2] = n.z;
    P.hit[o] = hit ? 1 : 0;
  }
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

// K9.  raw (H, W) -> depth (H, W), points and normals (H, W, 3) float32,
// hit (H, W) bool; rounds of hole fill 0..kMaxFillRounds, sigma the
// smooth's depth gate (metres).
extern "C" int splat_finalize(const float* raw, float* depth, float* points,
                              float* normals, uint8_t* hit, int H, int W,
                              int rounds, float sigma, float cx, float cy,
                              float rfx, float rfy, void* stream) {
  if (H < 1 || W < 1 || rounds < 0 || rounds > kMaxFillRounds)
    return static_cast<int>(cudaErrorInvalidValue);
  FinalizeParams P = {};
  P.raw = raw;
  P.depth = depth;
  P.points = points;
  P.normals = normals;
  P.hit = hit;
  P.H = H;
  P.W = W;
  P.rounds = rounds;
  P.sigma = sigma;
  P.cx = cx;
  P.cy = cy;
  P.rfx = rfx;
  P.rfy = rfy;
  const int R = rounds + 2;
  const size_t smem =
      sizeof(float) * 3 * (kTileH + 2 * R) * (kTileW + 2 * R);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  splat_finalize_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
