// The depth frontend and the ICP pyramid's level inputs for Hopper
// (sm_90a), two kernels:
//
//   preprocess_frame (K3a): raw int32 depth -> the frame's metric depth,
//     vertices and normals in one launch.  Replaces what XLA fused on the
//     TPU in voxelhashing_demo_tpu/ops/preprocess.py: depth_to_meters
//     (:31), reject_outliers (:86), bilateral_filter (:118),
//     compute_vertices (:43), compute_normals (:50), called by
//     preprocess (:151).
//   pyramid_levels (K3b): every pyramid level's ICP inputs of a frame in
//     one launch, from a host-built job table.  Replaces
//     downsample_depth (:184), downsample_depth_mean (:210) and
//     preprocess_metric (:175) of the same file, and pack_target /
//     oct_encode_bits (voxelhashing_demo_tpu/ops/icp.py:118, :77), as
//     icp_align_pyramid (icp.py:394) calls them at :438-460.
//
// No Pallas kernel; no PyTorch call computes either.
//
// K3a.  A CTA of 256 threads owns a 32 x 20 tile of outputs and stages its
// raw depth with a halo of R = (outlier ? 1 : 0) + (bilateral ? radius :
// 0) + 1 in shared memory: 1 for the flying-pixel support, radius for the
// bilateral, 1 for the normals.  The stages then run one after another in
// shared memory, each over a region one stage's reach smaller than the
// last:
//   1. metres and the range gate (halo R);
//   2. the 8-neighbour support count, reject_outliers (halo R - 1);
//   3. the bilateral filter (halo 1);
//   4. back-projection and central-difference normals (the tile).
// The stages and the radius are template parameters (18 instantiations;
// the host picks one), so each region's shape is a constant and the
// bilateral's (2r + 1)^2 taps unroll with constant offsets and weights.
// A tap is neither branched on (a branch a tap cost more than the expf it
// saved: 98 % of the step's pixels are valid) nor masked: at the
// bilateral's input an invalid pixel holds a value whose weight underflows
// to 0.  That needs every invalid pixel to be exactly 0 in the plain
// version, so the card takes the bilateral only with the outlier stage
// or a range gate that passes no negative depth and no -0 (depth_min >= 0
// and depth_scale > 0), a 1 / (2 sigma_depth^2) > 0 and depths below
// 1e29 (the host refuses the rest).  The centre tap needs no expf, and an
// invalid centre skips its taps.
// The halo reads wrap modulo H and W, as torch.roll (jnp.roll) does, so a
// stage computed at a halo position equals the stage at the wrapped pixel
// (no stage before the vertices depends on where a pixel lies); only a CTA
// whose halo crosses the border pays for the wrap.  The normals need no
// wrap: compute_normals' interior mask zeroes the border rows and columns.
// The (2r + 1)^2 spatial weights are the plain version's float32
// constants, computed on the host and passed by value.
//
// K3b.  A job is one level input of one image (the frame's metric depth or
// the model's).  Each job has a kind:
//   source (0): a Frame, preprocess_metric(pool(image)): depth, vertices,
//     normals;
//   target (1): only the packed (h, w, 2) target that K4 reads,
//     pack_target(preprocess_metric(pool(image))): [usable ? depth : 0,
//     oct-normal bits], the vertices and normals kept in registers;
//   pack (2): pack_target of an existing Frame (the model's depth and
//     normals at factor 1);
// a pool mode (none, min: downsample_depth, mean: downsample_depth_mean)
// and a factor f (VALID pooling: h = H / f, w = W / f, the ragged edge
// cropped).  The grid is the jobs' CTAs end to end; a CTA finds its job
// from the table's packed first-CTA array (one constant line; a lookup
// that read each job's own line took a CTA longer, PERF.md section 6).
// A source or
// target CTA owns a tile of 64 x 8 outputs, 2 a thread: it pools the tile
// and a halo of 1 into shared memory (a pixel's normal needs its 4 pooled
// neighbours; the halo outside the level image is never read for a normal
// that survives the interior mask), each thread loading all of its 3
// level pixels' windows before it pools any, a window row as one float2
// (f = 2) or float4 (f = 4) where the rows allow (in_w a multiple of f,
// the image aligned), one float at a time otherwise.  It then computes
// its outputs; a target stores its packed pixels directly (8 bytes a
// pixel, neighbouring threads on neighbouring pixels), a source its
// depth, and stages its vertices and normals in shared memory as they lie
// in memory (3 floats a pixel), then stores each tile row with
// neighbouring threads on neighbouring addresses, 16 bytes a thread where
// the level's width is a multiple of 4.  A pack CTA packs 512 consecutive
// pixels, 2 a thread (8-byte loads of the depth and the normals and a
// 16-byte store).  The tile, the pixels a pack thread takes and the
// registers (at most 64: 4 CTAs a multiprocessor) were chosen by timing
// the whole launch on the step's inputs: 64 x 16 tiles of 4 outputs a
// thread, 32 x 8 of one, 4 or 1 pack pixels a thread, the pack CTAs
// interleaved with the others, ahead of them or paired with their tiles
// in one CTA all took longer (PERF.md section 6).
// The min pool takes the smallest positive depth of the window (0 when
// none); the mean pool sums the window in row-major order, as
// reduce_window and the plain version do, and rejects a window with no
// valid pixel or whose depths span more than edge_band.
//
// Rounding: every product, sum, quotient and square root that the plain
// PyTorch version (ops/preprocess.py and icp.pack_target) computes on the
// card is written with the round-to-nearest intrinsics, in its order, so
// nvcc cannot contract anything the plain version rounds: (u - cx) *
// (1 / fx) * d with 1 / fx rounded to float32 on the host
// (geometry/f32.recip); the bilateral's acc + w * n, then wacc + w, in
// (dy, dx) order, and acc / max(wacc, 1e-12), its exp the expf that
// torch.exp runs; n / max(len, 1e-12).  Two of PyTorch's CUDA ops round in
// their own way, and the kernel follows them (measured on an H100 with
// torch 2.11 / CUDA 12.8, bit for bit over 2^20 random rows):
// torch.linalg.cross computes a component a_i b_j - a_j b_i as
// fma(a_i, b_j, -(a_j b_i)), and torch.sum over a last axis of three adds
// (x0 + x2) + x1.  The bf16 halves of the oct-normal bits round to nearest
// even as c10::BFloat16 does.  So both kernels equal their plain versions
// on the card bit for bit; on the CPU the plain version rounds as the CPU
// does.
//
// Bound: K3a at 640 x 480 reads 1.2 MB of int32 depth and writes 28
// bytes a pixel (8.6 MB): 2.93 us at 3.35 TB/s.  Its arithmetic, not its
// bytes, is what it cannot go below, and the stores overlap it: a
// bilateral tap is ~16 instructions (a subtract, two products, expf's
// eight, the weight, the product and two sums) on each of the 34 x 22 items of a 32 x 20 tile, ~550 a
// pixel with the other stages at radius 2, ~5-6 us on the card's FP32
// pipes at 1.6-1.98 GHz.  K3b reads the frame's and the model's depth
// and the model's normals (~6 MB) and writes ~8 MB of sources and packed
// targets: 3-4 us at 3.35 TB/s, the launch floor's order; its stores are
// most of those bytes, so the design writes whole sectors: each warp's
// stores cover neighbouring addresses, where a pixel a thread at a
// 12-byte stride touched three times the sectors it filled.  What both
// replace is ~780 eager launches a frame and their host work: the design
// is one launch each, every intermediate kept in shared memory or
// registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// the range gate of depth_to_meters / preprocess_metric (NaN fails it)
__device__ __forceinline__ float gate(float d, float dmin, float dmax) {
  return (d >= dmin && d <= dmax) ? d : 0.0f;
}

// ((u - c) * rf) * d: a vertex coordinate from the pixel's ray
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
// cross(down - up, right - left), normalised; zero when not ok
__device__ __forceinline__ Normal normal_at(bool ok, int u, int v, float d_up,
                                            float d_down, float d_left,
                                            float d_right, float cx, float cy,
                                            float rfx, float rfy) {
  Normal n = {0.0f, 0.0f, 0.0f};
  if (!ok) return n;
  // a = v[y + 1, x] - v[y - 1, x], b = v[y, x + 1] - v[y, x - 1]
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

// float32 -> bf16 bits, round to nearest even (c10::BFloat16's rule)
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  if (isnan(x)) return 0x7FC0u;
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float sign_nz(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// pack_target at one pixel: [usable ? d : 0, oct-normal bits]
__device__ __forceinline__ float2 pack(float d, Normal n) {
  const bool usable =
      d > 0.0f && sum3(mul(n.x, n.x), mul(n.y, n.y), mul(n.z, n.z)) > 0.5f;
  const float an = sum3(fabsf(n.x), fabsf(n.y), fabsf(n.z));
  const float anc = fmaxf(an, 1e-12f);
  const float px = dvd(n.x, anc);
  const float py = dvd(n.y, anc);
  float ox = px, oy = py;
  if (n.z < 0.0f) {
    ox = mul(sub(1.0f, fabsf(py)), sign_nz(px));
    oy = mul(sub(1.0f, fabsf(px)), sign_nz(py));
  }
  const uint32_t bits = bf16_bits(ox) | (bf16_bits(oy) << 16);
  return make_float2(usable ? d : 0.0f, __uint_as_float(bits));
}

// ---------------------------------------------------------------------------
// K3a
// ---------------------------------------------------------------------------

constexpr int kTileW = 32;        // K3a's output tile
constexpr int kTileH = 20;
constexpr int kThreadsA = 256;
constexpr int kMaxRadius = 7;     // the bilateral's largest radius
constexpr int kTaps = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1);

struct FrameParams {
  float wspace[kTaps];    // (dy, dx) row-major spatial weights
  const int* raw;         // (H, W)
  float* depth;           // (H, W)
  float* vertices;        // (H, W, 3)
  float* normals;         // (H, W, 3)
  int H, W;
  float rscale, dmin, dmax, cx, cy, rfx, rfy;
  int min_support;
  float band_base, band_quad;
  float inv2sd;
};

// what an invalid pixel (exactly 0 in the plain version) holds at the
// bilateral's input: a tap reading it weighs ws * expf(-inf) = 0, as the
// plain version's mask makes it, and adds 0 * kInvalid = 0
constexpr float kInvalid = 1e30f;
constexpr float kMaxDepth = 1e29f;   // the valid depths the taps take

// i wrapped into [0, n), as torch.roll wraps an index
__device__ __forceinline__ int wrap_into(int i, int n) {
  return (i >= 0 && i < n) ? i : wrap(i, n);
}

// The stages are template parameters: the radius unrolls the taps, and a
// stage that is off costs nothing.  With the bilateral, the pixels that
// are not > 0 hold kInvalid at its input.  Shared memory: ma holds the
// metres, then (with both filters) the bilateral's output; mb the stage
// after the metres.
template <int RADIUS, bool OUTLIER, bool BILATERAL>
__global__ void __launch_bounds__(kThreadsA)
preprocess_frame_kernel(const __grid_constant__ FrameParams P) {
  constexpr int R = (OUTLIER ? 1 : 0) + (BILATERAL ? RADIUS : 0) + 1;
  constexpr int SW = kTileW + 2 * R;          // every stage's row pitch
  constexpr int SIZE = (kTileH + 2 * R) * SW;
  __shared__ float ma[SIZE];
  __shared__ float mb[(OUTLIER || BILATERAL) ? SIZE : 1];
  float* const m0 = ma;                             // metres, halo R
  float* const m1 = OUTLIER ? mb : ma;              // after the support count
  float* const m2 = BILATERAL ? (OUTLIER ? ma : mb) : m1;   // after the filter
  const int y0 = blockIdx.y * kTileH - R;     // global row of smem row 0
  const int x0 = blockIdx.x * kTileW - R;
  const int tid = threadIdx.x;

  // 1. metres and the range gate, halo R; only a tile at the border wraps
  const bool inside = y0 >= 0 && x0 >= 0 && y0 + kTileH + 2 * R <= P.H &&
                      x0 + SW <= P.W;
  for (int i = tid; i < SIZE; i += kThreadsA) {
    const int ly = i / SW, lx = i - ly * SW;
    int gy = y0 + ly, gx = x0 + lx;
    if (!inside) {
      gy = wrap_into(gy, P.H);
      gx = wrap_into(gx, P.W);
    }
    const float d = mul(static_cast<float>(__ldg(P.raw + gy * P.W + gx)),
                        P.rscale);
    const float g = gate(d, P.dmin, P.dmax);
    m0[i] = (BILATERAL && !OUTLIER && !(g > 0.0f)) ? kInvalid : g;
  }
  __syncthreads();

  // 2. reject_outliers, halo R - 1
  if (OUTLIER) {
    constexpr int h = R - 1, RW = kTileW + 2 * h;
    constexpr int N_OUT = (kTileH + 2 * h) * RW;
    for (int i = tid; i < N_OUT; i += kThreadsA) {
      const int ry = i / RW, rx = i - ry * RW;
      const int c = (ry + 1) * SW + (rx + 1);
      const float d = m0[c];
      const float band = add(P.band_base, mul(mul(P.band_quad, d), d));
      int support = 0;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          const float n = m0[c + dy * SW + dx];
          support += (n > 0.0f && fabsf(sub(n, d)) < band) ? 1 : 0;
        }
      }
      m1[c] = (d > 0.0f && support >= P.min_support)
                  ? d
                  : (BILATERAL ? kInvalid : 0.0f);
    }
    __syncthreads();
  }

  // 3. bilateral_filter, halo 1: tap (dy, dx) reads the pixel that
  // torch.roll(depth, (dy, dx)) brings here, depth[y - dy, x - dx].  An
  // invalid centre keeps its depth (0) and skips its taps; the
  // centre tap's dz is 0, so its weight is the spatial one (expf(-0) = 1,
  // exactly)
  if (BILATERAL) {
    constexpr int RW = kTileW + 2, N_OUT = (kTileH + 2) * RW;
    constexpr int T = 2 * RADIUS + 1;
    for (int i = tid; i < N_OUT; i += kThreadsA) {
      const int ry = i / RW, rx = i - ry * RW;
      const int c = (ry + R - 1) * SW + (rx + R - 1);
      const float d = m1[c];
      float out = 0.0f;
      if (d != kInvalid) {
        out = d;
        float acc = 0.0f, wacc = 0.0f;
#pragma unroll
        for (int dy = -RADIUS; dy <= RADIUS; ++dy) {
#pragma unroll
          for (int dx = -RADIUS; dx <= RADIUS; ++dx) {
            const float ws = P.wspace[(dy + RADIUS) * T + (dx + RADIUS)];
            const float n = m1[c - dy * SW - dx];
            const float dz = sub(n, d);
            const float w = (dy == 0 && dx == 0)
                          ? ws
                          : mul(ws, expf(mul(mul(-dz, dz), P.inv2sd)));
            acc = add(acc, mul(w, n));
            wacc = add(wacc, w);
          }
        }
        if (wacc > 0.0f) out = dvd(acc, fmaxf(wacc, 1e-12f));
      }
      m2[c] = out;
    }
    __syncthreads();
  }

  // 4. depth, vertices and normals of the tile
  for (int i = tid; i < kTileW * kTileH; i += kThreadsA) {
    const int ty = i / kTileW, tx = i - ty * kTileW;
    const int v = blockIdx.y * kTileH + ty, u = blockIdx.x * kTileW + tx;
    if (v >= P.H || u >= P.W) continue;
    const int c = (ty + R) * SW + (tx + R);
    const float d = m2[c];
    const float du = m2[c - SW], dd = m2[c + SW];
    const float dl = m2[c - 1], dr = m2[c + 1];
    const bool ok = v > 0 && v < P.H - 1 && u > 0 && u < P.W - 1 &&
                    d != 0.0f && du != 0.0f && dd != 0.0f && dl != 0.0f &&
                    dr != 0.0f;
    const Normal n = normal_at(ok, u, v, du, dd, dl, dr, P.cx, P.cy, P.rfx,
                               P.rfy);
    const int o = v * P.W + u;
    P.depth[o] = d;
    P.vertices[3 * o] = ray(u, P.cx, P.rfx, d);
    P.vertices[3 * o + 1] = ray(v, P.cy, P.rfy, d);
    P.vertices[3 * o + 2] = d;
    P.normals[3 * o] = n.x;
    P.normals[3 * o + 1] = n.y;
    P.normals[3 * o + 2] = n.z;
  }
}

using FrameKernel = void (*)(FrameParams);

#define K3A_ROW(r)                                                       \
  {preprocess_frame_kernel<r, false, true>,                              \
   preprocess_frame_kernel<r, true, true>}

// the instantiation for the stages: [bilateral ? 1 + radius : 0][outlier]
const FrameKernel kFrameKernels[kMaxRadius + 2][2] = {
    {preprocess_frame_kernel<0, false, false>,
     preprocess_frame_kernel<0, true, false>},
    K3A_ROW(0), K3A_ROW(1), K3A_ROW(2), K3A_ROW(3),
    K3A_ROW(4), K3A_ROW(5), K3A_ROW(6), K3A_ROW(7)};

#undef K3A_ROW

// ---------------------------------------------------------------------------
// K3b
// ---------------------------------------------------------------------------

constexpr int kJobTileW = 64;     // K3b's output tile
constexpr int kJobTileH = 8;
constexpr int kThreadsB = 256;
constexpr int kMinBlocksB = 4;    // CTAs a multiprocessor (launch bounds)
constexpr int kLevelW = kJobTileW + 2;    // the level tile and its halo
constexpr int kLevelH = kJobTileH + 2;
constexpr int kLevelN = kLevelW * kLevelH;
constexpr int kLevelItems = (kLevelN + kThreadsB - 1) / kThreadsB;
constexpr int kTileN = kJobTileW * kJobTileH;
constexpr int kPackPixels = 2 * kThreadsB;   // a pack CTA's, 2 a thread
constexpr int kMaxJobs = 8;
constexpr int kKindSource = 0, kKindTarget = 1, kKindPack = 2;
constexpr int kPoolNone = 0, kPoolMin = 1, kPoolMean = 2;

struct Job {
  const float* in;        // the metric depth image pooled, in_w columns
  const float* in_normals;   // pack: the frame's normals (h, w, 3)
  float* depth;           // source: (h, w)
  float* vertices;        // source: (h, w, 3)
  float* normals;         // source: (h, w, 3)
  float* packed;          // target, pack: (h, w, 2)
  int kind, pool, factor, in_w, h, w;
  float cx, cy, rfx, rfy, dmin, dmax;
  int first_cta, tiles_x;
  // the pool's windows read as float2 (factor 2) or float4 (factor 4)
  // rows; the outputs stored 16 bytes at a time (pack: 2 pixels a thread)
  int vec_in, vec_out;
};

struct JobTable {
  int first_cta[kMaxJobs];   // each job's first CTA (one constant line)
  int n_jobs;
  float edge_band;
  Job job[kMaxJobs];
};

// the pooled value of a window's n depths in row-major order: the
// smallest positive one (0 when none), or the mean of the positive ones
// (0 when none, or when they span more than edge_band), summed in that
// order as reduce_window and the plain version sum them
template <int N>
__device__ __forceinline__ float reduce_window(const float (&a)[N], int pool,
                                               float edge_band) {
  if (pool == kPoolMin) {
    float m = INFINITY;
#pragma unroll
    for (int k = 0; k < N; ++k) m = fminf(m, a[k] > 0.0f ? a[k] : INFINITY);
    return isfinite(m) ? m : 0.0f;
  }
  float s = 0.0f, c = 0.0f, mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool valid = a[k] > 0.0f;
    s = add(s, valid ? a[k] : 0.0f);
    c = add(c, valid ? 1.0f : 0.0f);
    mn = fminf(mn, valid ? a[k] : INFINITY);
    mx = fmaxf(mx, valid ? a[k] : -INFINITY);
  }
  return (c > 0.0f && sub(mx, mn) <= edge_band) ? dvd(s, fmaxf(c, 1.0f))
                                                : 0.0f;
}

// the level image's pixel (y, x) of a job, pooled by a factor F window
// read as F vector rows (F = 2, 4; the job's vec_in)
template <int F>
__device__ __forceinline__ float pool_vec(const Job& J, float edge_band,
                                          int y, int x) {
  const float* row = J.in + static_cast<int64_t>(y) * F * J.in_w + x * F;
  float a[F * F];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    if constexpr (F == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + i * J.in_w));
      a[4 * i] = q.x;
      a[4 * i + 1] = q.y;
      a[4 * i + 2] = q.z;
      a[4 * i + 3] = q.w;
    } else {
      const float2 q = __ldg(reinterpret_cast<const float2*>(row + i * J.in_w));
      a[2 * i] = q.x;
      a[2 * i + 1] = q.y;
    }
  }
  return reduce_window(a, J.pool, edge_band);
}

// the same, any factor, one scalar load a depth (pool none: the pixel)
__device__ __forceinline__ float pool_scalar(const Job& J, float edge_band,
                                             int y, int x) {
  const int f = J.factor;
  const float* row = J.in + static_cast<int64_t>(y) * f * J.in_w + x * f;
  if (J.pool == kPoolMin) {
    float m = INFINITY;
    for (int i = 0; i < f; ++i)
      for (int j = 0; j < f; ++j) {
        const float a = __ldg(row + i * J.in_w + j);
        m = fminf(m, a > 0.0f ? a : INFINITY);
      }
    return isfinite(m) ? m : 0.0f;
  }
  if (J.pool == kPoolMean) {
    float s = 0.0f, c = 0.0f, mn = INFINITY, mx = -INFINITY;
    for (int i = 0; i < f; ++i)
      for (int j = 0; j < f; ++j) {
        const float a = __ldg(row + i * J.in_w + j);
        const bool valid = a > 0.0f;
        s = add(s, valid ? a : 0.0f);
        c = add(c, valid ? 1.0f : 0.0f);
        mn = fminf(mn, valid ? a : INFINITY);
        mx = fmaxf(mx, valid ? a : -INFINITY);
      }
    return (c > 0.0f && sub(mx, mn) <= edge_band) ? dvd(s, fmaxf(c, 1.0f))
                                                  : 0.0f;
  }
  return __ldg(row);
}

// The level tile of a source or target CTA: the level image over its
// kJobTileW x kJobTileH outputs and a halo of 1, 0 outside the image (a
// normal that survives the interior mask never reads it).  Every item of
// a thread is loaded before any is pooled (kLevelItems a thread), so the
// CTA's loads are in flight together.
template <int F>
__device__ __forceinline__ void level_tile_vec(const Job& J, float edge_band,
                                               int ty0, int tx0,
                                               float* tile) {
  float v[kLevelItems];
#pragma unroll
  for (int k = 0; k < kLevelItems; ++k) {
    const int i = threadIdx.x + k * kThreadsB;
    const int ly = i / kLevelW, lx = i - ly * kLevelW;
    const int y = ty0 - 1 + ly, x = tx0 - 1 + lx;
    v[k] = (i < kLevelN && y >= 0 && y < J.h && x >= 0 && x < J.w)
               ? pool_vec<F>(J, edge_band, y, x) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kLevelItems; ++k) {
    const int i = threadIdx.x + k * kThreadsB;
    if (i < kLevelN) tile[i] = gate(v[k], J.dmin, J.dmax);
  }
}

__device__ __forceinline__ void level_tile_scalar(const Job& J,
                                                  float edge_band, int ty0,
                                                  int tx0, float* tile) {
  for (int i = threadIdx.x; i < kLevelN; i += kThreadsB) {
    const int ly = i / kLevelW, lx = i - ly * kLevelW;
    const int y = ty0 - 1 + ly, x = tx0 - 1 + lx;
    tile[i] = (y >= 0 && y < J.h && x >= 0 && x < J.w)
                  ? gate(pool_scalar(J, edge_band, y, x), J.dmin, J.dmax)
                  : 0.0f;
  }
}

// rows [0, rows) of n floats each, staged at a pitch of `pitch` floats,
// to dst (row r at dst + r * stride): neighbouring threads on
// neighbouring addresses, 16 bytes a thread when vec (n, stride and dst
// multiples of 4 floats)
__device__ __forceinline__ void store_rows(float* dst, int64_t stride,
                                           const float* stage, int pitch,
                                           int rows, int n, bool vec) {
  if (vec) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < rows * n4; i += kThreadsB) {
      const int r = i / n4, k = i - r * n4;
      reinterpret_cast<float4*>(dst + r * stride)[k] =
          reinterpret_cast<const float4*>(stage + r * pitch)[k];
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += kThreadsB) {
      const int r = i / n, k = i - r * n;
      dst[r * stride + k] = stage[r * pitch + k];
    }
  }
}

// a pack CTA: pack_target of kPackPixels consecutive pixels of the frame,
// 2 a thread (8-byte loads of the depth and the normals and a 16-byte
// store when vec_out; one pixel at a time at the ragged end)
__device__ __forceinline__ void pack_pixels(const Job& J, int t) {
  const int64_t n = static_cast<int64_t>(J.h) * J.w;
  const int64_t p0 = static_cast<int64_t>(t) * kPackPixels + 2 * threadIdx.x;
  if (J.vec_out && p0 + 2 <= n) {
    const float2 d = __ldg(reinterpret_cast<const float2*>(J.in + p0));
    const float2* nq = reinterpret_cast<const float2*>(J.in_normals + 3 * p0);
    const float2 a = __ldg(nq), b = __ldg(nq + 1), c = __ldg(nq + 2);
    const float2 o0 = pack(d.x, {a.x, a.y, b.x});
    const float2 o1 = pack(d.y, {b.y, c.x, c.y});
    reinterpret_cast<float4*>(J.packed + 2 * p0)[0] =
        make_float4(o0.x, o0.y, o1.x, o1.y);
    return;
  }
  const int64_t end = p0 + 2 < n ? p0 + 2 : n;
  for (int64_t p = p0; p < end; ++p) {
    const float* nrm = J.in_normals + 3 * p;
    const Normal q = {__ldg(nrm), __ldg(nrm + 1), __ldg(nrm + 2)};
    reinterpret_cast<float2*>(J.packed)[p] = pack(__ldg(J.in + p), q);
  }
}

// registers capped so that kMinBlocksB CTAs fit a multiprocessor
// whichever path a CTA takes (the factor-4 windows' loads would take more)
__global__ void __launch_bounds__(kThreadsB, kMinBlocksB)
pyramid_levels_kernel(const __grid_constant__ JobTable T) {
  __shared__ float tile[kLevelN];
  // a source's vertices, then its normals, as they lie in memory (3
  // floats a pixel, kJobTileW pixels a row)
  __shared__ __align__(16) float stage[2 * 3 * kTileN];
  int j = 0;
  while (j + 1 < T.n_jobs && static_cast<int>(blockIdx.x) >=
                                  T.first_cta[j + 1])
    ++j;
  const Job& J = T.job[j];
  const int t = blockIdx.x - J.first_cta;
  if (J.kind == kKindPack) {
    pack_pixels(J, t);
    return;
  }
  const int ty0 = (t / J.tiles_x) * kJobTileH;
  const int tx0 = (t % J.tiles_x) * kJobTileW;
  if (J.vec_in && J.factor == 4)
    level_tile_vec<4>(J, T.edge_band, ty0, tx0, tile);
  else if (J.vec_in)
    level_tile_vec<2>(J, T.edge_band, ty0, tx0, tile);
  else
    level_tile_scalar(J, T.edge_band, ty0, tx0, tile);
  __syncthreads();

  const int rows = min(kJobTileH, J.h - ty0), cols = min(kJobTileW, J.w - tx0);
#pragma unroll
  for (int k = 0; k < kTileN / kThreadsB; ++k) {
    const int i = threadIdx.x + k * kThreadsB;
    const int ly = i / kJobTileW, lx = i - ly * kJobTileW;
    const int v = ty0 + ly, u = tx0 + lx;
    if (ly >= rows || lx >= cols) continue;
    const int c = (ly + 1) * kLevelW + lx + 1;
    const float d = tile[c];
    const float du = tile[c - kLevelW], dd = tile[c + kLevelW];
    const float dl = tile[c - 1], dr = tile[c + 1];
    const bool ok = v > 0 && v < J.h - 1 && u > 0 && u < J.w - 1 &&
                    d != 0.0f && du != 0.0f && dd != 0.0f && dl != 0.0f &&
                    dr != 0.0f;
    const Normal n = normal_at(ok, u, v, du, dd, dl, dr, J.cx, J.cy, J.rfx,
                               J.rfy);
    const int64_t o = static_cast<int64_t>(v) * J.w + u;
    if (J.kind == kKindTarget) {
      reinterpret_cast<float2*>(J.packed)[o] = pack(d, n);
      continue;
    }
    J.depth[o] = d;
    float* sv = stage + 3 * i;
    float* sn = stage + 3 * kTileN + 3 * i;
    sv[0] = ray(u, J.cx, J.rfx, d);
    sv[1] = ray(v, J.cy, J.rfy, d);
    sv[2] = d;
    sn[0] = n.x;
    sn[1] = n.y;
    sn[2] = n.z;
  }
  if (J.kind == kKindTarget) return;
  __syncthreads();
  const int64_t first = 3 * (static_cast<int64_t>(ty0) * J.w + tx0);
  store_rows(J.vertices + first, 3 * static_cast<int64_t>(J.w), stage,
             3 * kJobTileW, rows, 3 * cols, J.vec_out);
  store_rows(J.normals + first, 3 * static_cast<int64_t>(J.w),
             stage + 3 * kTileN, 3 * kJobTileW, rows, 3 * cols, J.vec_out);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns cudaGetLastError() as an int (0 = launched); an argument the
// kernel does not take returns cudaErrorInvalidValue and launches nothing.

// K3a.  raw (H, W) int32 -> out: the depth (H, W), then the vertices and
// the normals (H, W, 3), float32, in one buffer of 7 H W floats.  Host
// tables (built once a configuration): ints = outlier, min_support,
// bilateral, radius; floats = 1/depth_scale, depth_min, depth_max, cx, cy,
// 1/fx, 1/fy, band_base, band_quad, 1/(2 sigma_depth^2), then the
// (2 radius + 1)^2 spatial weights (read when bilateral).
extern "C" int preprocess_frame(const int* raw, float* out, int H, int W,
                                const int* ints, const float* floats,
                                void* stream) {
  const int outlier = ints[0], min_support = ints[1], bilateral = ints[2],
            radius = ints[3];
  if (H <= 0 || W <= 0 || (bilateral && (radius < 0 || radius > kMaxRadius)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the bilateral's taps take no mask (kInvalid), which needs every invalid
  // pixel the filter reads to be exactly 0 in the plain version: refuse the
  // rest (the host says why)
  const float rscale = floats[0], dmin = floats[1], inv2sd = floats[9];
  const float vmax = fminf(floats[2], 2147483648.0f * fabsf(rscale));
  if (bilateral && (!(outlier || (dmin >= 0.0f && rscale > 0.0f)) ||
                    !(inv2sd > 0.0f) || !(vmax < kMaxDepth)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(H) * W;
  FrameParams P = {};
  const int taps = bilateral ? (2 * radius + 1) * (2 * radius + 1) : 0;
  for (int k = 0; k < taps; ++k) P.wspace[k] = floats[10 + k];
  P.raw = raw;
  P.depth = out;
  P.vertices = out + n;
  P.normals = out + 4 * n;
  P.H = H;
  P.W = W;
  P.rscale = floats[0];
  P.dmin = floats[1];
  P.dmax = floats[2];
  P.cx = floats[3];
  P.cy = floats[4];
  P.rfx = floats[5];
  P.rfy = floats[6];
  P.min_support = min_support;
  P.band_base = floats[7];
  P.band_quad = floats[8];
  P.inv2sd = floats[9];
  const FrameKernel kernel =
      kFrameKernels[bilateral ? radius + 1 : 0][outlier ? 1 : 0];
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  kernel<<<grid, kThreadsA, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K3b.  images: the source depth, the target depth, the target Frame's
// depth and normals (each may be null where no job reads it); out: the
// one output buffer.  Per job, ints[8 j ..] = kind, pool, factor, in_w,
// h, w, image (0 source, 1 target, 2 the target Frame's), the job's first
// float in out (a source's depth there, its vertices h w floats on, its
// normals 4 h w floats on; a target's packed (h, w, 2) there, an even
// offset); floats[6 j ..] = cx, cy, 1/fx, 1/fy, depth_min, depth_max.
extern "C" int pyramid_levels(const float* src, const float* tgt,
                              const float* tgt_depth,
                              const float* tgt_normals, float* out,
                              const int* ints, const float* floats,
                              int n_jobs, float edge_band, void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxJobs || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const images[3] = {src, tgt, tgt_depth};
  const auto aligned = [](const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  JobTable T = {};
  T.n_jobs = n_jobs;
  T.edge_band = edge_band;
  int ctas = 0;
  for (int j = 0; j < n_jobs; ++j) {
    Job& J = T.job[j];
    const int* I = ints + 8 * j;
    J.kind = I[0];
    J.pool = I[1];
    J.factor = I[2];
    J.in_w = I[3];
    J.h = I[4];
    J.w = I[5];
    const int image = I[6];
    if (J.kind < kKindSource || J.kind > kKindPack || J.pool < kPoolNone ||
        J.pool > kPoolMean || J.factor < 1 || J.h < 1 || J.w < 1 ||
        image < 0 || image > 2 || I[7] < 0 || images[image] == nullptr ||
        (J.kind == kKindPack &&
         (J.pool != kPoolNone || J.factor != 1 || image != 2 ||
          tgt_normals == nullptr || J.in_w != J.w)) ||
        (J.pool == kPoolNone && J.factor != 1) || J.in_w < J.w * J.factor ||
        (J.kind != kKindSource && I[7] % 2 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t hw = static_cast<int64_t>(J.h) * J.w;
    float* o = out + I[7];
    J.in = images[image];
    J.in_normals = J.kind == kKindPack ? tgt_normals : nullptr;
    J.depth = J.kind == kKindSource ? o : nullptr;
    J.vertices = J.kind == kKindSource ? o + hw : nullptr;
    J.normals = J.kind == kKindSource ? o + 4 * hw : nullptr;
    J.packed = J.kind == kKindSource ? nullptr : o;
    const float* F = floats + 6 * j;
    J.cx = F[0];
    J.cy = F[1];
    J.rfx = F[2];
    J.rfy = F[3];
    J.dmin = F[4];
    J.dmax = F[5];
    J.vec_in = (J.factor == 2 || J.factor == 4) && J.in_w % J.factor == 0 &&
               aligned(J.in, 4 * J.factor);
    if (J.kind == kKindPack) {
      J.vec_out = aligned(J.in, 16) && aligned(J.in_normals, 16) &&
                  aligned(J.packed, 16);
      J.tiles_x = 1;
      J.first_cta = T.first_cta[j] = ctas;
      ctas += static_cast<int>((hw + kPackPixels - 1) / kPackPixels);
      continue;
    }
    J.vec_out = J.kind == kKindSource && J.w % 4 == 0 &&
                aligned(J.vertices, 16) && aligned(J.normals, 16);
    J.first_cta = T.first_cta[j] = ctas;
    J.tiles_x = (J.w + kJobTileW - 1) / kJobTileW;
    ctas += J.tiles_x * ((J.h + kJobTileH - 1) / kJobTileH);
  }
  pyramid_levels_kernel<<<ctas, kThreadsB, 0,
                          static_cast<cudaStream_t>(stream)>>>(T);
  return static_cast<int>(cudaGetLastError());
}
