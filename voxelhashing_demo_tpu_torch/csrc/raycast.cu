// The march prediction for Hopper (sm_90a), two kernels:
//
//   raycast_march (K11): the sphere tracer.  Per ray, max_steps steps of
//     sphere tracing against the trilinear TSDF (coarse steps through
//     unknown space, max(step_scale |s|, min_step voxel) in known space),
//     the secant refinement at the first zero crossing, the near / far
//     gate, then the camera-space point and, in gradient mode, the normal
//     from the central-difference SDF gradient (6 trilinear samples),
//     flipped toward the camera.  Replaces what XLA fused on the TPU in
//     voxelhashing_demo_tpu/ops/raycast.py: raycast_rays (:52-133, the
//     lax.fori_loop at :111), with ops/tsdf.py trilinear_sample (:120) and
//     sdf_gradient (:165).
//   densify_cache (K12): the view-local cache.  The cache origin ahead of
//     the camera snapped to the block grid, every cell truncation / 0,
//     the valid in-cache voxels of the rows written in place, the others
//     dropped (JAX mode="drop").  Replaces densify_rows (:117-171) with
//     densify_active (:87-114) of voxelhashing_demo_tpu/ops/
//     hash_raycast.py.
//
// No Pallas kernel; no PyTorch call computes either.
//
// K11.  One thread a ray, CTAs of 16 x 8 rays (a warp two rows of 16
// neighbouring pixels, so a warp's samples fall in neighbouring cells);
// the whole step loop runs in the kernel, the cache read through the
// read-only path (no texture filtering: its 9-bit fixed-point weights
// would change the result).  A sample outside the volume loads nothing
// (the plain version reads clamped cells and discards them).  Two exits,
// both exact:
//   - a ray that has hit stops: from then on t is frozen (t = where(hit, t,
//     ...)), t_hit changes only on a crossing of a ray that has not hit,
//     and hit only grows, so no later step changes an output;
//   - a ray whose sample lies outside the volume on an axis k along which
//     its direction moves away (base_k < 0 and d_k <= 0, or base_k >
//     dims_k - 2 and d_k >= 0) stops when the farthest point it can still
//     reach lies within 1e9 voxels of the volume on that axis (with a
//     positive voxel size, a coarse increment >= 0 and fewer than 2^20
//     steps left; else it runs on).  Every
//     later sample is then unknown, so every later step is the coarse one,
//     t grows by the same increment each step (>= 0), and the ray's
//     position, its voxel coordinate g_k and floor(g_k) are monotone in t
//     under round-to-nearest, so base_k never comes back; within 1e9
//     voxels the int32 conversion does not saturate and base_k + 1 does
//     not wrap (the plain version's int32 arithmetic would let a sample at
//     2^31 voxels back in).  Unknown samples change nothing but t, which
//     is not an output.
// What bounds it: the cache cells the rays' samples reach (two float
// arrays; each 32-byte sector once) and the outputs, 29 B a ray; and the
// ~80 float operations of a step, up to max_steps steps a ray.  A simple
// design: no staging of the cache, the rays' samples served by L1 / L2.
//
// The NaN secant step is kept: prev_sdf starts at +inf, so a ray whose
// first known sample is <= 0 crosses with t_ref = inf / inf = NaN, and the
// final t_hit > near test rejects it.
//
// Rounding: every product, sum and quotient of the plain version
// (ops/raycast.py raycast_rays_reference, ops/tsdf.py) on the card is
// written with the round-to-nearest intrinsics, in its order, so nvcc
// contracts nothing that eager PyTorch rounds twice: rays @ R.T as the
// library's (N, 3) @ (3, 3) matmul sums a row, fma(a2, b2, fma(a1, b1,
// a0 b0)) (chip_rounding_probe.py `march_ops`); the norm sqrt((x0 x0 +
// x2 x2) + x1 x1) (torch.sum over three); 1 / norm an IEEE divide
// (torch.reciprocal; `1.0 / t` is t.reciprocal() * 1.0); origin + dirs t,
// (pos - origin) / voxel_size (a true divide by a tensor), floor, the
// int32 conversion (saturating, NaN to 0), g - base; each corner weight
// multiplied left to right from (1 - f) or f and added in (dx, dy, dz)
// order from 0.0; a Python double as its float32 (step_scale, min_step,
// coarse_step, 1e-12, 1e-9, near, far); torch.maximum and torch.clamp
// NaN-propagating; n_world @ R as the matmul; sum(n_cam * rays) as
// torch.sum over three.  So the kernel equals its plain version on the card
// bit for bit; on the CPU the plain version rounds as the CPU does.
//
// K12.  Two launches on the stream, no atomics:
//   1. one CTA: the origin (thread 0, from T_wc on the device: center =
//      cam_pos + forward * ahead, world2block, block2voxel, voxel2world),
//      then a block grid of ceil(X / B) x ceil(Y / B) x ceil(Z / B) int32
//      (128 KB at 256^3) reset to -1, a barrier, and each valid row whose
//      block lies in the cache writes its source row into its cell.  Rows
//      at or past the device count are never read.  The active blocks are
//      distinct, so no two rows share a cell: no write races;
//   2. a streaming pass over every cell (4 cells a thread, one 16-byte
//      store of each array where Z % 4 == 0): the cell's block row, read
//      from the grid (L1 / L2), gives the voxel (its in-block index
//      z B^2 + y B + x, linearize_voxel's order), or truncation / 0.
// A cell is written once, so the fill and the scatter cannot race.  What
// bounds it: the cache it writes, 2 X Y Z 4 bytes (134 MB at 256^3, ~40 us
// at 3.35 TB/s), and 8 bytes a voxel of the rows in the cache.  The block
// grid is what a later K11 could sample through instead of the cache.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// a0 b0 + a1 b1 + a2 b2 as the card's (N, 3) @ (3, 3) matmul sums it
__device__ __forceinline__ float dot_mm(float a0, float b0, float a1, float b1,
                                        float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, mul(a0, b0)));
}

// x0 + x1 + x2 as torch.sum adds a last axis of three on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(x0, x2), x1);
}

// torch.maximum / torch.clamp(min=) on the card: a NaN operand wins
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

constexpr int kTileX = 16;          // K11: rays a CTA along a row
constexpr int kTileY = 8;           // ... and rows
constexpr int kIndexThreads = 1024; // K12's scatter CTA
constexpr int kFillThreads = 256;   // K12's fill CTAs
constexpr float kExitVoxels = 1.0e9f;   // K11's out-of-volume exit reach

struct MarchParams {
  const float* rays;      // (n, 3) camera-space rays
  const float* T_wc;      // (4, 4)
  const float* sdf;       // (X, Y, Z)
  const float* weight;    // (X, Y, Z)
  const float* origin;    // (3,) the volume's voxel (0, 0, 0)
  const float* voxel;     // () voxel size
  float* depth;           // (n,)
  float* points;          // (n, 3)
  float* normals;         // (n, 3)
  uint8_t* hit;           // (n,)
  int h, w;
  int X, Y, Z;
  int max_steps;
  int gradient;           // 1: gradient normals; 0: the wrapper's own
  float step_scale, min_step, coarse_step, near_, far_;
};

// The volume's trilinear sample at p (tsdf.trilinear_sample): (sdf, weight)
// of a known sample, inside = false and nothing read outside the volume;
// base the sample's floor voxel.
struct Sample {
  float s, w;
  bool known;
  int base[3];
};

__device__ __forceinline__ Sample trilinear(const MarchParams& P,
                                            const float p[3],
                                            const float O[3], float vox) {
  Sample out;
  float frac[3];
  bool inside = true;
  const int dims[3] = {P.X, P.Y, P.Z};
  int b[3];
  for (int k = 0; k < 3; ++k) {
    const float g = dvd(sub(p[k], O[k]), vox);
    const int base = __float2int_rz(floorf(g));   // .to(int32): saturates
    out.base[k] = base;
    frac[k] = sub(g, __int2float_rn(base));
    // (base >= 0) & (base + 1 <= dims - 1), base + 1 wrapping as int32
    const int up = static_cast<int>(static_cast<unsigned>(base) + 1u);
    inside = inside && base >= 0 && up <= dims[k] - 1;
    b[k] = min(max(base, 0), dims[k] - 2);
  }
  out.s = 0.0f;
  out.w = 0.0f;
  out.known = false;
  if (!inside) return out;
  const int64_t Y = P.Y, Z = P.Z;
  const int64_t flat0 = (static_cast<int64_t>(b[0]) * Y + b[1]) * Z + b[2];
  float acc_s = 0.0f, acc_w = 0.0f;
  bool all_w = true;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int64_t idx = flat0 + ((dx * Y + dy) * Z + dz);
        const float s = __ldg(P.sdf + idx);
        const float w = __ldg(P.weight + idx);
        const float wx = dx ? frac[0] : sub(1.0f, frac[0]);
        const float wy = dy ? frac[1] : sub(1.0f, frac[1]);
        const float wz = dz ? frac[2] : sub(1.0f, frac[2]);
        const float wt = mul(mul(wx, wy), wz);
        acc_s = add(acc_s, mul(wt, s));
        acc_w = add(acc_w, mul(wt, w));
        all_w = all_w && w > 0.0f;     // min(w) > 0, a NaN included
      }
    }
  }
  if (all_w) {
    out.s = acc_s;
    out.w = acc_w;
    out.known = true;
  }
  return out;
}

__global__ void __launch_bounds__(kTileX * kTileY)
march_kernel(const MarchParams P) {
  const int col = blockIdx.x * kTileX + threadIdx.x;
  const int row = blockIdx.y * kTileY + threadIdx.y;
  if (col >= P.w || row >= P.h) return;
  const int64_t i = static_cast<int64_t>(row) * P.w + col;
  const float r[3] = {P.rays[3 * i], P.rays[3 * i + 1], P.rays[3 * i + 2]};
  float R[3][3], o[3], O[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) R[j][k] = __ldg(P.T_wc + 4 * j + k);
    o[j] = __ldg(P.T_wc + 4 * j + 3);
    O[j] = __ldg(P.origin + j);
  }
  const float vox = __ldg(P.voxel);
  // dirs = rays @ R.T: dirs_j = sum_k r_k R[j][k]
  float d[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    d[j] = dot_mm(r[0], R[j][0], r[1], R[j][1], r[2], R[j][2]);
  const float inv_len =
      dvd(1.0f, __fsqrt_rn(sum3(mul(d[0], d[0]), mul(d[1], d[1]),
                                mul(d[2], d[2]))));
  const float min_step = mul(P.min_step, vox);
  const float coarse_step = mul(P.coarse_step, vox);
  const float coarse_inc = mul(coarse_step, inv_len);
  const int dims[3] = {P.X, P.Y, P.Z};

  float t = add(0.0f, P.near_);
  float t_hit = 0.0f;
  bool hit = false;
  float prev_sdf = INFINITY;
  float prev_t = t;
  for (int step = 0; step < P.max_steps && !hit; ++step) {
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = add(o[k], mul(d[k], t));
    const Sample smp = trilinear(P, p, O, vox);
    const bool known = smp.known && smp.w > 0.0f;
    const float s = known ? smp.s : 0.0f;
    if (known) {
      if (s <= 0.0f && prev_sdf > 0.0f) {
        // the secant between prev_t and t (NaN when prev_sdf is +inf)
        const float diff = sub(prev_sdf, s);
        const float denom = fabsf(diff) > 1e-12f ? diff : 1e-12f;
        t_hit = add(prev_t, mul(sub(t, prev_t), dvd(prev_sdf, denom)));
        hit = true;      // t stays: nothing later changes the outputs
      } else {
        const float step_m = max_nan(mul(P.step_scale, fabsf(s)), min_step);
        prev_sdf = s;
        prev_t = t;
        t = add(t, mul(step_m, inv_len));
      }
      continue;
    }
    t = add(t, coarse_inc);
    // out of the volume and moving away from it: every later sample is
    // unknown (see the note above)
    // (t_far bounds every later t: each step rounds t + coarse_inc up by
    // at most 2^-24, (1 + 2^-24)^rem < 1.25 for rem < 2^20)
    const float rem = static_cast<float>(P.max_steps - step - 1);
    const float t_far = (t + rem * coarse_inc * 1.25f) * 1.25f;
    if (!(coarse_inc >= 0.0f) || !(vox > 0.0f) || !(rem < 1048576.0f) ||
        !(t_far < INFINITY))
      continue;
    bool gone = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float reach = ((fabsf(o[k]) + fabsf(d[k]) * t_far) * 1.25f
                           + fabsf(O[k])) * 1.25f / vox;
      gone = gone || (reach < kExitVoxels &&
                      ((smp.base[k] < 0 && d[k] <= 0.0f) ||
                       (smp.base[k] > dims[k] - 2 && d[k] >= 0.0f)));
    }
    if (gone) break;
  }
  hit = hit && t_hit > P.near_ && t_hit < P.far_;

  P.depth[i] = hit ? t_hit : 0.0f;
  P.hit[i] = hit ? 1 : 0;
  float n_cam[3] = {0.0f, 0.0f, 0.0f};
  if (hit && P.gradient) {
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = add(o[k], mul(d[k], t_hit));
    const float two_h = mul(2.0f, vox);
    float g[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float pp[3], pm[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float e = k == a ? vox : 0.0f;
        pp[k] = add(p[k], e);
        pm[k] = sub(p[k], e);
      }
      const Sample sp = trilinear(P, pp, O, vox);
      const Sample sm = trilinear(P, pm, O, vox);
      g[a] = dvd(sub(sp.s, sm.s), two_h);
    }
    const float glen = __fsqrt_rn(sum3(mul(g[0], g[0]), mul(g[1], g[1]),
                                       mul(g[2], g[2])));
    float n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      n[k] = glen > 1e-9f ? dvd(g[k], max_nan(glen, 1e-9f)) : 0.0f;
    // n_world @ R: n_cam_j = sum_k n_k R[k][j]
#pragma unroll
    for (int j = 0; j < 3; ++j)
      n_cam[j] = dot_mm(n[0], R[0][j], n[1], R[1][j], n[2], R[2][j]);
    if (sum3(mul(n_cam[0], r[0]), mul(n_cam[1], r[1]),
             mul(n_cam[2], r[2])) > 0.0f) {
#pragma unroll
      for (int j = 0; j < 3; ++j) n_cam[j] = -n_cam[j];
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    P.points[3 * i + k] = hit ? mul(r[k], t_hit) : 0.0f;
    P.normals[3 * i + k] = n_cam[k];
  }
}

struct DensifyParams {
  const int* blocks;      // (A, 3)
  const int* ptrs;        // (A,) map rows (the local form), or null
  const int* count;       // () rows walked (the local form), or null
  const uint8_t* valid;   // (A,) (the explicit form), or null
  const float* T_wc;      // (4, 4)
  const float* src_sdf;   // map rows (N, V) or explicit rows (A, V)
  const float* src_w;
  int* grid;              // (GX, GY, GZ) scratch
  float* sdf;             // (X, Y, Z)
  float* weight;
  float* origin;          // (3,)
  int A, n_rows;
  int B, V, X, Y, Z, GX, GY, GZ;
  int half[3];            // dims // (2 B)
  float ahead, inv_voxel, voxel, truncation;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(kIndexThreads)
densify_index_kernel(const DensifyParams P) {
  __shared__ int s_ob[3];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // center = cam_pos + forward * ahead; world2block; - dims // (2 B)
      const float c = add(P.T_wc[4 * k + 3], mul(P.T_wc[4 * k + 2], P.ahead));
      const float q = mul(c, P.inv_voxel);
      const float v = truncf(add(q, q >= 0.0f ? 0.5f : -0.5f));
      const int ob = floor_div(__float2int_rz(v), P.B) - P.half[k];
      s_ob[k] = ob;
      P.origin[k] = mul(__int2float_rn(ob * P.B), P.voxel);
    }
  }
  const int cells = P.GX * P.GY * P.GZ;
  for (int c = threadIdx.x; c < cells; c += kIndexThreads) P.grid[c] = -1;
  __syncthreads();
  const int n = P.count ? min(max(*P.count, 0), P.A) : P.A;
  const int64_t ob0 = s_ob[0], ob1 = s_ob[1], ob2 = s_ob[2];
  for (int r = threadIdx.x; r < n; r += kIndexThreads) {
    int src;
    if (P.ptrs) {
      const int ptr = P.ptrs[r];
      if (ptr == -1) continue;                     // FREE_PTR
      src = min(max(ptr, 0), P.n_rows - 1);
    } else {
      if (!P.valid[r]) continue;
      src = r;
    }
    const int64_t b0 = P.blocks[3 * r] - ob0;
    const int64_t b1 = P.blocks[3 * r + 1] - ob1;
    const int64_t b2 = P.blocks[3 * r + 2] - ob2;
    if (b0 < 0 || b0 >= P.GX || b1 < 0 || b1 >= P.GY || b2 < 0 ||
        b2 >= P.GZ)
      continue;
    P.grid[(b0 * P.GY + b1) * P.GZ + b2] = src;
  }
}

// the value of cell (x, y, z): its block row's voxel, or truncation / 0
__device__ __forceinline__ void cell_value(const DensifyParams& P, int x,
                                           int y, int z, float& s,
                                           float& w) {
  const int bx = x / P.B, by = y / P.B, bz = z / P.B;
  const int row = __ldg(P.grid + (bx * P.GY + by) * P.GZ + bz);
  if (row < 0) {
    s = P.truncation;
    w = 0.0f;
    return;
  }
  const int lin = ((z - bz * P.B) * P.B + (y - by * P.B)) * P.B +
                  (x - bx * P.B);
  const int64_t at = static_cast<int64_t>(row) * P.V + lin;
  s = __ldg(P.src_sdf + at);
  w = __ldg(P.src_w + at);
}

template <bool kVec4>
__global__ void __launch_bounds__(kFillThreads)
densify_fill_kernel(const DensifyParams P) {
  const unsigned per = kVec4 ? 4u : 1u;
  const unsigned first = (blockIdx.x * kFillThreads + threadIdx.x) * per;
  const unsigned total = static_cast<unsigned>(P.X) * P.Y * P.Z;
  if (first >= total) return;
  const unsigned Z = P.Z, Y = P.Y;
  const unsigned z = first % Z;
  const unsigned xy = first / Z;
  const int y = static_cast<int>(xy % Y), x = static_cast<int>(xy / Y);
  if (kVec4) {
    float4 s4, w4;
    cell_value(P, x, y, z, s4.x, w4.x);
    cell_value(P, x, y, z + 1, s4.y, w4.y);
    cell_value(P, x, y, z + 2, s4.z, w4.z);
    cell_value(P, x, y, z + 3, s4.w, w4.w);
    reinterpret_cast<float4*>(P.sdf)[first / 4] = s4;
    reinterpret_cast<float4*>(P.weight)[first / 4] = w4;
  } else {
    float s, w;
    cell_value(P, x, y, static_cast<int>(z), s, w);
    P.sdf[first] = s;
    P.weight[first] = w;
  }
}

}  // namespace

// K11 on `stream`: rays (h, w, 3), T_wc (4, 4), the volume's sdf and
// weight (X, Y, Z), origin (3,) and voxel size (), all float32 on the
// device; out = depth (h w), points (h w 3), normals (h w 3) one after
// another; hit (h w) bytes.  ints: X, Y, Z, max_steps, gradient; floats:
// step_scale, min_step, coarse_step, near, far (float32 of the config).
extern "C" int raycast_march(const float* rays, const float* T_wc,
                             const float* sdf, const float* weight,
                             const float* origin, const float* voxel,
                             float* out, uint8_t* hit, int h, int w,
                             const int* ints, const float* floats,
                             void* stream) {
  MarchParams P = {};
  P.X = ints[0];
  P.Y = ints[1];
  P.Z = ints[2];
  P.max_steps = ints[3];
  P.gradient = ints[4];
  if (h < 0 || w < 0 || P.X < 2 || P.Y < 2 || P.Z < 2 || P.max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  const int64_t n = static_cast<int64_t>(h) * w;
  P.rays = rays;
  P.T_wc = T_wc;
  P.sdf = sdf;
  P.weight = weight;
  P.origin = origin;
  P.voxel = voxel;
  P.depth = out;
  P.points = out + n;
  P.normals = out + 4 * n;
  P.hit = hit;
  P.h = h;
  P.w = w;
  P.step_scale = floats[0];
  P.min_step = floats[1];
  P.coarse_step = floats[2];
  P.near_ = floats[3];
  P.far_ = floats[4];
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  march_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K12 on `stream`: the cache of rows [0, count) of the map (the local
// form: ptrs and count given, valid null; src the map's (n_rows, V) rows)
// or of A explicit rows (ptrs and count null, valid given; src (A, V)).
// grid: ceil(X / B) ceil(Y / B) ceil(Z / B) int32 of scratch; sdf and
// weight (X, Y, Z) and origin (3,) out.  ints: B, X, Y, Z; floats: ahead,
// 1 / voxel (float32), voxel, truncation.
extern "C" int densify_cache(const int* blocks, const int* ptrs,
                             const int* count, const uint8_t* valid,
                             const float* T_wc, const float* src_sdf,
                             const float* src_w, int* grid, float* sdf,
                             float* weight, float* origin, int A,
                             int n_rows, const int* ints,
                             const float* floats, void* stream) {
  DensifyParams P = {};
  P.B = ints[0];
  P.X = ints[1];
  P.Y = ints[2];
  P.Z = ints[3];
  if (A < 0 || P.B < 1 || P.B > 10 || P.X < 1 || P.Y < 1 || P.Z < 1 ||
      static_cast<int64_t>(P.X) * P.Y * P.Z > 0x7fffffffLL ||
      (ptrs && (count == nullptr || n_rows < 1)) ||
      (ptrs == nullptr && valid == nullptr && A > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  P.V = P.B * P.B * P.B;
  P.GX = (P.X + P.B - 1) / P.B;
  P.GY = (P.Y + P.B - 1) / P.B;
  P.GZ = (P.Z + P.B - 1) / P.B;
  P.half[0] = P.X / (2 * P.B);
  P.half[1] = P.Y / (2 * P.B);
  P.half[2] = P.Z / (2 * P.B);
  P.blocks = blocks;
  P.ptrs = ptrs;
  P.count = count;
  P.valid = valid;
  P.T_wc = T_wc;
  P.src_sdf = src_sdf;
  P.src_w = src_w;
  P.grid = grid;
  P.sdf = sdf;
  P.weight = weight;
  P.origin = origin;
  P.A = A;
  P.n_rows = n_rows;
  P.ahead = floats[0];
  P.inv_voxel = floats[1];
  P.voxel = floats[2];
  P.truncation = floats[3];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  densify_index_kernel<<<1, kIndexThreads, 0, s>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(P.X) * P.Y * P.Z;
  if (P.Z % 4 == 0) {
    const int64_t threads = total / 4;
    densify_fill_kernel<true>
        <<<static_cast<unsigned>((threads + kFillThreads - 1) / kFillThreads),
           kFillThreads, 0, s>>>(P);
  } else {
    densify_fill_kernel<false>
        <<<static_cast<unsigned>((total + kFillThreads - 1) / kFillThreads),
           kFillThreads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}
