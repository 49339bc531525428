// Dense TSDF fusion for Hopper (sm_90a), one kernel:
//
//   integrate_dense (K20): the Curless-Levoy update of every voxel of a
//     dense (X, Y, Z) volume from one metric depth map at a camera-to-world
//     pose: the voxel's world centre, the world -> camera transform (the
//     pose's inverse computed here, from the pose on the device), the
//     nearest pixel (round half to even), the depth under it, the sdf and
//     its depth-dependent truncation band, the validity test, the clamp,
//     the sample weight (depth falloff on or off), the running average and
//     the weight cap.  Replaces what XLA fused on the TPU in
//     voxelhashing_demo_tpu/ops/tsdf.py: integrate_dense (:80-117), with
//     voxel_world_positions (:53) and sample_weight (:63), and
//     geometry/se3.py inverse (:124) and geometry/camera.py
//     project_nearest (:67) as it calls them.
//
// No Pallas kernel; no PyTorch call computes it.
//
// One thread takes VPT neighbouring voxels along z (4, with 16-byte loads
// and stores of both arrays, where Z is a multiple of 4 and the four
// arrays lie on 16-byte boundaries; else 1), CTAs of 256 threads, one
// thread per VPT voxels of the whole volume: neighbouring threads read and
// write neighbouring 16-byte chunks, so every load and store of the volume
// is coalesced.  One voxel a thread for every input was 1.11 x the time on
// the 160 x 128 x 160 grid and 1.28 x on a 512^3 volume
// (chip_dense_compare.py, H100 80GB HBM3 at 700 W): a thread then holds a
// quarter of the bytes in flight.  The depth image (1.2 MB at 640x480) is
// read through the read-only path only under voxels inside the image; it
// stays in L2.  The function returns a new volume (the plain version's
// contract): every voxel of both outputs is written, the old values where
// the voxel takes no sample.
//
// What bounds it: bytes.  Each voxel's sdf and weight read once and
// written once, 16 B a voxel (52.4 MB on the 160 x 128 x 160 grid, 15.6 us
// at 3.35 TB/s; 2.1 GB on a 512^3 volume, 641 us), plus the depth sectors
// the voxels in view reach; ~30 float operations a voxel (~50 in view)
// are far below the card's rate.
//
// Rounding: every product, sum and quotient of the plain version
// (ops/tsdf.py integrate_dense_reference) on the card is written with the
// round-to-nearest intrinsics, in its order, so nvcc contracts nothing that
// eager PyTorch rounds twice: the voxel centre origin + i * voxel_size
// (two roundings, the voxel size a 0-d tensor); se3.inverse's einsum as a
// matrix-vector product, fma(a1, b1, a0 b0) + a2 b2; the (N, 3) @ (3, 3)
// product fma(a2, b2, fma(a1, b1, a0 b0)), then + t; x / z * fx + cx
// (three roundings); torch.round as rintf (half to even); trunc as
// trunc_scale * depth, then + truncation; sample_weight's chain ((d -
// depth_min) * recip(depth_max - depth_min), clamped, then
// float32(weight_sample * 1.5) * (1 - d01), floored at 1); the update's
// two products, their sum and one IEEE divide by max(w_sum, 1e-12); the
// cap min(w_sum, max_weight); Python doubles as their float32, in
// comparisons too; torch.clamp / maximum / minimum NaN-propagating
// (chip_rounding_probe.py `dense_ops`).  So the kernel equals its plain
// version on the card bit for bit; on the CPU the plain version rounds as
// the CPU does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp / maximum / minimum on the card: a NaN operand wins
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// a0 b0 + a1 b1 + a2 b2 as the card's (N, 3) @ (3, 3) matmul sums it
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

constexpr int kThreads = 256;

struct DenseParams {
  const float* sdf;       // (X, Y, Z) the volume read
  const float* weight;    // (X, Y, Z)
  float* sdf_out;         // (X, Y, Z) the new volume
  float* weight_out;      // (X, Y, Z)
  const float* depth;     // (H, W) metric depth
  const float* T_wc;      // (4, 4) row-major camera-to-world
  const float* origin;    // (3,) world position of voxel (0, 0, 0)
  const float* voxel;     // () voxel size
  int X, Y, Z, H, W;
  int falloff;            // FusionConfig.depth_weight_falloff
  int64_t threads;        // voxels / VPT
  // float32 of the plain version's Python doubles: camera, truncation and
  // its depth scale, weight_sample, weight_sample * 1.5, depth_min,
  // recip(depth_max - depth_min), max_weight
  float fx, fy, cx, cy, trunc, trunc_scale, w_sample, w_sample15, dmin,
      rdrange, max_weight;
};

// world -> camera of se3.apply(se3.inverse(T_wc), p): the voxel grid's
// origin and size beside it
struct Frame {
  float R[3][3];      // T_wc's rotation: pc_j = sum_i p_i R[i][j] + t_cw[j]
  float t_cw[3];
  float O[3];
  float vox;
};

__device__ __forceinline__ Frame load_frame(const DenseParams& P) {
  Frame F;
  float t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 3; ++j) F.R[k][j] = __ldg(P.T_wc + 4 * k + j);
    t[k] = __ldg(P.T_wc + 4 * k + 3);
    F.O[k] = __ldg(P.origin + k);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    F.t_cw[j] = -dot_inv(F.R[0][j], t[0], F.R[1][j], t[1], F.R[2][j], t[2]);
  F.vox = __ldg(P.voxel);
  return F;
}

// tsdf.sample_weight of one depth
__device__ __forceinline__ float sample_weight(const DenseParams& P, float d) {
  if (!P.falloff) return P.w_sample;
  const float d01 = min_nan(max_nan(mul(sub(d, P.dmin), P.rdrange), 0.0f),
                            1.0f);
  return max_nan(mul(P.w_sample15, sub(1.0f, d01)), 1.0f);
}

// One voxel's update: (s, w) hold its old values and take its new ones.
// w0, w1 the world x and y of its centre (shared along the thread's z run)
__device__ __forceinline__ void fuse_voxel(const DenseParams& P,
                                           const Frame& F, float w0, float w1,
                                           int z, float& s, float& w) {
  const float w2 = add(F.O[2], mul(static_cast<float>(z), F.vox));
  const float x = add(dot_mm(w0, F.R[0][0], w1, F.R[1][0], w2, F.R[2][0]),
                      F.t_cw[0]);
  const float y = add(dot_mm(w0, F.R[0][1], w1, F.R[1][1], w2, F.R[2][1]),
                      F.t_cw[1]);
  const float zc = add(dot_mm(w0, F.R[0][2], w1, F.R[1][2], w2, F.R[2][2]),
                       F.t_cw[2]);
  // camera.project_nearest
  const float safe_z = fabsf(zc) > 1e-12f ? zc : 1e-12f;
  const float u = add(mul(dvd(x, safe_z), P.fx), P.cx);
  const float v = add(mul(dvd(y, safe_z), P.fy), P.cy);
  const bool in_img = zc > 0.0f && u >= 0.0f &&
                      u <= static_cast<float>(P.W - 1) && v >= 0.0f &&
                      v <= static_cast<float>(P.H - 1);
  if (!in_img) return;
  // u in [0, W - 1] puts rint(u) there too: the pixel needs no clamp
  const int ui = static_cast<int>(rintf(u));
  const int vi = static_cast<int>(rintf(v));
  const float d = __ldg(P.depth + static_cast<int64_t>(vi) * P.W + ui);
  const float sdf = sub(d, zc);
  const float trunc = add(mul(d, P.trunc_scale), P.trunc);
  if (!(d > 0.0f && sdf > -trunc)) return;
  const float sc = min_nan(max_nan(sdf, -trunc), trunc);
  const float w_new = sample_weight(P, d);
  const float w_sum = add(w, w_new);
  if (w_sum > 0.0f)
    s = dvd(add(mul(s, w), mul(sc, w_new)), max_nan(w_sum, 1e-12f));
  w = min_nan(w_sum, P.max_weight);
}

template <int VPT>
__global__ void __launch_bounds__(kThreads)
integrate_dense_kernel(const __grid_constant__ DenseParams P) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= P.threads) return;
  const int64_t i0 = t * VPT;
  // the run's old values first: they depend on nothing else, so their
  // round trip overlaps the pose and the transform
  float s[VPT], w[VPT];
  if constexpr (VPT == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(P.sdf + i0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(P.weight + i0));
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    w[0] = b.x; w[1] = b.y; w[2] = b.z; w[3] = b.w;
  } else {
    s[0] = __ldg(P.sdf + i0);
    w[0] = __ldg(P.weight + i0);
  }
  const int row = static_cast<int>(i0 / P.Z);
  const int z0 = static_cast<int>(i0 - static_cast<int64_t>(row) * P.Z);
  const int xi = row / P.Y;
  const int yi = row - xi * P.Y;
  const Frame F = load_frame(P);
  // voxel_world_positions: origin + index * voxel_size
  const float w0 = add(F.O[0], mul(static_cast<float>(xi), F.vox));
  const float w1 = add(F.O[1], mul(static_cast<float>(yi), F.vox));
#pragma unroll
  for (int k = 0; k < VPT; ++k) fuse_voxel(P, F, w0, w1, z0 + k, s[k], w[k]);
  if constexpr (VPT == 4) {
    *reinterpret_cast<float4*>(P.sdf_out + i0) =
        make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(P.weight_out + i0) =
        make_float4(w[0], w[1], w[2], w[3]);
  } else {
    P.sdf_out[i0] = s[0];
    P.weight_out[i0] = w[0];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// K20.  sdf, weight: the (X, Y, Z) volume read; depth: (H, W) metric
// depth; T_wc: (4, 4); origin: (3,); voxel: () voxel size; sdf_out,
// weight_out: the new (X, Y, Z) volume, which must not overlap the inputs;
// ints: X, Y, Z, H, W, falloff; floats: fx, fy, cx, cy, truncation,
// trunc_scale, weight_sample, weight_sample * 1.5, depth_min,
// recip(depth_max - depth_min), max_weight (float32 of the plain
// version's doubles).  Returns the launch's CUDA error (0: launched).
extern "C" int integrate_dense(const float* sdf, const float* weight,
                               const float* depth, const float* T_wc,
                               const float* origin, const float* voxel,
                               float* sdf_out, float* weight_out,
                               const int* ints, const float* floats,
                               void* stream) {
  DenseParams P = {};
  P.X = ints[0];
  P.Y = ints[1];
  P.Z = ints[2];
  P.H = ints[3];
  P.W = ints[4];
  P.falloff = ints[5];
  const int64_t n = static_cast<int64_t>(P.X) * P.Y * P.Z;
  if (P.X < 1 || P.Y < 1 || P.Z < 1 || P.H < 1 || P.W < 1 ||
      n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  P.sdf = sdf;
  P.weight = weight;
  P.sdf_out = sdf_out;
  P.weight_out = weight_out;
  P.depth = depth;
  P.T_wc = T_wc;
  P.origin = origin;
  P.voxel = voxel;
  P.fx = floats[0];
  P.fy = floats[1];
  P.cx = floats[2];
  P.cy = floats[3];
  P.trunc = floats[4];
  P.trunc_scale = floats[5];
  P.w_sample = floats[6];
  P.w_sample15 = floats[7];
  P.dmin = floats[8];
  P.rdrange = floats[9];
  P.max_weight = floats[10];
  const bool vec = P.Z % 4 == 0 && aligned16(sdf) && aligned16(weight) &&
                   aligned16(sdf_out) && aligned16(weight_out);
  P.threads = vec ? n / 4 : n;
  const unsigned grid =
      static_cast<unsigned>((P.threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    integrate_dense_kernel<4><<<grid, kThreads, 0, s>>>(P);
  else
    integrate_dense_kernel<1><<<grid, kThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
