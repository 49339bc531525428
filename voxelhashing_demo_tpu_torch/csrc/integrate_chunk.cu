// Integrate-chunk kernel, for Hopper (sm_90a): a depth gather and a
// simplified Curless-Levoy fuse, one voxel a thread.  flatw is (3, n)
// float32: the flat pixel index (as a float), the voxel's depth z, and a
// validity flag (> 0 = valid).  Per voxel:
//   d    = depth.flat[int(flat)]          (truncated, as astype(int32))
//   sdf  = d - z
//   ok   = valid & (d > 0) & (sdf > -trunc)
//   sdf  = clip(sdf, -trunc, trunc)
//   tsdf = ok ? (t * w + sdf * 1) / max(w + 1, 1e-12) : t
//   w    = min(w + (ok ? 1 : 0), 255)
//
// Replaces the TPU probe kernel tools/exp_pallas_integrate.py
// pallas_integrate (pallas_call :209, body kernel_integrate :178), which
// held the depth image and the whole chunk in VMEM.
//
// Rounding: every product, sum and the quotient are written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// so nvcc cannot contract them into an FMA and the kernel rounds where the
// plain PyTorch version (ops/integrate_chunk.integrate_chunk_reference,
// one rounding per operation) rounds: the two agree bit for bit.  The
// minimum and maximum keep a NaN, as torch.clamp does.
//
// Out of range: a flat index outside [0, n_img) reads NaN, so the voxel is
// not integrated (tsdf and weight pass through); the plain version does the
// same.  The index must be finite and within int32.
//
// Bound: bytes, and few: flatw (12 B a voxel), the tsdf and weight rows in
// and out (16 B a voxel) and the 32-byte depth sectors that the valid
// voxels' indices reach: about 2 MB for the probe's 128 x 512 voxels,
// below a launch at 3.35 TB/s.
//
// Design: one thread per voxel, 256 threads a CTA; every stream is
// coalesced and the depth read goes through the read-only path (__ldg).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
integrate_chunk_kernel(const float* __restrict__ depth,
                       const float* __restrict__ flatw,
                       const float* __restrict__ tsdf,
                       const float* __restrict__ weight,
                       float* __restrict__ tsdf_out,
                       float* __restrict__ weight_out,
                       int64_t n_img, int64_t n, float trunc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int f = __float2int_rz(__ldg(flatw + i));
  const float z = __ldg(flatw + n + i);
  const bool valid = __ldg(flatw + 2 * n + i) > 0.0f;
  // an invalid voxel passes through whatever its depth: no read
  const float d = (valid && f >= 0 && f < n_img)
                      ? __ldg(depth + f) : __int_as_float(0x7fc00000);
  const float t = __ldg(tsdf + i);
  const float w = __ldg(weight + i);
  float sdf = __fsub_rn(d, z);
  const bool ok = valid && d > 0.0f && sdf > -trunc;
  float t_new = t;
  float w_sum;
  if (ok) {
    sdf = fminf(fmaxf(sdf, -trunc), trunc);   // sdf is a number here
    w_sum = __fadd_rn(w, 1.0f);
    const float num = __fadd_rn(__fmul_rn(t, w), __fmul_rn(sdf, 1.0f));
    const float den = w_sum < 1e-12f ? 1e-12f : w_sum;
    t_new = __fdiv_rn(num, den);
  } else {
    w_sum = __fadd_rn(w, 0.0f);
  }
  tsdf_out[i] = t_new;
  weight_out[i] = w_sum > 255.0f ? 255.0f : w_sum;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on ``stream`` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int integrate_chunk(const float* depth, const float* flatw,
                               const float* tsdf, const float* weight,
                               float* tsdf_out, float* weight_out,
                               int64_t n_img, int64_t n, float trunc,
                               void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  integrate_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      depth, flatw, tsdf, weight, tsdf_out, weight_out, n_img, n, trunc);
  return static_cast<int>(cudaGetLastError());
}
