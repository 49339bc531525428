// Point-to-plane ICP, one Gauss-Newton iteration as two kernels, for Hopper
// (sm_90a):
//
//   K4a icp_partials: projective association of every source pixel under
//     the device transform T and its share of the 6x6 normal equations.
//     Per pixel: p = R v + t, project (round half to even), clamp and
//     gather the 8-byte packed target [depth, oct-normal bits], decode the
//     normal, rebuild the target vertex from the pixel's ray, residual
//     r = (p - p_t) . n_t, the five gates (source valid, in image, target
//     valid, normals agree, |r| < dist_thresh), the Huber weight
//     w = valid * min(1, delta / max(|r|, 1e-12)), J = [n_t, p x n_t] * sqrt(w)
//     and rw = r * sqrt(w).  Each CTA sums its pixels' 29 terms (21 upper-
//     triangle JTJ entries row by row, 6 JTr, error, count) and writes them
//     to column blockIdx.x of a (29, CTAs) partials buffer.  Score mode
//     writes 2 sums instead: the clamped |r| where the pixel has a target
//     (the clamp elsewhere) and the count, over source-valid pixels.
//   K4b icp_solve_update: one CTA sums the partials over the CTAs, then
//     (solve mode) forms A = JTJ + damping I (+ I when count <= 6), factors
//     it by Cholesky, solves A delta = -JTr (no update when a pivot is not
//     positive or delta is not finite), and writes T <- exp(delta) T and
//     the loop state; (system / score mode) writes the sums out.
//
// Replaces what XLA fused on the TPU inside the jitted while_loop of
// voxelhashing_demo_tpu/ops/icp.py: associate (:136), build_normal_system
// (:196), solve_normal_system (:233) and the se(3) update of icp_align's
// body (:282-286), and alignment_score_sums (:312) in score mode.  The
// loop itself becomes a fixed sequence of (K4a, K4b) launches, max_iters
// of each, that exits early on the device: K4b sets the done flag
// (it >= max_iters or dnorm <= tol2) and both kernels return at entry once
// it is set, so the host never reads the loop state.
//
// Rounding: every product, sum and quotient that the plain PyTorch version
// (ops/icp.py, one rounding per operation) computes is written with the
// round-to-nearest intrinsics, in the plain version's order, so nvcc cannot
// contract them into FMAs.  Projection: u = p.x / z * fx + cx, then
// __float2int_rn (round half to even, saturating; NaN gives 0), and the
// in-image test reads that same integer.  The target ray is
// (u - cx) * (1 / fx) with 1 / fx rounded to float32 on the host, as XLA
// compiles a constant division; delta / |r| stays a true division.  The
// bf16 halves of the normal bits are decoded with 32-bit masks.  Sums
// reduce in a fixed tree (warp shuffles, then the CTA's warps, then the
// CTAs in order): no float atomics, so a run repeats bit for bit.
// ops/icp._partials_reference and _solve_update_reference compute the
// same in the same order.
//
// Bound: bytes.  An iteration reads 24 bytes a source pixel (vertex and
// normal) and gathers 8 bytes of target for each pixel that projects into
// the image: 2.5 MB at the flagship's 320x240 levels, 0.73 us at
// 3.35 TB/s, under the launch floor (about 1 us); the arithmetic is ~150
// operations a pixel.  So an iteration's least time is its two launches.
// Design: one pixel a thread, 256 threads a CTA, a shared-memory tree over
// the CTA's warps; K4b is one CTA of 32 warps, warp s summing sum s over
// the CTAs, and one thread doing the 6x6 solve and the update.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // K4a: pixels a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;                  // 21 JTJ, 6 JTr, error, count
constexpr int kScoreSums = 2;              // num, den
constexpr int kSolveThreads = 1024;        // K4b: a warp per sum

// what K4b does after summing the partials
constexpr int kModeSolve = 0;
constexpr int kModeSystem = 1;
constexpr int kModeScore = 2;

struct Camera {
  float fx, fy, cx, cy, rfx, rfy;
  int width, height;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// sign() that maps 0 (and -0) to +1
__device__ __forceinline__ float sign_nz(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// a + b + c as the plain version sums a last axis of three
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, b), c);
}

// row i of R (row-major 4x4 T) times (x, y, z)
__device__ __forceinline__ float rot_row(const float* T, int i, float x, float y,
                                         float z) {
  return sum3(mul(T[4 * i], x), mul(T[4 * i + 1], y), mul(T[4 * i + 2], z));
}

// The pixel's 29 system terms, given its association.
__device__ __forceinline__ void pixel_system(
    const float* __restrict__ normals, const float* T, int i, float px,
    float py, float pz, float ntx, float nty, float ntz, float r,
    bool matched, float normal_thresh, float dist_thresh, float huber,
    float* out) {
  const float sx = __ldg(normals + 3 * i), sy = __ldg(normals + 3 * i + 1),
              sz = __ldg(normals + 3 * i + 2);
  const float nsx = rot_row(T, 0, sx, sy, sz);
  const float nsy = rot_row(T, 1, sx, sy, sz);
  const float nsz = rot_row(T, 2, sx, sy, sz);
  const bool valid = matched &&
                     sum3(mul(nsx, ntx), mul(nsy, nty), mul(nsz, ntz)) >
                         normal_thresh &&
                     fabsf(r) < dist_thresh;
  float w = valid ? 1.0f : 0.0f;
  if (huber > 0.0f) {
    const float ar = fabsf(r);
    const float q = dvd(huber, ar < 1e-12f ? 1e-12f : ar);
    w = mul(w, q > 1.0f ? 1.0f : q);
  }
  const float ws = __fsqrt_rn(w);
  float J[6];
  J[0] = mul(ntx, ws);
  J[1] = mul(nty, ws);
  J[2] = mul(ntz, ws);
  J[3] = mul(sub(mul(py, ntz), mul(pz, nty)), ws);
  J[4] = mul(sub(mul(pz, ntx), mul(px, ntz)), ws);
  J[5] = mul(sub(mul(px, nty), mul(py, ntx)), ws);
  const float rw = mul(r, ws);
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) out[k++] = mul(J[a], J[b]);
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) out[21 + a] = mul(J[a], rw);
  out[27] = mul(rw, rw);
  out[28] = valid ? 1.0f : 0.0f;
}

// The per-pixel association; fills the pixel's terms.  kScore: num, den.
template <bool kScore>
__device__ __forceinline__ void pixel_terms(const float* __restrict__ verts,
                            const float* __restrict__ normals,
                            const float* __restrict__ tgt, const Camera& cam,
                            const float* T, int i, float normal_thresh,
                            float dist_thresh, float huber, float* out) {
  const float vx = __ldg(verts + 3 * i), vy = __ldg(verts + 3 * i + 1),
              vz = __ldg(verts + 3 * i + 2);
  const float px = add(rot_row(T, 0, vx, vy, vz), T[3]);
  const float py = add(rot_row(T, 1, vx, vy, vz), T[7]);
  const float pz = add(rot_row(T, 2, vx, vy, vz), T[11]);

  // project (camera.project + project_nearest)
  const float safe_z = fabsf(pz) > 1e-12f ? pz : 1e-12f;
  const float u = add(mul(dvd(px, safe_z), cam.fx), cam.cx);
  const float v = add(mul(dvd(py, safe_z), cam.fy), cam.cy);
  const int iu = __float2int_rn(u);
  const int iv = __float2int_rn(v);
  const bool in_image = pz > 0.0f && u >= 0.0f &&
                        u <= static_cast<float>(cam.width - 1) && v >= 0.0f &&
                        v <= static_cast<float>(cam.height - 1) && iu >= 0 &&
                        iu < cam.width && iv >= 0 && iv < cam.height;
  const int uc = min(max(iu, 0), cam.width - 1);
  const int vc = min(max(iv, 0), cam.height - 1);
  const float2 g = __ldg(reinterpret_cast<const float2*>(tgt) +
                         (static_cast<int64_t>(vc) * cam.width + uc));
  const float d_t = g.x;

  // oct-normal decode: x in the low bf16 half, y in the high half
  const uint32_t bits = __float_as_uint(g.y);
  float ox = __uint_as_float(bits << 16);
  float oy = __uint_as_float(bits & 0xFFFF0000u);
  const float oz = sub(sub(1.0f, fabsf(ox)), fabsf(oy));
  if (oz < 0.0f) {
    const float fx = mul(sub(1.0f, fabsf(oy)), sign_nz(ox));
    const float fy = mul(sub(1.0f, fabsf(ox)), sign_nz(oy));
    ox = fx;
    oy = fy;
  }
  const float ln = __fsqrt_rn(sum3(mul(ox, ox), mul(oy, oy), mul(oz, oz)));
  const float lc = ln < 1e-12f ? 1e-12f : ln;
  const float ntx = dvd(ox, lc), nty = dvd(oy, lc), ntz = dvd(oz, lc);

  // target vertex = ray(u, v) * depth
  const float ptx = mul(mul(sub(static_cast<float>(uc), cam.cx), cam.rfx), d_t);
  const float pty = mul(mul(sub(static_cast<float>(vc), cam.cy), cam.rfy), d_t);
  const float r = sum3(mul(sub(px, ptx), ntx), mul(sub(py, pty), nty),
                       mul(sub(pz, d_t), ntz));
  const bool src_valid = vz != 0.0f;

  if constexpr (kScore) {
    const bool matched = in_image && d_t > 0.0f;
    const float ar = fabsf(r);
    const float pen = matched ? (ar > dist_thresh ? dist_thresh : ar)
                              : dist_thresh;
    out[0] = src_valid ? pen : 0.0f;
    out[1] = src_valid ? 1.0f : 0.0f;
  } else {
    pixel_system(normals, T, i, px, py, pz, ntx, nty, ntz, r,
                 src_valid && in_image && d_t > 0.0f, normal_thresh,
                 dist_thresh, huber, out);
  }
}

template <int S>
__device__ __forceinline__ void warp_tree(float* s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) s[k] = add(s[k], __shfl_down_sync(0xffffffffu, s[k], off));
  }
}

template <bool kScore>
__global__ void __launch_bounds__(kThreads)
icp_partials_kernel(const float* __restrict__ verts,
                    const float* __restrict__ normals, int n,
                    const float* __restrict__ tgt, Camera cam,
                    const float* __restrict__ T_dev,
                    const int* __restrict__ istate, float normal_thresh,
                    float dist_thresh, float huber,
                    float* __restrict__ partials) {
  constexpr int S = kScore ? kScoreSums : kSums;
  if (istate != nullptr && istate[1] != 0) return;   // the loop is done
  __shared__ float warp_sums[kWarps][S];
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = __ldg(T_dev + k);
  float s[S];
#pragma unroll
  for (int k = 0; k < S; ++k) s[k] = 0.0f;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    pixel_terms<kScore>(verts, normals, tgt, cam, T, i, normal_thresh,
                        dist_thresh, huber, s);
  }
  warp_tree<S>(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) warp_sums[warp][k] = s[k];
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int k = 0; k < S; ++k) s[k] = lane < kWarps ? warp_sums[lane][k] : 0.0f;
#pragma unroll
  for (int off = kWarps / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) s[k] = add(s[k], __shfl_down_sync(0xffffffffu, s[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) partials[k * gridDim.x + blockIdx.x] = s[k];
  }
}

// exp(xi) for xi = [v, w] (geometry/se3.exp with _sinc_factors), as a 3x4
__device__ void se3_exp(const float* xi, float E[3][4]) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = sum3(mul(w0, w0), mul(w1, w1), mul(w2, w2));
  const float theta = __fsqrt_rn(add(theta2, 1e-16f));
  const bool small = theta2 < 1e-2f;
  const float t4 = mul(theta2, theta2);
  const float A = small ? add(sub(1.0f, mul(theta2, 1.0f / 6.0f)),
                              mul(t4, 1.0f / 120.0f))
                        : dvd(sinf(theta), theta);
  const float half = mul(0.5f, theta);
  const float s_half = dvd(sinf(half), half);
  const float B = mul(mul(0.5f, s_half), s_half);
  const float C = small ? add(sub(1.0f / 6.0f, mul(theta2, 1.0f / 120.0f)),
                              mul(t4, 1.0f / 5040.0f))
                        : dvd(sub(1.0f, A), theta2);
  const float K[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float K2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      K2[i][j] = sum3(mul(K[i][0], K[0][j]), mul(K[i][1], K[1][j]),
                      mul(K[i][2], K[2][j]));
  float V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      E[i][j] = add(add(I, mul(A, K[i][j])), mul(B, K2[i][j]));
      V[i][j] = add(add(I, mul(B, K[i][j])), mul(C, K2[i][j]));
    }
  for (int i = 0; i < 3; ++i)
    E[i][3] = sum3(mul(V[i][0], xi[0]), mul(V[i][1], xi[1]), mul(V[i][2], xi[2]));
}

// The damped Cholesky solve of solve_normal_system: delta, or 0 when a
// pivot is not positive or delta is not finite.
__device__ void solve6(const float* sums, float damping, float* delta) {
  float A[6][6];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      A[a][b] = sums[k];
      A[b][a] = sums[k];
      ++k;
    }
  const float extra = sums[28] > 6.0f ? 0.0f : 1.0f;
  for (int a = 0; a < 6; ++a) A[a][a] = add(add(A[a][a], damping), extra);
  float L[6][6];
  bool ok = true;
  for (int j = 0; j < 6 && ok; ++j) {
    float d = A[j][j];
    for (int q = 0; q < j; ++q) d = sub(d, mul(L[j][q], L[j][q]));
    if (!(d > 0.0f)) {
      ok = false;
      break;
    }
    L[j][j] = __fsqrt_rn(d);
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
      for (int q = 0; q < j; ++q) t = sub(t, mul(L[i][q], L[j][q]));
      L[i][j] = dvd(t, L[j][j]);
    }
  }
  float y[6];
  if (ok) {
    for (int i = 0; i < 6; ++i) {
      float t = -sums[21 + i];
      for (int q = 0; q < i; ++q) t = sub(t, mul(L[i][q], y[q]));
      y[i] = dvd(t, L[i][i]);
    }
    for (int i = 5; i >= 0; --i) {
      float t = y[i];
      for (int q = i + 1; q < 6; ++q) t = sub(t, mul(L[q][i], delta[q]));
      delta[i] = dvd(t, L[i][i]);
    }
    for (int i = 0; i < 6; ++i) ok = ok && isfinite(delta[i]);
  }
  if (!ok)
    for (int i = 0; i < 6; ++i) delta[i] = 0.0f;
}

__global__ void __launch_bounds__(kSolveThreads)
icp_solve_update_kernel(const float* __restrict__ partials, int n_cta,
                        int n_sums, int mode, float* __restrict__ T,
                        int* __restrict__ istate, float* __restrict__ fstate,
                        float* __restrict__ out, float damping, float tol2,
                        int max_iters) {
  if (mode == kModeSolve && istate[1] != 0) return;   // the loop is done
  __shared__ float sums[kSums];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < n_sums) {
    // sum warp's partials over the CTAs: lane l takes CTAs l, l + 32, ...
    float acc = 0.0f;
    const float* row = partials + static_cast<int64_t>(warp) * n_cta;
    for (int c = lane; c < n_cta; c += 32) acc = add(acc, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = add(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) sums[warp] = acc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (mode == kModeScore) {
    out[0] = sums[0];
    out[1] = sums[1];
    return;
  }
  float JTJ[36];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      JTJ[6 * a + b] = sums[k];
      JTJ[6 * b + a] = sums[k];
      ++k;
    }
  if (mode == kModeSystem) {
    for (int q = 0; q < 36; ++q) out[q] = JTJ[q];
    for (int q = 0; q < 8; ++q) out[36 + q] = sums[21 + q];
    return;
  }
  float delta[6];
  solve6(sums, damping, delta);
  float E[3][4];
  se3_exp(delta, E);
  float Tn[12];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = add(sum3(mul(E[i][0], T[j]), mul(E[i][1], T[4 + j]),
                               mul(E[i][2], T[8 + j])),
                          mul(E[i][3], T[12 + j]));
  // row 3 of exp(delta) is [0, 0, 0, 1]: T's bottom row stays
  for (int q = 0; q < 12; ++q) T[q] = Tn[q];
  float dnorm = 0.0f;
  for (int q = 0; q < 6; ++q) dnorm = add(dnorm, mul(delta[q], delta[q]));
  const int it = istate[0] + 1;
  const float count = sums[28];
  fstate[0] = dnorm;
  fstate[1] = dvd(sums[27], count < 1.0f ? 1.0f : count);
  fstate[2] = count;
  for (int q = 0; q < 36; ++q) fstate[3 + q] = JTJ[q];
  istate[0] = it;
  istate[1] = (it < max_iters && dnorm > tol2) ? 0 : 1;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns cudaGetLastError() as an int (0 = launched).

// K4a.  verts, normals: (n, 3) float32; tgt: (height, width, 2) float32,
// 8-byte aligned; T: (4, 4) float32 on the device; istate: the loop's
// (it, done) int32 or null (no done test); score != 0: the score sums.
// partials: (29 or 2, ceil(n / 256)) float32.
extern "C" int icp_partials(const float* verts, const float* normals, int n,
                            const float* tgt, int width, int height, float fx,
                            float fy, float cx, float cy, float rfx, float rfy,
                            const float* T, const int* istate,
                            float normal_thresh, float dist_thresh,
                            float huber, int score, float* partials,
                            void* stream) {
  if (n <= 0) return 0;
  const Camera cam{fx, fy, cx, cy, rfx, rfy, width, height};
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (score) {
    icp_partials_kernel<true><<<blocks, kThreads, 0, s>>>(
        verts, normals, n, tgt, cam, T, istate, normal_thresh, dist_thresh,
        huber, partials);
  } else {
    icp_partials_kernel<false><<<blocks, kThreads, 0, s>>>(
        verts, normals, n, tgt, cam, T, istate, normal_thresh, dist_thresh,
        huber, partials);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4b.  partials: (n_sums, n_cta) float32; mode 0 (solve): T (4, 4),
// istate (it, done) int32 and fstate (dnorm, err, count, JTJ) float32
// updated in place, out unused; mode 1 (system): out (44,) = JTJ (36),
// JTr (6), error, count; mode 2 (score): out (2,) = num, den.
extern "C" int icp_solve_update(const float* partials, int n_cta, int n_sums,
                                int mode, float* T, int* istate, float* fstate,
                                float* out, float damping, float tol2,
                                int max_iters, void* stream) {
  if (n_sums < 1 || n_sums > kSums) return static_cast<int>(cudaErrorInvalidValue);
  icp_solve_update_kernel<<<1, kSolveThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      partials, n_cta, n_sums, mode, T, istate, fstate, out, damping, tol2,
      max_iters);
  return static_cast<int>(cudaGetLastError());
}
