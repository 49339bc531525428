// Point-to-plane ICP for Hopper (sm_90a): one cooperative kernel runs a
// whole pyramid level's Gauss-Newton loop for C candidates.  Two entry
// points, one kernel template:
//
//   icp_gn_level (K4): the loop.  C candidates (C = 2 when the coarsest
//     level races an identity start against the motion prior, the batch
//     size for the pair-ICP batch, 1 elsewhere) run side by side, each
//     from its own start transform against its own packed target.  With
//     race = 1 (C = 2) the kernel also scores both final transforms and
//     keeps the better one.
//   icp_sums (K4s): one pass of the loop's association under a given T:
//     system mode gives the 6x6 normal equations (JTJ, JTr, error, count:
//     normal_system, which the sharded level sums over ranks), score mode
//     the alignment score sums (num, den).
//
// Replaces what XLA fused on the TPU inside the jitted while_loop of
// voxelhashing_demo_tpu/ops/icp.py: associate (:136), build_normal_system
// (:196), solve_normal_system (:233), icp_align's while_loop (:252-298),
// alignment_score_sums (:312), pick_by_score (:358) and the raced coarsest
// level of icp_align_pyramid (:394).  No Pallas kernel; no PyTorch call
// computes any of it.
//
// One iteration, per pixel: p = R v + t, project (round half to even),
// clamp and gather the 8-byte packed target [depth, oct-normal bits],
// decode the normal, rebuild the target vertex from the pixel's ray,
// residual r = (p - p_t) . n_t, the five gates (source valid, in image,
// target valid, normals agree, |r| < dist_thresh), the Huber weight
// w = valid * min(1, delta / max(|r|, 1e-12)), J = [n_t, p x n_t] * sqrt(w)
// and rw = r * sqrt(w); 29 sums (21 upper-triangle JTJ entries row by row,
// 6 JTr, error, count).  Then A = JTJ + damping I (+ I when count <= 6),
// its Cholesky factor, A delta = -JTr (no update when a pivot is not
// positive or delta is not finite), T <- exp(delta) T, and the done test
// of the JAX loop: it >= max_iters or |delta|^2 <= tol2.
//
// Grid (a function of the pixel count n and C alone, never of the card, so
// the sums' order and the result are the same on any card and the CPU
// reference reproduces them): blockIdx.y = candidate, and
//   CTAs a candidate = min(ceil(n / 256), 128, max(1, 256 / C)),
// 256 threads each.  Thread g = 256 * blockIdx.x + threadIdx.x owns pixels
// g, g + S, g + 2 S, ... (S = 256 * CTAs): 1 at 160x120, 2-3 at 320x240.
// The launch is cooperative (cudaLaunchAttributeCooperative); it is
// refused, and the entry point returns an error, when the grid cannot be
// co-resident (occupancy x SMs); __launch_bounds__(256, 2) keeps two CTAs
// an SM possible, so the 256-CTA ceiling fits a 132-SM H100.  Nothing falls
// back.
//
// Source residency: a thread loads its first 3 pixels' vertex and normal
// once per level into registers (pixels past the third, which only sizes
// above the flagship's levels have, are read again each iteration).  Only
// the 8-byte target gather depends on T; the target (0.15-2.4 MB) stays in
// the 50 MB L2.
//
// One iteration: each thread sums its pixels' 29 terms serially in
// registers; the CTA transposes them through shared memory (red[29][256]):
// warp w takes sums w, w + 8, ..., lane l adds threads l, l + 32, ...,
// l + 224 in order, then a 5-step shuffle-down tree (one tree a sum, not a
// tree a pixel).  Each CTA writes its column of a double-buffered
// (2, C, 29, CTAs) partials buffer, then one grid barrier.  Every CTA of a
// candidate then sums that candidate's partials over the CTAs
// (lane l: CTAs l, l + 32, ... in order, then the tree) redundantly, solves
// and updates T in shared memory: no second barrier.  Double buffering is
// safe: a CTA that writes buffer i % 2 at iteration i + 2 has passed
// iteration i + 1's barrier, which every other CTA reached only after it
// had read buffer i % 2 at iteration i.  A warp issues all its loads of
// the partials before its first add (the L2's latency once, not once a
// CTA).  The done flags travel the same way: CTA 0 of each candidate
// writes its flag into flags[i % 2][c] before the barrier, thread k of
// every CTA reads flag k after it, beside the partials' loads, and the CTA
// ANDs them (__syncthreads_and), so every CTA leaves the loop at the same
// barrier.  A candidate that is done is frozen
// (its T, iters, error, count and JTJ stay); the kernel returns once every
// candidate is done (C = 1: right after its last update).
//
// The solve, by warp 0: a right-looking Cholesky with lane e < 21 on entry
// (i, j) of the lower triangle (column by column).  Step q: the pivot's
// lane takes sqrt, column q divides by it, every entry (i, j) with j > q
// subtracts L[i][q] * L[j][q].  An entry thus sees its subtractions in the
// order q = 0 ... j - 1, as in the left-looking order of the plain
// reference (ops/icp._solve_reference), each product and difference
// rounded once: the factor is bit-exact to it.  The two triangular solves
// are dependent chains of 6 steps whose back substitution must subtract in
// ascending q to stay bit-exact, so every lane of warp 0 runs both, in the
// plain order, from L in shared memory; se3_exp and the compose run in
// lane 0.
//
// Race epilogue (race = 1): when a candidate is done, its CTAs score its
// final transform (the score mode's sums) in the next round; after the
// barrier at which every candidate is done, CTA (0, 0) sums both scores
// over the CTAs, score = num / max(den, 1) (a true division), and keeps
// candidate 1 (the challenger, from the prior) only when its transform and
// score are finite and its score is strictly lower (pick_by_score): that
// row is written as row C of the output.
//
// Rounding: every product, sum and quotient that the plain PyTorch version
// (ops/icp.py, one rounding per operation) computes is written with the
// round-to-nearest intrinsics, in the plain version's order, so nvcc cannot
// contract them into FMAs.  Projection: u = p.x / z * fx + cx, then
// __float2int_rn (round half to even, saturating; NaN gives 0), and the
// in-image test reads that same integer.  The target ray is
// (u - cx) * (1 / fx) with 1 / fx rounded to float32 on the host, as XLA
// compiles a constant division; delta / |r| stays a true division.  The
// bf16 halves of the normal bits are decoded with 32-bit masks.  No float
// atomics: a run repeats bit for bit.  ops/icp._partials_reference,
// _sums_reference, _solve_warp_reference, _solve_update_reference and
// _level_reference compute the same in the same order.
//
// Bound: bytes.  A level reads 24 bytes a source pixel once and gathers 8
// bytes of target a source-valid pixel that projects into the image, each
// iteration: ~0.7 us at 320x240 and 3.35 TB/s; ~150 float operations a
// pixel.  Below the launch floor (about 1 us) and the grid barriers, so a
// level's least time is one launch and one barrier an iteration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;              // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;                  // 21 JTJ, 6 JTr, error, count
constexpr int kScoreSums = 2;              // num, den
constexpr int kMaxCtas = 128;              // CTAs a candidate
constexpr int kMaxCands = 32;              // candidates a launch
constexpr int kResident = 3;               // pixels a thread keeps in registers
constexpr int kMaxDevices = 16;
// an output row: T (16), dnorm, error, count, score, JTJ (36)
constexpr int kRow = 56;
constexpr int kRowScore = 19;
constexpr int kRowJTJ = 20;

// what a launch does
constexpr int kModeLoop = 0;
constexpr int kModeRace = 1;
constexpr int kModeSystem = 2;
constexpr int kModeScore = 3;

struct Camera {
  float fx, fy, cx, cy, rfx, rfy;
  int width, height;
};

struct Candidate {
  const float* verts;     // (n, 3)
  const float* normals;   // (n, 3)
  const float* tgt;       // (height, width, 2), 8-byte aligned
  const float* T;         // (4, 4) start transform
};

// The kernel's parameters, passed by value (the candidate table lives in
// the parameter space).
struct Params {
  Candidate cand[kMaxCands];
  Camera cam;
  int n, max_iters;
  float normal_thresh, dist_thresh, huber, damping, tol2;
  float* partials;   // (2, C, 29, CTAs); system / score mode: (29 or 2, CTAs)
  float* score;      // (C, 2, CTAs), race mode
  int* flags;        // (2, C)
  float* out;        // loop: (C + race, kRow); system: (44,); score: (2,)
  int* iters;        // (C + race,)
};

struct Pixel {
  float vx, vy, vz, sx, sy, sz;
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

// index of JTJ[a][b] (a <= b) among the 21 upper-triangle sums, row by row
__device__ __forceinline__ int upper_index(int a, int b) {
  return 6 * a - (a * (a - 1)) / 2 + (b - a);
}

// lane of lower-triangle entry (i, j), i >= j, numbered column by column
__device__ __forceinline__ int tri_lane(int i, int j) {
  return 6 * j - (j * (j - 1)) / 2 + (i - j);
}

__device__ __forceinline__ Pixel load_pixel(const Candidate& cd, int i) {
  Pixel p;
  p.vx = __ldg(cd.verts + 3 * i);
  p.vy = __ldg(cd.verts + 3 * i + 1);
  p.vz = __ldg(cd.verts + 3 * i + 2);
  p.sx = __ldg(cd.normals + 3 * i);
  p.sy = __ldg(cd.normals + 3 * i + 1);
  p.sz = __ldg(cd.normals + 3 * i + 2);
  return p;
}

// Adds one pixel's terms to ``acc``: 29 system terms, or (kScore) the
// score's num and den.
template <bool kScore>
__device__ __forceinline__ void accumulate(const Pixel& px_, const float2* __restrict__ tgt,
                                           const Camera& cam, const float* T,
                                           float normal_thresh, float dist_thresh,
                                           float huber, float* acc) {
  const float px = add(rot_row(T, 0, px_.vx, px_.vy, px_.vz), T[3]);
  const float py = add(rot_row(T, 1, px_.vx, px_.vy, px_.vz), T[7]);
  const float pz = add(rot_row(T, 2, px_.vx, px_.vy, px_.vz), T[11]);

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
  const float2 g = __ldg(tgt + (static_cast<int64_t>(vc) * cam.width + uc));
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
  const bool src_valid = px_.vz != 0.0f;

  if constexpr (kScore) {
    const bool matched = in_image && d_t > 0.0f;
    const float ar = fabsf(r);
    const float pen = matched ? (ar > dist_thresh ? dist_thresh : ar)
                              : dist_thresh;
    acc[0] = add(acc[0], src_valid ? pen : 0.0f);
    acc[1] = add(acc[1], src_valid ? 1.0f : 0.0f);
  } else {
    const float nsx = rot_row(T, 0, px_.sx, px_.sy, px_.sz);
    const float nsy = rot_row(T, 1, px_.sx, px_.sy, px_.sz);
    const float nsz = rot_row(T, 2, px_.sx, px_.sy, px_.sz);
    const bool valid = src_valid && in_image && d_t > 0.0f &&
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
      for (int b = a; b < 6; ++b, ++k) acc[k] = add(acc[k], mul(J[a], J[b]));
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] = add(acc[21 + a], mul(J[a], rw));
    acc[27] = add(acc[27], mul(rw, rw));
    acc[28] = add(acc[28], valid ? 1.0f : 0.0f);
  }
}

// This thread's sums over its pixels g, g + stride, ... in order, from 0.
template <bool kScore>
__device__ __forceinline__ void thread_sums(const Params& P, const Candidate& cd,
                                            const Pixel (&res)[kResident], int g,
                                            int stride, const float* T_s,
                                            float* acc) {
  constexpr int S = kScore ? kScoreSums : kSums;
  const float2* tgt = reinterpret_cast<const float2*>(cd.tgt);
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = T_s[k];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int q = 0; q < kResident; ++q) {
    if (g + q * stride < P.n)
      accumulate<kScore>(res[q], tgt, P.cam, T, P.normal_thresh,
                         P.dist_thresh, P.huber, acc);
  }
  for (int i = g + kResident * stride; i < P.n; i += stride)
    accumulate<kScore>(load_pixel(cd, i), tgt, P.cam, T, P.normal_thresh,
                       P.dist_thresh, P.huber, acc);
}

__device__ __forceinline__ float warp_tree(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_down_sync(kFull, s, off));
  return s;
}

// The CTA's S sums of the threads' ``acc``, through shared memory: warp w
// takes sums w, w + 8, ...; lane l adds threads l, l + 32, ..., l + 224 in
// order, then the tree (a warp's sums interleaved).  Sum k goes to
// col[k * col_stride].
template <int S>
__device__ __forceinline__ void cta_sums(const float* acc, float (*red)[kThreads],
                                         float* col, int col_stride) {
  constexpr int kRows = (S + kWarps - 1) / kWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < S; ++k) red[k][tid] = acc[k];
  __syncthreads();
  float s[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int k = warp + kWarps * m;
    s[m] = 0.0f;
    if (k < S) {
#pragma unroll
      for (int j = 0; j < kWarps; ++j) s[m] = add(s[m], red[k][lane + 32 * j]);
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int k = warp + kWarps * m;
    s[m] = warp_tree(s[m]);
    if (lane == 0 && k < S) col[k * col_stride] = s[m];
  }
  __syncthreads();
}

// The sums over the CTAs of S rows of n_cta (<= kMaxCtas) partials written
// by other CTAs before a grid barrier (read through L2): warp w takes rows
// w, w + 8, ...; lane l adds CTAs l, l + 32, ... in order, then the tree.
// Every load of the warp is issued before the first add, so the L2's
// latency is paid once, not once a CTA a lane.
template <int S>
__device__ __forceinline__ void grid_sums(const float* part, int n_cta, float* sums) {
  constexpr int kRows = (S + kWarps - 1) / kWarps;
  constexpr int kChunks = kMaxCtas / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[kRows][kChunks];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int k = warp + kWarps * m;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int b = lane + 32 * j;
      v[m][j] = k < S && b < n_cta
                    ? __ldcg(part + static_cast<int64_t>(k) * n_cta + b)
                    : 0.0f;
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int k = warp + kWarps * m;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j)
      if (lane + 32 * j < n_cta) s = add(s, v[m][j]);
    s = warp_tree(s);
    if (lane == 0 && k < S) sums[k] = s;
  }
  __syncthreads();
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

// Warp 0: the damped Cholesky solve of solve_normal_system from the 29
// sums; every lane ends with delta, or 0 when a pivot is not positive or
// delta is not finite.
__device__ void warp_solve(const float* sums, float damping, float (*Ls)[6],
                           float* delta) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < 21;
  int i = 0, j = 0;
  if (mine) {                       // lane -> (i, j), column by column
    int first = 0;
    while (lane >= first + 6 - j) {
      first += 6 - j;
      ++j;
    }
    i = j + (lane - first);
  }
  float w = 0.0f;
  if (mine) {
    w = sums[upper_index(j, i)];
    if (i == j) w = add(add(w, damping), sums[28] > 6.0f ? 0.0f : 1.0f);
  }
  bool ok = true;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float d = __shfl_sync(kFull, w, tri_lane(q, q));
    ok = ok && d > 0.0f;
    const float lqq = __fsqrt_rn(d);
    if (mine && j == q) w = i == q ? lqq : dvd(w, lqq);
    const bool trailing = mine && j > q;
    const float liq = __shfl_sync(kFull, w, trailing ? tri_lane(i, q) : lane);
    const float ljq = __shfl_sync(kFull, w, trailing ? tri_lane(j, q) : lane);
    if (trailing) w = sub(w, mul(liq, ljq));
  }
  if (mine) Ls[i][j] = w;
  __syncwarp();
  float y[6];
  for (int r = 0; r < 6; ++r) {
    float t = -sums[21 + r];
    for (int q = 0; q < r; ++q) t = sub(t, mul(Ls[r][q], y[q]));
    y[r] = dvd(t, Ls[r][r]);
  }
  for (int r = 5; r >= 0; --r) {
    float t = y[r];
    for (int q = r + 1; q < 6; ++q) t = sub(t, mul(Ls[q][r], delta[q]));
    delta[r] = dvd(t, Ls[r][r]);
  }
  for (int r = 0; r < 6; ++r) ok = ok && isfinite(delta[r]);
  if (!ok)
    for (int r = 0; r < 6; ++r) delta[r] = 0.0f;
}

// A CTA's loop state in shared memory.
struct State {
  float T[16];
  float sums[kSums];
  float L[6][6];
  float f[3];        // dnorm, err, count
  int it, done;
};

// Lane 0 of warp 0, after warp_solve: T <- exp(delta) T, the loop state.
__device__ void update(const Params& P, State& st, const float* delta) {
  float E[3][4];
  se3_exp(delta, E);
  float Tn[12];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = add(sum3(mul(E[i][0], st.T[j]), mul(E[i][1], st.T[4 + j]),
                               mul(E[i][2], st.T[8 + j])),
                          mul(E[i][3], st.T[12 + j]));
  // row 3 of exp(delta) is [0, 0, 0, 1]: T's bottom row stays
  for (int q = 0; q < 12; ++q) st.T[q] = Tn[q];
  float dnorm = 0.0f;
  for (int q = 0; q < 6; ++q) dnorm = add(dnorm, mul(delta[q], delta[q]));
  const int it = st.it + 1;
  const float count = st.sums[28];
  st.f[0] = dnorm;
  st.f[1] = dvd(st.sums[27], count < 1.0f ? 1.0f : count);
  st.f[2] = count;
  st.it = it;
  st.done = (it < P.max_iters && dnorm > P.tol2) ? 0 : 1;
}

// Candidate c's result row (its CTA 0): T, dnorm, err, count, JTJ; JTJ 0
// before any iteration.
__device__ void write_row(const Params& P, int c, const State& st, bool have_sums) {
  float* row = P.out + static_cast<int64_t>(c) * kRow;
  const int tid = threadIdx.x;
  if (tid < 16) {
    row[tid] = st.T[tid];
  } else if (tid < kRowScore) {
    row[tid] = st.f[tid - 16];
  } else if (tid == kRowScore) {
    row[tid] = 0.0f;
  } else if (tid < kRow) {
    const int e = tid - kRowJTJ, a = e / 6, b = e % 6;
    row[tid] = have_sums ? st.sums[upper_index(min(a, b), max(a, b))] : 0.0f;
  }
  if (tid == 0) P.iters[c] = st.it;
}

// CTA (0, 0) after the last barrier of a race: both scores, the pick, row 2.
__device__ void race_epilogue(const Params& P, int n_cta) {
  __shared__ float sc[4];         // num, den of candidates 0 and 1
  __shared__ float scores[2];
  __shared__ int take;
  const int tid = threadIdx.x;
  grid_sums<2 * kScoreSums>(P.score, n_cta, sc);
  if (tid == 0) {
    const float s0 = dvd(sc[0], sc[1] < 1.0f ? 1.0f : sc[1]);
    const float s1 = dvd(sc[2], sc[3] < 1.0f ? 1.0f : sc[3]);
    bool ok = isfinite(s1);
    for (int q = 0; q < 16; ++q) ok = ok && isfinite(__ldcg(P.out + kRow + q));
    scores[0] = s0;
    scores[1] = s1;
    take = ok && s1 < s0;
  }
  __syncthreads();
  const int src = take ? 1 : 0;
  if (tid < kRow) {
    const float v = tid == kRowScore ? scores[src] : __ldcg(P.out + src * kRow + tid);
    P.out[2 * kRow + tid] = v;
  }
  if (tid < 2) P.out[tid * kRow + kRowScore] = scores[tid];
  if (tid == 0) P.iters[2] = __ldcg(P.iters + src);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2)
icp_level_kernel(const __grid_constant__ Params P) {
  constexpr bool kRace = kMode == kModeRace;
  cg::grid_group grid = cg::this_grid();
  const int c = blockIdx.y, b = blockIdx.x;
  const int C = gridDim.y, n_cta = gridDim.x;
  const int tid = threadIdx.x;
  const Candidate& cd = P.cand[c];
  __shared__ float red[kSums][kThreads];
  __shared__ State st;

  if (tid < 16) st.T[tid] = __ldg(cd.T + tid);
  if (tid == 0) {
    st.it = 0;
    st.done = (kMode == kModeLoop || kRace) && P.max_iters <= 0;
    st.f[0] = st.f[1] = INFINITY;
    st.f[2] = 0.0f;
  }
  const int g = b * kThreads + tid, stride = n_cta * kThreads;
  Pixel res[kResident];
#pragma unroll
  for (int q = 0; q < kResident; ++q)
    res[q] = g + q * stride < P.n ? load_pixel(cd, g + q * stride) : Pixel{};
  __syncthreads();

  if constexpr (kMode == kModeSystem || kMode == kModeScore) {
    constexpr bool kScore = kMode == kModeScore;
    constexpr int S = kScore ? kScoreSums : kSums;
    float acc[S];
    thread_sums<kScore>(P, cd, res, g, stride, st.T, acc);
    cta_sums<S>(acc, red, P.partials + b, n_cta);
    grid.sync();
    if (b != 0) return;
    grid_sums<S>(P.partials, n_cta, st.sums);
    if constexpr (kScore) {
      if (tid < kScoreSums) P.out[tid] = st.sums[tid];
    } else if (tid < 36) {
      const int a = tid / 6, bb = tid % 6;
      P.out[tid] = st.sums[upper_index(min(a, bb), max(a, bb))];
    } else if (tid < 44) {
      P.out[tid] = st.sums[21 + tid - 36];   // JTr, error, count
    }
    return;
  } else {
    if (b == 0 && st.done) write_row(P, c, st, false);
    if (!kRace && C == 1 && st.done) return;    // max_iters <= 0
    bool scored = false;
    for (int round = 0;; ++round) {
      const int buf = round & 1;
      const bool done = st.done;
      if (!done) {
        float acc[kSums];
        thread_sums<false>(P, cd, res, g, stride, st.T, acc);
        cta_sums<kSums>(
            acc, red,
            P.partials + static_cast<int64_t>(buf * C + c) * kSums * n_cta + b,
            n_cta);
      } else if (kRace && !scored) {
        float acc[kScoreSums];
        thread_sums<true>(P, cd, res, g, stride, st.T, acc);
        cta_sums<kScoreSums>(
            acc, red, P.score + static_cast<int64_t>(c) * kScoreSums * n_cta + b,
            n_cta);
        scored = true;
      }
      if (b == 0 && tid == 0) P.flags[buf * C + c] = done ? 1 : 0;
      grid.sync();
      // thread k reads candidate k's flag while the sums' loads fly
      const int flag = tid < C ? __ldcg(P.flags + buf * C + tid) : 1;
      if (!done)
        grid_sums<kSums>(
            P.partials + static_cast<int64_t>(buf * C + c) * kSums * n_cta,
            n_cta, st.sums);
      // C = 1 returns as soon as it is done: nothing else to wait for
      if (C > 1 && __syncthreads_and(flag)) break;
      if (done) continue;                       // frozen
      if (tid < 32) {
        float delta[6];
        warp_solve(st.sums, P.damping, st.L, delta);
        if (tid == 0) update(P, st, delta);
      }
      __syncthreads();
      if (st.done) {
        if (b == 0) write_row(P, c, st, true);
        if (!kRace && C == 1) return;           // nobody else to wait for
      }
    }
    if (kRace && b == 0 && c == 0) race_epilogue(P, n_cta);
  }
}

// The cooperative launch of mode kMode on an (n_cta, C) grid, refused
// (cudaErrorCooperativeLaunchTooLarge) when the grid cannot be co-resident.
template <int kMode>
int launch_level(const Params& P, int n_cands, int n_cta, cudaStream_t stream) {
  static int per_sm[kMaxDevices], sms[kMaxDevices];   // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int blocks = 0, count = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, icp_level_kernel<kMode>, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm[dev] = blocks;
    sms[dev] = count;
  }
  if (n_cta * n_cands > per_sm[dev] * sms[dev])
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_cta, n_cands);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, icp_level_kernel<kMode>, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* const* table, int n_cands, int n, int width,
                   int height, float fx, float fy, float cx, float cy,
                   float rfx, float rfy, float normal_thresh,
                   float dist_thresh, float huber) {
  Params P = {};
  for (int c = 0; c < n_cands; ++c) {
    P.cand[c].verts = static_cast<const float*>(table[4 * c]);
    P.cand[c].normals = static_cast<const float*>(table[4 * c + 1]);
    P.cand[c].tgt = static_cast<const float*>(table[4 * c + 2]);
    P.cand[c].T = static_cast<const float*>(table[4 * c + 3]);
  }
  P.cam = Camera{fx, fy, cx, cy, rfx, rfy, width, height};
  P.n = n;
  P.normal_thresh = normal_thresh;
  P.dist_thresh = dist_thresh;
  P.huber = huber;
  return P;
}

bool bad_grid(int n_cands, int n, int n_cta) {
  return n_cands < 1 || n_cands > kMaxCands || n <= 0 || n_cta < 1 ||
         n_cta > kMaxCtas;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns a CUDA error code as an int (0 = launched).  ``table``: a
// host array of 4 pointers a candidate (vertices (n, 3), normals (n, 3),
// packed target (height, width, 2), start T (4, 4); float32 on the card),
// copied into the kernel's parameters.  ``n_cta``: CTAs a candidate, by
// the rule of the header comment.

// K4.  race != 0 needs n_cands == 2.  partials: (2, C, 29, n_cta) float32;
// score: (C, 2, n_cta) float32 (race only); flags: (2, C) int32; out:
// (C + race, 56) float32, row = T (16), dnorm, error, count, score, JTJ
// (36); iters: (C + race,) int32.  Row C of a race is the picked result.
extern "C" int icp_gn_level(const void* const* table, int n_cands, int race,
                            int n, int width, int height, float fx, float fy,
                            float cx, float cy, float rfx, float rfy,
                            float normal_thresh, float dist_thresh,
                            float huber, float damping, float tol2,
                            int max_iters, int n_cta, float* partials,
                            float* score, int* flags, float* out, int* iters,
                            void* stream) {
  if (bad_grid(n_cands, n, n_cta) || (race && n_cands != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P = make_params(table, n_cands, n, width, height, fx, fy, cx, cy,
                         rfx, rfy, normal_thresh, dist_thresh, huber);
  P.damping = damping;
  P.tol2 = tol2;
  P.max_iters = max_iters;
  P.partials = partials;
  P.score = score;
  P.flags = flags;
  P.out = out;
  P.iters = iters;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return race ? launch_level<kModeRace>(P, n_cands, n_cta, s)
              : launch_level<kModeLoop>(P, n_cands, n_cta, s);
}

// K4s.  One candidate; score == 0: out (44,) = JTJ (36), JTr (6), error,
// count; score != 0: out (2,) = num, den.  partials: (29 or 2, n_cta).
extern "C" int icp_sums(const void* const* table, int score, int n, int width,
                        int height, float fx, float fy, float cx, float cy,
                        float rfx, float rfy, float normal_thresh,
                        float dist_thresh, float huber, int n_cta,
                        float* partials, float* out, void* stream) {
  if (bad_grid(1, n, n_cta)) return static_cast<int>(cudaErrorInvalidValue);
  Params P = make_params(table, 1, n, width, height, fx, fy, cx, cy, rfx,
                         rfy, normal_thresh, dist_thresh, huber);
  P.partials = partials;
  P.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return score ? launch_level<kModeScore>(P, 1, n_cta, s)
               : launch_level<kModeSystem>(P, 1, n_cta, s);
}
