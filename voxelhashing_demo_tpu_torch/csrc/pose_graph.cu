// Pose-graph bundle adjustment for Hopper (sm_90a): one Gauss-Newton step
// of ops/pose_graph.optimize on the card with no host read.  Three entry
// points:
//
//   pg_edge_blocks (K13a): two launches.  The edge kernel, 16 lanes an
//     edge: gather T_i, T_j and Z, r = log(Z^-1 T_i^-1 T_j), the robust
//     weight (Geman-McClure, Huber or off), and lane q < 12 the residual's
//     derivative along right perturbation q (0-5 of T_i, 6-11 of T_j) at
//     zero: a forward-mode tangent through inverse, the products and the
//     logarithm, with the logarithm's own branches (theta2 < 1e-2, the
//     clamp of cos theta).  Then J^T W J and J^T W r as the (E, 128) edge
//     rows: Hii, Hij, Hjj (36 each), bi, bj (6 each), w |r|^2, w.  The
//     assembly kernel, a warp a pose (and one warp for chi2): the pose's
//     edge lists as bitmaps (edges of nonzero weight with i == k, with
//     j == k), then b (K, 6) and, by mode, the dense H (6K, 6K) (its
//     anchor and damping diagonal added on request) or the block diagonal
//     Hd (K, 6, 6) with them in it; chi2 in every mode.
//   pg_cg_solve (K13b): one cooperative launch.  The whole
//     block-Jacobi-preconditioned CG of solve_delta_cg: each 6x6 block of
//     Hd factored, the matvec from the edge rows, the dots, the stop test
//     it < iters && r.r > tol2 . b.b and the clamps on the card, two grid
//     barriers an iteration; then ok = every factor and x finite, and the
//     retract T_k <- T_k exp(delta_k) with delta = ok ? x : 0.
//   pg_retract (K13c): the dense step's tail in one launch: ok = (info ==
//     0) and every delta finite, delta set to 0 where ok fails, then
//     T_k <- T_k exp(delta_k).
//
// Replaces what XLA fused on the TPU inside the jitted optimize of
// voxelhashing_demo_tpu/ops/pose_graph.py: _edge_blocks (:237), with its
// jax.jacfwd of the residual under vmap, build_normal_equations (:194),
// robust_edge_weights (:152), _chi2 (:189), solve_delta_cg's while_loop
// (:292-380) and apply_update's guard and retract (:383-396).  No Pallas
// kernel.  The dense factorization and its two triangular solves stay
// with the library (torch.linalg.cholesky_ex, cholesky_solve), as the JAX
// package leaves them to cho_factor outside any kernel.
//
// Order of the sums (the plain versions in ops/pose_graph.py compute the
// same in the same order, so the two agree bit for bit, zeros' signs
// aside): every sum over edges runs in edge order from 0, one pass a
// term, and the passes add in a fixed order:
//   b[k]  = (sum of bi, i_e = k) + (sum of bj, j_e = k);
//   Hd[k] = ((sum of Hii, i_e = k) + (sum of Hjj, j_e = k)) + diag;
//   H(a, b) = (((S1 + S2) + S3) + S4): S1 the Hii of edges i_e = a = b,
//     S2 the Hij of edges (a, b), S3 the Hij^T of edges (b, a), S4 the Hjj
//     of edges j_e = a = b; on request then (H_kk + anchor_k) + damping;
//   the CG matvec y[k] = ((sum of yi, i_e = k) + (sum of yj, j_e = k))
//     + diag * x[k];
//   chi2 and every dot product: lane l of a warp sums values l, l + 32,
//     ... in order, then a shuffle-down tree (16, 8, 4, 2, 1); a dot's
//     values are the poses' own dots, six products each in order.
// An edge of weight 0 (a pad) joins no list: its blocks are zeros, which
// the plain version adds.  No float atomics: two runs agree bit for bit.
//
// Rounding: every product, sum, quotient and square root is written with
// the round-to-nearest intrinsics, in the plain version's order, so nvcc
// contracts nothing into FMAs; sinf, cosf and atan2f are the math
// library's, as torch.sin, torch.cos and torch.atan2 are on the card.
//
// Bound: bytes and launches.  An edge reads 200 bytes (two poses, Z, w,
// the indices) and writes 800 (its row, J, r); the assembly reads the rows
// once; the whole work at E = 2048 is under 2 MB, about 0.6 us at 3.35
// TB/s, far below the launch floor; CG's least is its grid barriers, two
// an iteration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;               // a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                  // lanes an edge
constexpr int kEdgesPerCta = kThreads / kLanes;
constexpr int kRow = 128;                   // floats of an edge row
constexpr int kHii = 0, kHij = 36, kHjj = 72, kBi = 108, kBj = 114;
constexpr int kT = 120, kEw = 121;
constexpr int kMaxDevices = 16;

constexpr int kModeChi2 = 0, kModeDense = 1, kModeCg = 2;
constexpr int kRobustOff = 0, kRobustGm = 1, kRobustHuber = 2;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// a + b + c as the plain version sums three terms
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, b), c);
}

// six products in order
__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float s = mul(a[0], b[0]);
#pragma unroll
  for (int c = 1; c < 6; ++c) s = add(s, mul(a[c], b[c]));
  return s;
}

// max(x, lo) / min(x, hi) keeping a NaN, as torch.clamp does
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_hi(float x, float hi) { return x > hi ? hi : x; }

struct Rigid {
  float R[3][3];
  float t[3];
};

__device__ __forceinline__ void load_rigid(const float* __restrict__ T, Rigid& X) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) X.R[i][j] = __ldg(T + 4 * i + j);
    X.t[i] = __ldg(T + 4 * i + 3);
  }
}

// se3.inverse: [R^T, -(R^T t)]
__device__ __forceinline__ void inverse(const Rigid& X, Rigid& Y) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Y.R[i][j] = X.R[j][i];
    Y.t[i] = -sum3(mul(X.R[0][i], X.t[0]), mul(X.R[1][i], X.t[1]),
                   mul(X.R[2][i], X.t[2]));
  }
}

// A @ B of two rigid transforms (the zero bottom-row terms dropped)
__device__ __forceinline__ void compose(const Rigid& A, const Rigid& B, Rigid& C) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.R[i][j] = sum3(mul(A.R[i][0], B.R[0][j]), mul(A.R[i][1], B.R[1][j]),
                       mul(A.R[i][2], B.R[2][j]));
    C.t[i] = add(sum3(mul(A.R[i][0], B.t[0]), mul(A.R[i][1], B.t[1]),
                      mul(A.R[i][2], B.t[2])),
                 A.t[i]);
  }
}

// column j of R hat(e_a) = R (e_a x e_j): +-R[:, m], or 0 (j == a)
__device__ __forceinline__ float rot_dir(const float (*R)[3], int a, int i, int j) {
  if (j == a) return 0.0f;
  const int m = 3 - a - j;
  const bool plus = (j - a + 3) % 3 == 1;
  return plus ? R[i][m] : -R[i][m];
}

// the value path of se3.log at M, kept for the tangents
struct Log {
  float ws[3], s, c, theta, th2, q, thu, A, B, half, shalf, coef;
  float K[3][3], K2[3][3], Vi[3][3], t[3];
  bool small, pass;
};

__device__ __forceinline__ void hat(const float* w, float (*K)[3]) {
  K[0][0] = 0.0f;  K[0][1] = -w[2]; K[0][2] = w[1];
  K[1][0] = w[2];  K[1][1] = 0.0f;  K[1][2] = -w[0];
  K[2][0] = -w[1]; K[2][1] = w[0];  K[2][2] = 0.0f;
}

__device__ __forceinline__ void matmul3(const float (*A)[3], const float (*B)[3],
                                        float (*C)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = sum3(mul(A[i][0], B[0][j]), mul(A[i][1], B[1][j]),
                     mul(A[i][2], B[2][j]));
}

__device__ void log_value(const Rigid& M, Log& L, float* r) {
  L.ws[0] = mul(0.5f, sub(M.R[2][1], M.R[1][2]));
  L.ws[1] = mul(0.5f, sub(M.R[0][2], M.R[2][0]));
  L.ws[2] = mul(0.5f, sub(M.R[1][0], M.R[0][1]));
  const float s2 = sum3(mul(L.ws[0], L.ws[0]), mul(L.ws[1], L.ws[1]),
                        mul(L.ws[2], L.ws[2]));
  const float tr = add(add(M.R[0][0], M.R[1][1]), M.R[2][2]);
  const float x = mul(sub(tr, 1.0f), 0.5f);
  L.pass = x >= -1.0f && x <= 1.0f;
  L.c = clamp_hi(clamp_lo(x, -1.0f), 1.0f);
  L.s = __fsqrt_rn(add(s2, 1e-24f));
  L.theta = atan2f(L.s, L.c);
  L.th2 = mul(L.theta, L.theta);
  L.q = dvd(L.theta, L.s);
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = mul(L.q, L.ws[k]);
  // _sinc_factors
  L.thu = __fsqrt_rn(add(L.th2, 1e-16f));
  L.small = L.th2 < 1e-2f;
  L.A = L.small ? add(sub(1.0f, mul(L.th2, 1.0f / 6.0f)),
                      mul(mul(L.th2, L.th2), 1.0f / 120.0f))
                : dvd(sinf(L.thu), L.thu);
  L.half = mul(0.5f, L.thu);
  L.shalf = dvd(sinf(L.half), L.half);
  L.B = mul(mul(0.5f, L.shalf), L.shalf);
  L.coef = L.small ? add(add(1.0f / 12.0f, mul(L.th2, 1.0f / 720.0f)),
                         mul(mul(L.th2, L.th2), 1.0f / 30240.0f))
                   : dvd(sub(1.0f, dvd(L.A, mul(2.0f, L.B))),
                         clamp_lo(L.th2, 1e-8f));
  hat(w, L.K);
  matmul3(L.K, L.K, L.K2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      L.Vi[i][j] = add(sub(i == j ? 1.0f : 0.0f, mul(0.5f, L.K[i][j])),
                       mul(L.coef, L.K2[i][j]));
    L.t[i] = M.t[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = sum3(mul(L.Vi[i][0], L.t[0]), mul(L.Vi[i][1], L.t[1]),
                mul(L.Vi[i][2], L.t[2]));
#pragma unroll
  for (int k = 0; k < 3; ++k) r[3 + k] = w[k];
}

// the tangent of se3.log at L along dM = (dR, dt) -> dr (6)
__device__ void log_tangent(const Log& L, const float (*dR)[3], const float* dt,
                            float* dr) {
  float dws[3];
  dws[0] = mul(0.5f, sub(dR[2][1], dR[1][2]));
  dws[1] = mul(0.5f, sub(dR[0][2], dR[2][0]));
  dws[2] = mul(0.5f, sub(dR[1][0], dR[0][1]));
  const float ds = dvd(sum3(mul(L.ws[0], dws[0]), mul(L.ws[1], dws[1]),
                            mul(L.ws[2], dws[2])),
                       L.s);
  const float dc = L.pass ? mul(add(add(dR[0][0], dR[1][1]), dR[2][2]), 0.5f) : 0.0f;
  const float dth = dvd(sub(mul(L.c, ds), mul(L.s, dc)),
                        add(mul(L.s, L.s), mul(L.c, L.c)));
  const float dq = dvd(sub(dth, mul(L.q, ds)), L.s);
  float dw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) dw[k] = add(mul(dq, L.ws[k]), mul(L.q, dws[k]));
  const float dth2 = mul(mul(2.0f, L.theta), dth);
  float dcoef;
  if (L.small) {
    dcoef = mul(dth2, add(1.0f / 720.0f, mul(mul(2.0f, L.th2), 1.0f / 30240.0f)));
  } else {
    const float dthu = dvd(dth2, mul(2.0f, L.thu));
    const float dA = dvd(mul(dthu, sub(cosf(L.thu), L.A)), L.thu);
    const float dhalf = mul(0.5f, dthu);
    const float dshalf = dvd(mul(dhalf, sub(cosf(L.half), L.shalf)), L.half);
    const float dB = mul(L.shalf, dshalf);
    const float B2 = mul(2.0f, L.B);
    const float g = dvd(L.A, B2);
    const float dg = dvd(sub(dA, mul(g, mul(2.0f, dB))), B2);
    dcoef = dvd(sub(-dg, mul(L.coef, dth2)), clamp_lo(L.th2, 1e-8f));
  }
  float dK[3][3], P1[3][3], P2[3][3];
  hat(dw, dK);
  matmul3(dK, L.K, P1);
  matmul3(L.K, dK, P2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float dVi[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dVi[j] = sub(add(mul(dcoef, L.K2[i][j]), mul(L.coef, add(P1[i][j], P2[i][j]))),
                   mul(0.5f, dK[i][j]));
    dr[i] = add(sum3(mul(dVi[0], L.t[0]), mul(dVi[1], L.t[1]), mul(dVi[2], L.t[2])),
                sum3(mul(L.Vi[i][0], dt[0]), mul(L.Vi[i][1], dt[1]),
                     mul(L.Vi[i][2], dt[2])));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) dr[3 + k] = dw[k];
}

// the derivative of the residual along right perturbation q at zero:
// q < 6 perturbs T_i (through its inverse), q >= 6 T_j (M exp(xi) -> M dE)
__device__ void edge_tangent(int q, const Rigid& Ti, const Rigid& Tii, const Rigid& Zi,
                             const Rigid& Tj, const Rigid& M, const Log& L, float* dr) {
  float dR[3][3], dt[3];
  if (q >= 6) {
    const int k = q - 6;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) dR[i][j] = k < 3 ? 0.0f : rot_dir(M.R, k - 3, i, j);
      dt[i] = k < 3 ? M.R[i][k] : 0.0f;
    }
  } else {
    // D = T_i dE, then the inverse's tangent, then Z^-1 (.) T_j
    float D[3][3], Dt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) D[i][j] = q < 3 ? 0.0f : rot_dir(Ti.R, q - 3, i, j);
      Dt[i] = q < 3 ? Ti.R[i][q] : 0.0f;
    }
    float IR[3][3], It[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int l = 0; l < 3; ++l) IR[m][l] = D[l][m];
      It[m] = -add(sum3(mul(D[0][m], Ti.t[0]), mul(D[1][m], Ti.t[1]),
                        mul(D[2][m], Ti.t[2])),
                   sum3(mul(Tii.R[m][0], Dt[0]), mul(Tii.R[m][1], Dt[1]),
                        mul(Tii.R[m][2], Dt[2])));
    }
    float XR[3][3], Xt[3];
    matmul3(Zi.R, IR, XR);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      Xt[i] = sum3(mul(Zi.R[i][0], It[0]), mul(Zi.R[i][1], It[1]), mul(Zi.R[i][2], It[2]));
    matmul3(XR, Tj.R, dR);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dt[i] = add(sum3(mul(XR[i][0], Tj.t[0]), mul(XR[i][1], Tj.t[1]),
                       mul(XR[i][2], Tj.t[2])),
                  Xt[i]);
  }
  log_tangent(L, dR, dt, dr);
}

struct EdgeArgs {
  const float* poses;   // (K, 4, 4)
  const int* ij;        // (E, 2)
  const float* Z;       // (E, 4, 4)
  const float* w;       // (E,)
  int K, E, robust;
  float rho;            // gm: delta^2; huber: delta
  float* rows;          // (E, 128)
  float* J;             // (E, 6, 12)
  float* r;             // (E, 6)
};

__device__ __forceinline__ int clamp_index(int i, int K) { return i < 0 ? 0 : (i >= K ? K - 1 : i); }

template <bool kJac>
__global__ void __launch_bounds__(kThreads) edge_kernel(const EdgeArgs a) {
  __shared__ float Js[kEdgesPerCta][6][13];
  __shared__ float rs[kEdgesPerCta][8];      // r, ew, w |r|^2
  const int slot = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int e = blockIdx.x * kEdgesPerCta + slot;
  const bool live = e < a.E;
  if (live) {
    const int i = clamp_index(__ldg(a.ij + 2 * e), a.K);
    const int j = clamp_index(__ldg(a.ij + 2 * e + 1), a.K);
    Rigid Ti, Tj, Z, Zi, Tii, P, M;
    load_rigid(a.poses + 16 * i, Ti);
    load_rigid(a.poses + 16 * j, Tj);
    load_rigid(a.Z + 16 * static_cast<int64_t>(e), Z);
    inverse(Z, Zi);
    inverse(Ti, Tii);
    compose(Zi, Tii, P);
    compose(P, Tj, M);
    Log L;
    float r[6];
    log_value(M, L, r);
    float rn2 = mul(r[0], r[0]);
#pragma unroll
    for (int k = 1; k < 6; ++k) rn2 = add(rn2, mul(r[k], r[k]));
    const float w = __ldg(a.w + e);
    float ew = w;
    if (a.robust == kRobustGm) {
      ew = mul(w, dvd(a.rho, add(a.rho, rn2)));
    } else if (a.robust == kRobustHuber) {
      const float rn = __fsqrt_rn(rn2);
      ew = mul(w, clamp_hi(dvd(a.rho, clamp_lo(rn, 1e-12f)), 1.0f));
    }
    if (q == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        rs[slot][k] = r[k];
        a.r[6 * static_cast<int64_t>(e) + k] = r[k];
      }
      rs[slot][6] = ew;
      rs[slot][7] = mul(ew, rn2);
    }
    if (kJac && q < 12) {
      float dr[6];
      edge_tangent(q, Ti, Tii, Zi, Tj, M, L, dr);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        Js[slot][k][q] = dr[k];
        a.J[72 * static_cast<int64_t>(e) + 12 * k + q] = dr[k];
      }
    }
  }
  __syncwarp();
  if (!live) return;
  float* row = a.rows + kRow * static_cast<int64_t>(e);
  if (!kJac) {
    if (q == 0) {
      row[kT] = rs[slot][7];
      row[kEw] = rs[slot][6];
    }
    return;
  }
  const float ew = rs[slot][6];
  for (int s = q; s < kRow; s += kLanes) {
    float v = 0.0f;
    if (s < kBi) {                       // Hii, Hij, Hjj
      const int blk = s / 36, bb = (s % 36) / 6, cc = s % 6;
      const int left = blk == 2 ? 6 + bb : bb, right = blk == 0 ? cc : 6 + cc;
      v = mul(mul(Js[slot][0][left], ew), Js[slot][0][right]);
#pragma unroll
      for (int k = 1; k < 6; ++k)
        v = add(v, mul(mul(Js[slot][k][left], ew), Js[slot][k][right]));
    } else if (s < kT) {                 // bi, bj
      const int col = s < kBj ? s - kBi : 6 + (s - kBj);
      v = mul(mul(Js[slot][0][col], ew), rs[slot][0]);
#pragma unroll
      for (int k = 1; k < 6; ++k) v = add(v, mul(mul(Js[slot][k][col], ew), rs[slot][k]));
    } else if (s == kT) {
      v = rs[slot][7];
    } else if (s == kEw) {
      v = ew;
    }
    row[s] = v;
  }
}

// chi2 and the dots: lane l sums v[l], v[l + 32], ... in order from its
// first value (0 past the end), then the shuffle-down tree; every lane
// gets the sum
template <bool kCg>
__device__ __forceinline__ float ordered_sum(const float* v, int n, int stride) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const float x = k < n ? (kCg ? __ldcg(v + static_cast<int64_t>(k) * stride)
                                 : v[static_cast<int64_t>(k) * stride])
                          : 0.0f;
    s = base == 0 ? x : add(s, x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_down_sync(kFull, s, off));
  return __shfl_sync(kFull, s, 0);
}

// calls f(e) for every edge of a pose's bitmap, in edge order; warp-uniform
template <typename F>
__device__ __forceinline__ void for_each_edge(const unsigned* bm, int nw, F f) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < nw; c0 += 32) {
    const unsigned mine = c0 + lane < nw ? bm[c0 + lane] : 0u;
    unsigned words = __ballot_sync(kFull, mine != 0u);
    while (words) {
      const int k = __ffs(words) - 1;
      words &= words - 1;
      unsigned word = __shfl_sync(kFull, mine, k);
      while (word) {
        const int bit = __ffs(word) - 1;
        word &= word - 1;
        f(32 * (c0 + k) + bit);
      }
    }
  }
}

struct AsmArgs {
  const float* rows;   // (E, 128)
  const int* ij;       // (E, 2)
  const float* w;      // (E,)
  int K, E, nw, mode, diag;
  float damping;
  unsigned* bm;        // (2, K, nw): edges with i == k, with j == k
  float* b;            // (K, 6)
  float* chi2;         // (1,)
  float* H;            // dense (6K, 6K) or Hd (K, 36)
};

__global__ void __launch_bounds__(kThreads) assemble_kernel(const AsmArgs a) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p == a.K) {
    const float s = ordered_sum<false>(a.rows + kT, a.E, kRow);
    if (lane == 0) *a.chi2 = s;
    return;
  }
  if (p > a.K || a.mode == kModeChi2) return;
  unsigned* bmi = a.bm + static_cast<int64_t>(p) * a.nw;
  unsigned* bmj = a.bm + (static_cast<int64_t>(a.K) + p) * a.nw;
  for (int c = 0; c < a.nw; ++c) {
    const int e = 32 * c + lane;
    bool mi = false, mj = false;
    if (e < a.E && __ldg(a.w + e) != 0.0f) {
      mi = __ldg(a.ij + 2 * e) == p;
      mj = __ldg(a.ij + 2 * e + 1) == p;
    }
    const unsigned wi = __ballot_sync(kFull, mi), wj = __ballot_sync(kFull, mj);
    if (lane == 0) {
      bmi[c] = wi;
      bmj[c] = wj;
    }
  }
  __syncwarp();
  const float* rows = a.rows;
  auto row = [&](int e) { return rows + kRow * static_cast<int64_t>(e); };

  // b: lanes 0-5
  {
    float si = 0.0f, sj = 0.0f;
    const int c = lane < 6 ? lane : 0;
    for_each_edge(bmi, a.nw, [&](int e) { si = add(si, __ldg(row(e) + kBi + c)); });
    for_each_edge(bmj, a.nw, [&](int e) { sj = add(sj, __ldg(row(e) + kBj + c)); });
    if (lane < 6) a.b[6 * static_cast<int64_t>(p) + lane] = add(si, sj);
  }

  // element l (and l + 32, lanes 0-3) of a 6x6 block
  const int el0 = lane, el1 = lane + 32;
  const bool two = lane < 4;
  const int r0 = el0 / 6, c0 = el0 % 6, r1 = el1 / 6, c1 = el1 % 6;
  float s1[2] = {0.0f, 0.0f}, s4[2] = {0.0f, 0.0f};
  for_each_edge(bmi, a.nw, [&](int e) {
    s1[0] = add(s1[0], __ldg(row(e) + kHii + el0));
    if (two) s1[1] = add(s1[1], __ldg(row(e) + kHii + el1));
  });
  for_each_edge(bmj, a.nw, [&](int e) {
    s4[0] = add(s4[0], __ldg(row(e) + kHjj + el0));
    if (two) s4[1] = add(s4[1], __ldg(row(e) + kHjj + el1));
  });

  if (a.mode == kModeCg) {
    const float dv = p == 0 ? add(a.damping, 1e6f) : a.damping;
    float* Hd = a.H + 36 * static_cast<int64_t>(p);
    Hd[el0] = add(add(s1[0], s4[0]), r0 == c0 ? dv : 0.0f);
    if (two) Hd[el1] = add(add(s1[1], s4[1]), r1 == c1 ? dv : 0.0f);
    return;
  }

  // dense: this warp's six rows of H, zeroed, then S2 and S3 of the
  // off-diagonal blocks, then the diagonal block
  const int64_t n6 = 6 * static_cast<int64_t>(a.K);
  float* Hrow = a.H + 6 * static_cast<int64_t>(p) * n6;
  for (int64_t k = lane; k < 6 * n6; k += 32) Hrow[k] = 0.0f;
  __syncwarp();
  float s2[2] = {0.0f, 0.0f}, s3[2] = {0.0f, 0.0f};
  // S2: edges (p, j) in order, each its Hij into block (p, j)
  for_each_edge(bmi, a.nw, [&](int e) {
    const int j = __ldg(a.ij + 2 * e + 1);
    const float v0 = __ldg(row(e) + kHij + el0);
    const float v1 = two ? __ldg(row(e) + kHij + el1) : 0.0f;
    if (j == p) {
      s2[0] = add(s2[0], v0);
      if (two) s2[1] = add(s2[1], v1);
    } else {
      float* d0 = Hrow + r0 * n6 + 6 * j + c0;
      *d0 = add(*d0, v0);
      if (two) {
        float* d1 = Hrow + r1 * n6 + 6 * j + c1;
        *d1 = add(*d1, v1);
      }
    }
  });
  __syncwarp();
  // S3: edges (i, p), each Hij^T into block (p, i); the edges of one block
  // are summed from 0 at its first edge, then added to S2
  for_each_edge(bmj, a.nw, [&](int e) {
    const int i = __ldg(a.ij + 2 * e);
    if (i == p) {
      s3[0] = add(s3[0], __ldg(row(e) + kHij + 6 * c0 + r0));
      if (two) s3[1] = add(s3[1], __ldg(row(e) + kHij + 6 * c1 + r1));
      return;
    }
    bool first = true;
    for_each_edge(bmj, a.nw, [&](int f) {
      if (f < e && __ldg(a.ij + 2 * f) == i) first = false;
    });
    if (!first) return;
    float t0 = 0.0f, t1 = 0.0f;
    for_each_edge(bmj, a.nw, [&](int f) {
      if (f >= e && __ldg(a.ij + 2 * f) == i) {
        t0 = add(t0, __ldg(row(f) + kHij + 6 * c0 + r0));
        if (two) t1 = add(t1, __ldg(row(f) + kHij + 6 * c1 + r1));
      }
    });
    float* d0 = Hrow + r0 * n6 + 6 * i + c0;
    *d0 = add(*d0, t0);
    if (two) {
      float* d1 = Hrow + r1 * n6 + 6 * i + c1;
      *d1 = add(*d1, t1);
    }
  });
  __syncwarp();
  const float anchor = p == 0 ? 1e6f : 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !two) break;
    const int rr = h ? r1 : r0, cc = h ? c1 : c0;
    float v = add(add(add(s1[h], s2[h]), s3[h]), s4[h]);
    if (a.diag && rr == cc) v = add(add(v, anchor), a.damping);
    Hrow[rr * n6 + 6 * p + cc] = v;
  }
}

// ---------------------------------------------------------------------------
// the retract, shared by K13b and K13c
// ---------------------------------------------------------------------------

// exp(xi) for xi = [v, w] (geometry/se3.exp with _sinc_factors), as a 3x4
__device__ void se3_exp(const float* xi, float E[3][4]) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = sum3(mul(w0, w0), mul(w1, w1), mul(w2, w2));
  const float theta = __fsqrt_rn(add(theta2, 1e-16f));
  const bool small = theta2 < 1e-2f;
  const float t4 = mul(theta2, theta2);
  const float A = small ? add(sub(1.0f, mul(theta2, 1.0f / 6.0f)), mul(t4, 1.0f / 120.0f))
                        : dvd(sinf(theta), theta);
  const float half = mul(0.5f, theta);
  const float s_half = dvd(sinf(half), half);
  const float B = mul(mul(0.5f, s_half), s_half);
  const float C = small ? add(sub(1.0f / 6.0f, mul(theta2, 1.0f / 120.0f)),
                              mul(t4, 1.0f / 5040.0f))
                        : dvd(sub(1.0f, A), theta2);
  const float w[3] = {w0, w1, w2};
  float K[3][3], K2[3][3];
  hat(w, K);
  matmul3(K, K, K2);
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

// out = T exp(d): rows 0-2 of T @ E (E's bottom row [0, 0, 0, 1]); row 3
// is T's
__device__ void retract(const float* T, const float* d, float* out) {
  float E[3][4];
  se3_exp(d, E);
  float Tv[16];
  for (int k = 0; k < 16; ++k) Tv[k] = T[k];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      out[4 * i + j] = sum3(mul(Tv[4 * i], E[0][j]), mul(Tv[4 * i + 1], E[1][j]),
                            mul(Tv[4 * i + 2], E[2][j]));
    out[4 * i + 3] = add(sum3(mul(Tv[4 * i], E[0][3]), mul(Tv[4 * i + 1], E[1][3]),
                              mul(Tv[4 * i + 2], E[2][3])),
                         Tv[4 * i + 3]);
  }
  for (int k = 12; k < 16; ++k) out[k] = Tv[k];
}

// K13c: one thread a pose; every CTA reads the whole guard
__global__ void __launch_bounds__(kThreads) retract_kernel(const float* delta, const int* info,
                                                           const float* poses, int K,
                                                           float* out, float* used) {
  bool fine = true;
  for (int k = threadIdx.x; k < 6 * K; k += kThreads) fine = fine && isfinite(delta[k]);
  const bool ok = __syncthreads_and(fine) && *info == 0;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= K) return;
  float d[6];
  for (int c = 0; c < 6; ++c) d[c] = ok ? delta[6 * p + c] : 0.0f;
  retract(poses + 16 * static_cast<int64_t>(p), d, out + 16 * static_cast<int64_t>(p));
  for (int c = 0; c < 6; ++c) used[6 * p + c] = d[c];
}

// ---------------------------------------------------------------------------
// K13b: block-Jacobi PCG, one cooperative launch
// ---------------------------------------------------------------------------

struct CgArgs {
  const float* rows;   // (E, 128)
  const int* ij;       // (E, 2)
  const unsigned* bm;  // (2, K, nw)
  const float* Hd;     // (K, 36), damping and anchor in it
  const float* bblk;   // (K, 6)
  const float* poses;  // (K, 4, 4)
  int K, nw, iters;
  float damping, tol2f;
  float* L;            // (K, 36)
  float* x;            // (K, 6)
  float* r;            // (K, 6)
  float* z;            // (K, 6)
  float* Ap;           // (K, 6)
  float* P;            // (2, K, 6)
  float* part;         // (4, K): p.Ap, r.z, r.r, b.b
  int* flags;          // (K,)
  float* out;          // (K, 4, 4)
  float* delta;        // (K, 6)
  int* iters_out;      // (1,)
};

// a 6x6 Cholesky factor of A (column by column; entry (i, j) subtracts
// L[i][q] L[j][q] for q = 0 ... j - 1 in order, then takes the square
// root or divides); ok = every pivot > 0
__device__ bool chol6(const float* A, float (*Lm)[6]) {
  bool ok = true;
  for (int j = 0; j < 6; ++j) {
    for (int i = j; i < 6; ++i) {
      float v = A[6 * i + j];
      for (int q = 0; q < j; ++q) v = sub(v, mul(Lm[i][q], Lm[j][q]));
      if (i == j) {
        ok = ok && v > 0.0f;
        Lm[j][j] = __fsqrt_rn(v);
      } else {
        Lm[i][j] = dvd(v, Lm[j][j]);
      }
    }
  }
  return ok;
}

// z = (L L^T)^-1 r: forward, then back substitution, in ascending q
__device__ void chol6_solve(const float* Lg, const float* r, float* z) {
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float t = r[i];
    for (int q = 0; q < i; ++q) t = sub(t, mul(Lg[6 * i + q], y[q]));
    y[i] = dvd(t, Lg[7 * i]);
  }
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
    for (int q = i + 1; q < 6; ++q) t = sub(t, mul(Lg[6 * q + i], z[q]));
    z[i] = dvd(t, Lg[7 * i]);
  }
}

__device__ __forceinline__ void load6(const float* src, float* v, bool cg) {
  for (int c = 0; c < 6; ++c) v[c] = cg ? __ldcg(src + c) : src[c];
}

__global__ void __launch_bounds__(kThreads) cg_kernel(const CgArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const int K = a.K;
  float* pAp = a.part;
  float* prz = a.part + K;
  float* prr = a.part + 2 * K;
  float* pbb = a.part + 3 * K;

  // factor, b = -bblk, x = 0, r = b, z = M r, p = z
  for (int p = gw; p < K; p += nwarps) {
    float Lm[6][6] = {};
    const bool ok = chol6(a.Hd + 36 * static_cast<int64_t>(p), Lm);
    float* Lg = a.L + 36 * static_cast<int64_t>(p);
    if (lane < 6)
      for (int j = 0; j < 6; ++j) Lg[6 * lane + j] = j <= lane ? Lm[lane][j] : 0.0f;
    if (lane == 0) a.flags[p] = ok ? 1 : 0;
    __syncwarp();
    float b[6], z[6];
    for (int c = 0; c < 6; ++c) b[c] = -a.bblk[6 * p + c];
    chol6_solve(Lg, b, z);
    if (lane < 6) {
      a.x[6 * p + lane] = 0.0f;
      a.r[6 * p + lane] = b[lane];
      a.z[6 * p + lane] = z[lane];
      a.P[6 * p + lane] = z[lane];
    }
    if (lane == 0) {
      pbb[p] = dot6(b, b);
      prz[p] = dot6(b, z);
    }
  }
  grid.sync();
  const float bb = ordered_sum<true>(pbb, K, 1);
  const float tol2 = mul(a.tol2f, bb);
  float rz = ordered_sum<true>(prz, K, 1);
  float rr = bb;
  float beta = 0.0f;
  int it = 0;
  const unsigned* bmi0 = a.bm;
  const unsigned* bmj0 = a.bm + static_cast<int64_t>(K) * a.nw;
  while (it < a.iters && rr > tol2) {
    const int cur = it & 1;
    const float* Pprev = a.P + (cur ^ 1) * 6 * static_cast<int64_t>(K);
    float* Pcur = a.P + cur * 6 * static_cast<int64_t>(K);
    // this iteration's p of pose n: p_0 = z_0; after, z + beta p_prev
    auto pval = [&](int n, float* v) {
      if (it == 0) {
        load6(a.P + 6 * static_cast<int64_t>(n), v, true);
      } else {
        for (int c = 0; c < 6; ++c)
          v[c] = add(__ldcg(a.z + 6 * n + c), mul(beta, __ldcg(Pprev + 6 * n + c)));
      }
    };
    for (int p = gw; p < K; p += nwarps) {
      float pp[6];
      pval(p, pp);
      if (it > 0 && lane < 6) Pcur[6 * p + lane] = pp[lane];
      const int bcomp = lane < 6 ? lane : 0;
      float si = 0.0f, sj = 0.0f;
      for_each_edge(bmi0 + static_cast<int64_t>(p) * a.nw, a.nw, [&](int e) {
        const float* row = a.rows + kRow * static_cast<int64_t>(e);
        float xj[6];
        pval(__ldg(a.ij + 2 * e + 1), xj);
        float u = mul(__ldg(row + kHii + 6 * bcomp), pp[0]);
        float v = mul(__ldg(row + kHij + 6 * bcomp), xj[0]);
        for (int c = 1; c < 6; ++c) {
          u = add(u, mul(__ldg(row + kHii + 6 * bcomp + c), pp[c]));
          v = add(v, mul(__ldg(row + kHij + 6 * bcomp + c), xj[c]));
        }
        si = add(si, add(u, v));
      });
      for_each_edge(bmj0 + static_cast<int64_t>(p) * a.nw, a.nw, [&](int e) {
        const float* row = a.rows + kRow * static_cast<int64_t>(e);
        float xi[6];
        pval(__ldg(a.ij + 2 * e), xi);
        float u = mul(__ldg(row + kHij + bcomp), xi[0]);
        float v = mul(__ldg(row + kHjj + 6 * bcomp), pp[0]);
        for (int c = 1; c < 6; ++c) {
          u = add(u, mul(__ldg(row + kHij + 6 * c + bcomp), xi[c]));
          v = add(v, mul(__ldg(row + kHjj + 6 * bcomp + c), pp[c]));
        }
        sj = add(sj, add(u, v));
      });
      const float dv = p == 0 ? add(a.damping, 1e6f) : a.damping;
      const float y = add(add(si, sj), mul(dv, pp[bcomp]));
      float Ap[6];
      for (int c = 0; c < 6; ++c) Ap[c] = __shfl_sync(kFull, y, c);
      if (lane < 6) a.Ap[6 * p + lane] = y;
      if (lane == 0) pAp[p] = dot6(pp, Ap);
    }
    grid.sync();
    const float alpha = dvd(rz, clamp_lo(ordered_sum<true>(pAp, K, 1), 1e-30f));
    for (int p = gw; p < K; p += nwarps) {
      float pp[6], x[6], r[6], Ap[6], z[6];
      pval(p, pp);
      load6(a.x + 6 * p, x, false);
      load6(a.r + 6 * p, r, false);
      load6(a.Ap + 6 * p, Ap, false);
      for (int c = 0; c < 6; ++c) {
        x[c] = add(x[c], mul(alpha, pp[c]));
        r[c] = sub(r[c], mul(alpha, Ap[c]));
      }
      chol6_solve(a.L + 36 * static_cast<int64_t>(p), r, z);
      __syncwarp();
      if (lane < 6) {
        a.x[6 * p + lane] = x[lane];
        a.r[6 * p + lane] = r[lane];
        a.z[6 * p + lane] = z[lane];
      }
      if (lane == 0) {
        prz[p] = dot6(r, z);
        prr[p] = dot6(r, r);
      }
    }
    grid.sync();
    const float rz_new = ordered_sum<true>(prz, K, 1);
    rr = ordered_sum<true>(prr, K, 1);
    beta = dvd(rz_new, clamp_lo(rz, 1e-30f));
    rz = rz_new;
    ++it;
  }
  // ok = every factor and x finite; delta = ok ? x : 0; retract
  for (int p = gw; p < K; p += nwarps) {
    bool fine = a.flags[p] != 0;
    for (int c = 0; c < 6; ++c) fine = fine && isfinite(a.x[6 * p + c]);
    __syncwarp();
    if (lane == 0) a.flags[p] = fine ? 1 : 0;
  }
  grid.sync();
  bool fine = true;
  for (int k = threadIdx.x; k < K; k += kThreads) fine = fine && __ldcg(a.flags + k) != 0;
  const bool ok = __syncthreads_and(fine);
  for (int p = gw; p < K; p += nwarps) {
    float d[6];
    for (int c = 0; c < 6; ++c) d[c] = ok ? a.x[6 * p + c] : 0.0f;
    if (lane == 0) retract(a.poses + 16 * static_cast<int64_t>(p), d,
                           a.out + 16 * static_cast<int64_t>(p));
    if (lane < 6) a.delta[6 * p + lane] = d[lane];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.iters_out = it;
}

int cg_ctas(int K, int dev, int* out) {
  static int per_sm[kMaxDevices], sms[kMaxDevices];   // 0: not asked yet
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int blocks = 0, count = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cg_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    per_sm[dev] = blocks;
    sms[dev] = count;
  }
  const int want = (K + kWarps - 1) / kWarps;
  const int most = per_sm[dev] * sms[dev];
  *out = want < most ? want : most;
  return 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on ``stream``
// and returns a CUDA error code as an int (0 = launched).  Every tensor is
// float32 (int32 for indices, info and flags), contiguous, on the card.

// K13a.  poses (K, 4, 4), edges_ij (E, 2), edges_T (E, 4, 4), edges_w (E,);
// robust 0 off, 1 Geman-McClure (rho = delta^2), 2 Huber (rho = delta);
// mode 0 chi2 only, 1 dense (H (6K, 6K); diag != 0 adds the anchor and
// damping), 2 CG (H = Hd (K, 6, 6) with them); rows (E, 128), J (E, 6,
// 12), r (E, 6), bitmaps (2, K, ceil(E / 32)) words, b (K, 6), chi2 (1,).
extern "C" int pg_edge_blocks(const float* poses, const int* ij, const float* Z,
                              const float* w, int K, int E, int robust, float rho,
                              int mode, int diag, float damping, float* rows, float* J,
                              float* r, unsigned* bm, float* b, float* chi2, float* H,
                              void* stream) {
  if (K < 1 || E < 1 || mode < kModeChi2 || mode > kModeCg || robust < kRobustOff ||
      robust > kRobustHuber)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  EdgeArgs ea{poses, ij, Z, w, K, E, robust, rho, rows, J, r};
  const int edge_ctas = (E + kEdgesPerCta - 1) / kEdgesPerCta;
  if (mode == kModeChi2)
    edge_kernel<false><<<edge_ctas, kThreads, 0, s>>>(ea);
  else
    edge_kernel<true><<<edge_ctas, kThreads, 0, s>>>(ea);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  AsmArgs aa{rows, ij, w, K, E, (E + 31) / 32, mode, diag, damping, bm, b, chi2, H};
  const int asm_ctas = mode == kModeChi2 ? 1 : (K + 1 + kWarps - 1) / kWarps;
  if (mode == kModeChi2) aa.K = 0;          // warp 0 sums chi2
  assemble_kernel<<<asm_ctas, kThreads, 0, s>>>(aa);
  return static_cast<int>(cudaGetLastError());
}

// K13b.  rows, edges_ij and bitmaps of a K13a CG-mode call, its Hd and b;
// scratch: floats (K * 36 + 6 * K * 6 + 4 * K), ints (K,); out poses (K,
// 4, 4), delta (K, 6), iterations (1,).
extern "C" int pg_cg_solve(const float* rows, const int* ij, const unsigned* bm,
                           const float* Hd, const float* bblk, const float* poses, int K,
                           int E, int iters, float damping, float tol2f, float* scratch,
                           int* flags, float* out, float* delta, int* iters_out,
                           void* stream) {
  if (K < 1 || E < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int ctas = 0;
  const int rc = cg_ctas(K, dev, &ctas);
  if (rc != 0) return rc;
  const int64_t k6 = 6 * static_cast<int64_t>(K);
  CgArgs a{};
  a.rows = rows;
  a.ij = ij;
  a.bm = bm;
  a.Hd = Hd;
  a.bblk = bblk;
  a.poses = poses;
  a.K = K;
  a.nw = (E + 31) / 32;
  a.iters = iters;
  a.damping = damping;
  a.tol2f = tol2f;
  a.L = scratch;
  a.x = a.L + 6 * k6;
  a.r = a.x + k6;
  a.z = a.r + k6;
  a.Ap = a.z + k6;
  a.P = a.Ap + k6;
  a.part = a.P + 2 * k6;
  a.flags = flags;
  a.out = out;
  a.delta = delta;
  a.iters_out = iters_out;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, cg_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K13c.  delta (K * 6,), info (1,) int32, poses (K, 4, 4); out (K, 4, 4),
// used (K, 6): the delta applied.
extern "C" int pg_retract(const float* delta, const int* info, const float* poses, int K,
                          float* out, float* used, void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  retract_kernel<<<(K + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(delta, info, poses, K, out, used);
  return static_cast<int>(cudaGetLastError());
}
