"""Keyframe pose graph optimization, bundle adjustment over poses (port of
ops/pose_graph.py).

- The graph is padded tensors: poses (K, 4, 4) and edges (indices, SE(3)
  measurements, scalar weights).  Padding edges are (0, 0, identity,
  weight 0), so they add exact zeros.  ``num_poses`` / ``num_edges`` are
  host integers (the JAX version keeps them as device scalars); ``add_pose``
  and ``add_edge`` write the padded tensors in place.
- Residual per edge (i, j): ``r = log(Z_ij^-1 T_i^-1 T_j)`` in se(3).
- Gauss-Newton with the right perturbation ``T_i <- T_i exp(xi_i)``.  Each
  edge's exact 6x12 Jacobian is a forward-mode tangent through the
  inverse, the products and the logarithm (with the logarithm's own
  branches), the value ``jax.jacfwd`` gives; J^T W J and J^T W r are the
  edge's 6x6 blocks: O(E) build cost.
- Two inner solvers share the build (``KeyframeConfig.ba_solver``): a dense
  6K x 6K Cholesky (the library's ``cholesky_ex`` / ``cholesky_solve``),
  and matrix-free block-Jacobi-preconditioned CG.  "auto" takes CG once
  the capacity K exceeds ``ba_dense_max_k``.
- On CUDA tensors a Gauss-Newton step is hand kernels with no host read
  (csrc/pose_graph.cu): K13a ``pg_edge_blocks`` (the edge blocks, b, chi2
  and the dense H or the CG operands), K13b ``pg_cg_solve`` (the whole CG
  loop and the retract, one cooperative launch) and K13c ``pg_retract``
  (the dense step's guard and retract).  On CPU tensors the plain versions
  below compute the same in the same order (csrc/pose_graph.cu's header
  gives the order of every sum); ``optimize_reference`` runs them on any
  device.  ``LAUNCHES_EDGE_BLOCKS``, ``LAUNCHES_CG`` and
  ``LAUNCHES_RETRACT`` count the kernels' launches.
- A factorization that fails gives no update (``cholesky_ex`` and its
  ``info``; a 6x6 pivot that is not positive in CG), where the JAX version
  turns the NaN solve into zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import KeyframeConfig
from ..device import resolve
from ..geometry import se3
from ..geometry.f32 import recip

LAUNCHES_EDGE_BLOCKS = 0     # K13a pg_edge_blocks
LAUNCHES_CG = 0              # K13b pg_cg_solve
LAUNCHES_RETRACT = 0         # K13c pg_retract

ROW = 128                    # floats of an edge row (csrc/pose_graph.cu)
_HII, _HIJ, _HJJ, _BI, _BJ, _T, _EW = 0, 36, 72, 108, 114, 120, 121
MODES = {"chi2": 0, "dense": 1, "cg": 2}
_ROBUST = {"gm": 1, "huber": 2}
MAX_POSES = 1 << 16          # K13a-c: poses a graph
MAX_EDGES = 1 << 24          # edges a graph
MAX_DENSE_POSES = 4096       # the dense H of K13a: (6K)^2 floats, 32-bit rows

_R6, _R12, _R120, _R720, _R5040, _R30240 = (
    recip(6.0), recip(12.0), recip(120.0), recip(720.0), recip(5040.0),
    recip(30240.0))


class PoseGraph(NamedTuple):
    """Padded pose graph."""

    poses: torch.Tensor      # [K, 4, 4] camera-to-world keyframe poses
    num_poses: int           # rows >= num_poses are identity pads
    edges_ij: torch.Tensor   # [E, 2] int32 (i, j) pose indices; pads (0, 0)
    edges_T: torch.Tensor    # [E, 4, 4] measured T_i^-1 @ T_j; pads identity
    edges_w: torch.Tensor    # [E] float32 information weight; pads 0
    num_edges: int


class BAInfo(NamedTuple):
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iters: int


class EdgeSystem(NamedTuple):
    """What K13a (or its plain version) gives for a graph: ``rows`` (E,
    128) the edges' Hii, Hij, Hjj (36 each, row-major), bi, bj (6 each),
    w |r|^2 and w (the robust weight); ``J`` (E, 6, 12) and ``r`` (E, 6);
    ``b`` (K, 6); ``chi2`` 0-d; ``H`` the dense (6K, 6K) H or the CG mode's
    block diagonal (K, 6, 6) with damping and anchor; ``bitmaps`` (2, K,
    ceil(E / 32)) int32, the kernel's edge lists (None from the plain
    version).  Modes leave out what they do not compute (None)."""

    rows: torch.Tensor
    J: Optional[torch.Tensor]
    r: torch.Tensor
    b: Optional[torch.Tensor]
    chi2: torch.Tensor
    H: Optional[torch.Tensor]
    bitmaps: Optional[torch.Tensor]


def _eyes(n: int, device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).repeat(n, 1, 1)


def create(max_keyframes: int, max_edges: int, device=None) -> PoseGraph:
    """Empty graph on ``device`` (None: the CUDA card)."""
    device = resolve(device)
    return PoseGraph(
        poses=_eyes(max_keyframes, device),
        num_poses=0,
        edges_ij=torch.zeros((max_edges, 2), dtype=torch.int32,
                             device=device),
        edges_T=_eyes(max_edges, device),
        edges_w=torch.zeros((max_edges,), dtype=torch.float32,
                            device=device),
        num_edges=0,
    )


def grow(graph: PoseGraph, max_keyframes: int, max_edges: int) -> PoseGraph:
    """Re-pad the tensors to larger capacities; contents and counts are
    kept bit for bit, the new rows are ``create``'s padding."""
    K, E = graph.poses.shape[0], graph.edges_ij.shape[0]
    if max_keyframes < K or max_edges < E:
        raise ValueError(f"grow must not shrink: {(K, E)} -> "
                         f"{(max_keyframes, max_edges)}")
    dev = graph.poses.device
    return graph._replace(
        poses=torch.cat([graph.poses, _eyes(max_keyframes - K, dev)]),
        edges_ij=torch.cat([
            graph.edges_ij,
            torch.zeros((max_edges - E, 2), dtype=torch.int32, device=dev)]),
        edges_T=torch.cat([graph.edges_T, _eyes(max_edges - E, dev)]),
        edges_w=torch.cat([
            graph.edges_w,
            torch.zeros((max_edges - E,), dtype=torch.float32, device=dev)]),
    )


def add_pose(graph: PoseGraph, T) -> PoseGraph:
    """Append a keyframe pose (no-op at capacity)."""
    k = graph.num_poses
    if k >= graph.poses.shape[0]:
        return graph
    graph.poses[k] = torch.as_tensor(T, dtype=torch.float32,
                                     device=graph.poses.device)
    return graph._replace(num_poses=k + 1)


def add_edge(graph: PoseGraph, i: int, j: int, T_ij,
             weight: float = 1.0) -> PoseGraph:
    """Append a relative-pose constraint (no-op at capacity)."""
    e = graph.num_edges
    if e >= graph.edges_ij.shape[0]:
        return graph
    dev = graph.poses.device
    graph.edges_ij[e] = torch.tensor([int(i), int(j)], dtype=torch.int32,
                                     device=dev)
    graph.edges_T[e] = torch.as_tensor(T_ij, dtype=torch.float32, device=dev)
    graph.edges_w[e] = float(weight)
    return graph._replace(num_edges=e + 1)


def edge_residuals(poses: torch.Tensor, edges_ij: torch.Tensor,
                   edges_T: torch.Tensor) -> torch.Tensor:
    """se(3) residuals r_e = log(Z_e^-1 T_i^-1 T_j)  ->  (E, 6)."""
    Ti = poses[edges_ij[:, 0].long()]
    Tj = poses[edges_ij[:, 1].long()]
    pred = se3.inverse(Ti) @ Tj
    return se3.log(se3.inverse(edges_T) @ pred)


def robust_edge_weights(graph: PoseGraph, delta,
                        kernel: str = "gm") -> torch.Tensor:
    """IRLS robust-kernel edge weights -> (E,), re-evaluated about the
    current poses.  ``"gm"``: Geman-McClure ``delta^2 / (delta^2 +
    |r|^2)``, redescending; ``"huber"``: ``min(1, delta / |r|)``.
    ``delta`` is a Python float, or a ``np.float32`` from ``gnc_delta``
    (then its square is a float32 product, as in the JAX loop)."""
    r = edge_residuals(graph.poses, graph.edges_ij, graph.edges_T)
    if kernel == "gm":
        rn2 = torch.sum(r * r, dim=-1)
        d2 = float(delta * delta)
        h = d2 / (d2 + rn2)
    elif kernel == "huber":
        rn = torch.linalg.vector_norm(r, dim=-1)
        h = torch.clamp(float(delta) / torch.clamp(rn, min=1e-12), max=1.0)
    else:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    return graph.edges_w * h


# --------------------------------------------------------------------------
# plain versions: one rounding an operation, in the kernels' order
# --------------------------------------------------------------------------

def _s3(a, b, c):
    return (a + b) + c


def _split(T: torch.Tensor):
    """(N, 4, 4) -> R (3 x 3 list) and t (3 list) of (N, 1) columns."""
    return ([[T[:, i, j, None] for j in range(3)] for i in range(3)],
            [T[:, i, 3, None] for i in range(3)])


def _mm3(A, B):
    return [[_s3(A[i][0] * B[0][j], A[i][1] * B[1][j], A[i][2] * B[2][j])
             for j in range(3)] for i in range(3)]


def _mv3(A, v):
    return [_s3(A[i][0] * v[0], A[i][1] * v[1], A[i][2] * v[2])
            for i in range(3)]


def _inverse(R, t):
    """se3.inverse: [R^T, -(R^T t)]."""
    Rt = [[R[j][i] for j in range(3)] for i in range(3)]
    return Rt, [-x for x in _mv3(Rt, t)]


def _compose(Ra, ta, Rb, tb):
    """A @ B of two rigid transforms (the zero bottom-row terms dropped)."""
    return _mm3(Ra, Rb), [x + y for x, y in zip(_mv3(Ra, tb), ta)]


def _hat(w):
    z = torch.zeros_like(w[0])
    return [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]


def _rot_dir(R, a: int, i: int, j: int, zero):
    """Entry (i, j) of R hat(e_a) = column j of R (e_a x e_j)."""
    if j == a:
        return zero
    m = 3 - a - j
    return R[i][m] if (j - a) % 3 == 1 else -R[i][m]


def _log_value(R, t) -> dict:
    """se3.log's value path at (R, t), kept for the tangents; ``r`` the six
    residual columns."""
    L = {"t": t}
    ws = [0.5 * (R[2][1] - R[1][2]), 0.5 * (R[0][2] - R[2][0]),
          0.5 * (R[1][0] - R[0][1])]
    s2 = _s3(ws[0] * ws[0], ws[1] * ws[1], ws[2] * ws[2])
    x = ((R[0][0] + R[1][1]) + R[2][2] - 1.0) * 0.5
    L["pass"] = (x >= -1.0) & (x <= 1.0)
    c = torch.clamp(x, -1.0, 1.0)
    s = torch.sqrt(s2 + 1e-24)
    theta = torch.atan2(s, c)
    th2 = theta * theta
    q = theta / s
    w = [q * v for v in ws]
    thu = torch.sqrt(th2 + 1e-16)
    small = th2 < 1e-2
    A = torch.where(small, (1.0 - th2 * _R6) + (th2 * th2) * _R120,
                    torch.sin(thu) / thu)
    half = 0.5 * thu
    shalf = torch.sin(half) / half
    B = (0.5 * shalf) * shalf
    coef = torch.where(small, (_R12 + th2 * _R720) + (th2 * th2) * _R30240,
                       (1.0 - A / (2.0 * B)) / torch.clamp(th2, min=1e-8))
    K = _hat(w)
    K2 = _mm3(K, K)
    Vi = [[((1.0 if i == j else 0.0) - 0.5 * K[i][j]) + coef * K2[i][j]
           for j in range(3)] for i in range(3)]
    L.update(ws=ws, s=s, c=c, theta=theta, th2=th2, q=q, thu=thu, small=small,
             A=A, half=half, shalf=shalf, B=B, coef=coef, K=K, K2=K2, Vi=Vi)
    L["r"] = _mv3(Vi, t) + w
    return L


def _log_tangent(L: dict, dR, dt):
    """The tangent of se3.log at ``L`` along (dR, dt) -> six columns."""
    ws, s, c, q = L["ws"], L["s"], L["c"], L["q"]
    dws = [0.5 * (dR[2][1] - dR[1][2]), 0.5 * (dR[0][2] - dR[2][0]),
           0.5 * (dR[1][0] - dR[0][1])]
    ds = _s3(ws[0] * dws[0], ws[1] * dws[1], ws[2] * dws[2]) / s
    dtr = (dR[0][0] + dR[1][1]) + dR[2][2]
    dc = torch.where(L["pass"], dtr * 0.5, torch.zeros_like(dtr))
    dth = (c * ds - s * dc) / (s * s + c * c)
    dq = (dth - q * ds) / s
    dw = [dq * ws[k] + q * dws[k] for k in range(3)]
    th2, thu, A, B = L["th2"], L["thu"], L["A"], L["B"]
    dth2 = (2.0 * L["theta"]) * dth
    d_small = dth2 * (_R720 + (2.0 * th2) * _R30240)
    dthu = dth2 / (2.0 * thu)
    dA = (dthu * (torch.cos(thu) - A)) / thu
    dhalf = 0.5 * dthu
    dB = L["shalf"] * ((dhalf * (torch.cos(L["half"]) - L["shalf"]))
                       / L["half"])
    B2 = 2.0 * B
    g = A / B2
    dg = (dA - g * (2.0 * dB)) / B2
    d_big = (-dg - L["coef"] * dth2) / torch.clamp(th2, min=1e-8)
    dcoef = torch.where(L["small"], d_small, d_big)
    K, K2, Vi, t = L["K"], L["K2"], L["Vi"], L["t"]
    dK = _hat(dw)
    P1, P2 = _mm3(dK, K), _mm3(K, dK)
    dVi = [[(dcoef * K2[i][j] + L["coef"] * (P1[i][j] + P2[i][j]))
            - 0.5 * dK[i][j] for j in range(3)] for i in range(3)]
    return [x + y for x, y in zip(_mv3(dVi, t), _mv3(Vi, dt))] + dw


def _edge_r_J(Ti: torch.Tensor, Tj: torch.Tensor, Z: torch.Tensor,
              jac: bool = True):
    """Residuals (E, 6) and, with ``jac``, the (E, 6, 12) Jacobians with
    respect to the right perturbations of T_i (columns 0-5) and T_j (6-11)
    at zero: forward-mode tangents, as K13a computes them."""
    Ri, ti = _split(Ti)
    Rj, tj = _split(Tj)
    Rz, tz = _split(Z)
    Rzi, tzi = _inverse(Rz, tz)
    Rii, tii = _inverse(Ri, ti)
    RP, tP = _compose(Rzi, tzi, Rii, tii)
    RM, tM = _compose(RP, tP, Rj, tj)
    L = _log_value(RM, tM)
    r = torch.cat(L["r"], dim=1)
    if not jac:
        return r, None
    z1 = torch.zeros_like(Ri[0][0])

    def dirs(R):
        """(dR, dt) of the six directions R dE_q (q < 3 translations)."""
        dR = [[torch.cat([z1] * 3 + [_rot_dir(R, a, i, j, z1)
                                     for a in range(3)], 1)
               for j in range(3)] for i in range(3)]
        dt = [torch.cat([R[i][k] for k in range(3)] + [z1] * 3, 1)
              for i in range(3)]
        return dR, dt

    # T_j side: M exp(xi) -> M dE
    dRj, dtj = dirs(RM)
    # T_i side: D = T_i dE, the inverse's tangent, then Z^-1 (.) T_j
    D, Dt = dirs(Ri)
    IR = [[D[l][m] for l in range(3)] for m in range(3)]
    It = [-(x + y) for x, y in zip(_mv3(IR, ti), _mv3(Rii, Dt))]
    XR = _mm3(Rzi, IR)
    Xt = _mv3(Rzi, It)
    dRi = _mm3(XR, Rj)
    dti = [x + y for x, y in zip(_mv3(XR, tj), Xt)]
    dR = [[torch.cat([dRi[i][j], dRj[i][j]], 1) for j in range(3)]
          for i in range(3)]
    dt = [torch.cat([dti[i], dtj[i]], 1) for i in range(3)]
    J = torch.stack(_log_tangent(L, dR, dt), dim=1)
    return r, J


def _seq(P: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in index order from its first term."""
    s = P.select(dim, 0)
    for k in range(1, P.shape[dim]):
        s = s + P.select(dim, k)
    return s


def _osum(v: torch.Tensor) -> torch.Tensor:
    """The kernels' ordered sum of a 1-D tensor: lane l of a warp sums
    v[l], v[l + 32], ... (zeros past the end), then the shuffle-down tree
    (16, 8, 4, 2, 1).  0-d."""
    n = v.shape[0]
    m = max(1, -(-n // 32))
    pad = torch.zeros(32 * m, dtype=v.dtype, device=v.device)
    pad[:n] = v
    rows = pad.view(m, 32)
    s = rows[0]
    for k in range(1, m):
        s = s + rows[k]
    for off in (16, 8, 4, 2, 1):
        s = s[:off] + s[off:2 * off]
    return s[0]


def _dot6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, 6) . (K, 6) per row, six products in order."""
    return _seq(a * b, 1)


def _robust_params(robust_delta, kernel: str):
    """(kernel id, rho) of K13a: 0 off; gm: rho = delta^2 (float32
    product for a ``np.float32`` delta, float64 then rounded for a Python
    float, as JAX squares each); huber: rho = delta."""
    if robust_delta is not None and robust_delta <= 0:
        robust_delta = None
    if robust_delta is None:
        return 0, 0.0
    if kernel not in _ROBUST:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    if kernel == "gm":
        return 1, float(np.float32(robust_delta * robust_delta))
    return 2, float(np.float32(robust_delta))


def edge_rows_reference(poses, edges_ij, edges_T, edges_w, robust: int = 0,
                        rho: float = 0.0, jac: bool = True):
    """Plain K13a, the edge kernel: (rows (E, 128), J or None, r).  Without
    ``jac`` only the rows' w |r|^2 and w columns are filled (robust off,
    the chi2 mode)."""
    i_idx, j_idx = edges_ij[:, 0].long(), edges_ij[:, 1].long()
    r, J = _edge_r_J(poses[i_idx], poses[j_idx], edges_T, jac)
    rn2 = _seq(r * r, 1)
    w = edges_w
    if robust == 1:
        rho_t = torch.full_like(rn2, rho)
        w = w * torch.div(rho_t, rho_t + rn2)
    elif robust == 2:
        rho_t = torch.full_like(rn2, rho)
        h = torch.div(rho_t, torch.clamp(torch.sqrt(rn2), min=1e-12))
        w = w * torch.clamp(h, max=1.0)
    t = w * rn2
    E = r.shape[0]
    rows = torch.zeros((E, ROW), dtype=torch.float32, device=r.device)
    rows[:, _T], rows[:, _EW] = t, w
    if jac:
        wJ = J * w[:, None, None]
        Ji, Jj, wJi, wJj = J[:, :, :6], J[:, :, 6:], wJ[:, :, :6], wJ[:, :, 6:]
        for col, (left, right) in zip((_HII, _HIJ, _HJJ),
                                      ((wJi, Ji), (wJi, Jj), (wJj, Jj))):
            rows[:, col:col + 36] = _seq(
                left[:, :, :, None] * right[:, :, None, :], 1).reshape(E, 36)
        rows[:, _BI:_BI + 6] = _seq(wJi * r[:, :, None], 1)
        rows[:, _BJ:_BJ + 6] = _seq(wJj * r[:, :, None], 1)
    return rows, J, r


def _scatter(n, idx, src: torch.Tensor) -> torch.Tensor:
    """Sum of ``src`` rows into ``n`` (an int or a shape tuple) zeroed
    slots by ``idx``, each slot in edge order from 0."""
    shape = (n,) if isinstance(n, int) else tuple(n)
    out = torch.zeros(shape + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    return out.index_put_(idx, src, accumulate=True)


def _blocks(rows: torch.Tensor):
    E = rows.shape[0]
    return tuple(rows[:, c:c + 36].reshape(E, 6, 6)
                 for c in (_HII, _HIJ, _HJJ))


def assemble_reference(rows, edges_ij, K: int, mode: str, diag: bool = False,
                       damping: float = 0.0):
    """Plain K13a, the assembly: (b (K, 6) or None, chi2 0-d, H or None)
    in the order of csrc/pose_graph.cu's header."""
    chi2 = _osum(rows[:, _T])
    if mode == "chi2":
        return None, chi2, None
    i_idx, j_idx = edges_ij[:, 0].long(), edges_ij[:, 1].long()
    b = (_scatter(K, (i_idx,), rows[:, _BI:_BI + 6])
         + _scatter(K, (j_idx,), rows[:, _BJ:_BJ + 6]))
    Hii, Hij, Hjj = _blocks(rows)
    dev = rows.device
    if mode == "cg":
        diagv = torch.full((K, 6), damping, dtype=torch.float32, device=dev)
        diagv[0] += 1e6
        Hd = ((_scatter(K, (i_idx,), Hii) + _scatter(K, (j_idx,), Hjj))
              + torch.diag_embed(diagv))
        return b, chi2, Hd
    KK = (K, K)
    Hblk = (((_scatter(KK, (i_idx, i_idx), Hii)
              + _scatter(KK, (i_idx, j_idx), Hij))
             + _scatter(KK, (j_idx, i_idx), Hij.transpose(1, 2)))
            + _scatter(KK, (j_idx, j_idx), Hjj))
    H = Hblk.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    if diag:
        anchor = torch.zeros((K * 6,), dtype=torch.float32, device=dev)
        anchor[:6] = 1e6
        H = H + torch.diag(anchor) + damping * torch.eye(
            K * 6, dtype=torch.float32, device=dev)
    return b, chi2, H


def edge_system_reference(graph: PoseGraph, mode: str, robust_delta=None,
                          robust_kernel: str = "gm", diag: bool = False,
                          damping: float = 0.0) -> EdgeSystem:
    """Plain K13a on the graph's device."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    robust, rho = (_robust_params(robust_delta, robust_kernel)
                   if mode != "chi2" else (0, 0.0))
    rows, J, r = edge_rows_reference(graph.poses, graph.edges_ij,
                                     graph.edges_T, graph.edges_w, robust,
                                     rho, jac=mode != "chi2")
    b, chi2, H = assemble_reference(rows, graph.edges_ij,
                                    graph.poses.shape[0], mode, diag, damping)
    return EdgeSystem(rows=rows, J=J, r=r, b=b, chi2=chi2, H=H, bitmaps=None)


def _chol6_reference(A: torch.Tensor):
    """(K, 6, 6) -> (L as a 6 x 6 list of (K,) columns, ok (K,)): entry
    (i, j) subtracts L[i][q] L[j][q] for q < j in order, then takes the
    square root or divides; ok = every pivot > 0."""
    L = [[None] * 6 for _ in range(6)]
    ok = torch.ones(A.shape[0], dtype=torch.bool, device=A.device)
    for j in range(6):
        for i in range(j, 6):
            v = A[:, i, j]
            for q in range(j):
                v = v - L[i][q] * L[j][q]
            if i == j:
                ok = ok & (v > 0)
                L[j][j] = torch.sqrt(v)
            else:
                L[i][j] = v / L[j][j]
    return L, ok


def _chol6_solve_reference(L, r: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 r for (K, 6) r: forward, then back substitution."""
    y = []
    for i in range(6):
        t = r[:, i]
        for q in range(i):
            t = t - L[i][q] * y[q]
        y.append(t / L[i][i])
    z = [None] * 6
    for i in range(5, -1, -1):
        t = y[i]
        for q in range(i + 1, 6):
            t = t - L[q][i] * z[q]
        z[i] = t / L[i][i]
    return torch.stack(z, dim=1)


def _exp_reference(xi: torch.Tensor):
    """se3.exp of (K, 6) twists as K13b / K13c compute it: (R, t) lists
    of (K,) columns."""
    v = [xi[:, k] for k in range(3)]
    w = [xi[:, 3 + k] for k in range(3)]
    theta2 = _s3(w[0] * w[0], w[1] * w[1], w[2] * w[2])
    theta = torch.sqrt(theta2 + 1e-16)
    small = theta2 < 1e-2
    t4 = theta2 * theta2
    A = torch.where(small, (1.0 - theta2 * _R6) + t4 * _R120,
                    torch.sin(theta) / theta)
    half = 0.5 * theta
    s_half = torch.sin(half) / half
    B = (0.5 * s_half) * s_half
    C = torch.where(small, (_R6 - theta2 * _R120) + t4 * _R5040,
                    (1.0 - A) / theta2)
    K = _hat(w)
    K2 = _mm3(K, K)
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    R = [[(A * K[i][j] + eye[i][j]) + B * K2[i][j] for j in range(3)]
         for i in range(3)]
    V = [[(B * K[i][j] + eye[i][j]) + C * K2[i][j] for j in range(3)]
         for i in range(3)]
    return R, _mv3(V, v)


def retract_poses_reference(poses: torch.Tensor,
                            delta: torch.Tensor) -> torch.Tensor:
    """T_k exp(delta_k) as the kernels compute it: rows 0-2 of T @ E, row 3
    T's."""
    R, t = _exp_reference(delta)
    out = poses.clone()
    for i in range(3):
        Ti = [poses[:, i, k] for k in range(4)]
        for j in range(3):
            out[:, i, j] = _s3(Ti[0] * R[0][j], Ti[1] * R[1][j],
                               Ti[2] * R[2][j])
        out[:, i, 3] = _s3(Ti[0] * t[0], Ti[1] * t[1], Ti[2] * t[2]) + Ti[3]
    return out


def retract_reference(delta: torch.Tensor, info: torch.Tensor,
                      poses: torch.Tensor):
    """Plain K13c: ok = (info == 0) and every delta finite; (poses
    retracted by ok ? delta : 0, the delta applied (K, 6))."""
    K = poses.shape[0]
    ok = (info == 0) & torch.all(torch.isfinite(delta))
    used = torch.where(ok, delta, 0.0).reshape(K, 6)
    return retract_poses_reference(poses, used), used


def cg_reference(system: EdgeSystem, graph: PoseGraph, cfg: KeyframeConfig):
    """Plain K13b: the block-Jacobi PCG of ``solve_delta_cg`` on a CG-mode
    ``system``, then the retract.  (poses, delta (K, 6), iterations 0-d);
    the loop condition is read on the host (this version only)."""
    K = graph.poses.shape[0]
    i_idx = graph.edges_ij[:, 0].long()
    j_idx = graph.edges_ij[:, 1].long()
    Hii, Hij, Hjj = _blocks(system.rows)
    HijT = Hij.transpose(1, 2)
    dev = graph.poses.device
    diagv = torch.full((K, 6), cfg.ba_damping, dtype=torch.float32,
                       device=dev)
    diagv[0] += 1e6
    L, factored = _chol6_reference(system.H)

    def mv(H, x):                        # (E, 6, 6) (E, 6): rows in order
        return _seq(H * x[:, None, :], 2)

    def matvec(p):
        xi, xj = p[i_idx], p[j_idx]
        yi = mv(Hii, xi) + mv(Hij, xj)
        yj = mv(HijT, xi) + mv(Hjj, xj)
        return ((_scatter(K, (i_idx,), yi) + _scatter(K, (j_idx,), yj))
                + diagv * p)

    def dot(a, b):
        return _osum(_dot6(a, b))

    b = -system.b
    bb = dot(b, b)
    tol2 = bb * float(np.float32(cfg.ba_cg_tol ** 2))
    x = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    r = b
    z = _chol6_solve_reference(L, r)
    p = z
    rz = dot(r, z)
    rr = bb
    it = 0
    while it < cfg.ba_cg_iters and bool(rr > tol2):
        Ap = matvec(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = _chol6_solve_reference(L, r)
        rz_new = dot(r, z)
        rr = dot(r, r)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    ok = torch.all(factored) & torch.all(torch.isfinite(x))
    delta = torch.where(ok, x, 0.0)
    return (retract_poses_reference(graph.poses, delta), delta,
            torch.tensor(it, dtype=torch.int32))


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_graph(graph: PoseGraph):
    """Check what K13a takes and return (poses, edges_ij, edges_T,
    edges_w) contiguous, or raise."""
    t = (graph.poses, graph.edges_ij, graph.edges_T, graph.edges_w)
    dev = t[0].device
    if dev.type != "cuda" or any(x.device != dev for x in t):
        raise ValueError("pose graph: poses and edges must lie on one CUDA "
                         "device (or all on the CPU)")
    K, E = t[0].shape[0], t[1].shape[0]
    if (tuple(t[0].shape) != (K, 4, 4) or tuple(t[1].shape) != (E, 2)
            or tuple(t[2].shape) != (E, 4, 4) or tuple(t[3].shape) != (E,)):
        raise ValueError(f"pose graph: poses (K, 4, 4), edges_ij (E, 2), "
                         f"edges_T (E, 4, 4), edges_w (E,) expected, got "
                         f"{[tuple(x.shape) for x in t]}")
    if (t[1].dtype != torch.int32
            or any(x.dtype != torch.float32 for x in (t[0], t[2], t[3]))):
        raise ValueError("pose graph: float32 poses, edges_T and edges_w, "
                         "int32 edges_ij expected")
    if not (1 <= K <= MAX_POSES and 1 <= E <= MAX_EDGES):
        raise ValueError(f"pose graph: 1 to {MAX_POSES} poses and 1 to "
                         f"{MAX_EDGES} edges, got {K} and {E}")
    return tuple(x.contiguous() for x in t)


def edge_system(graph: PoseGraph, mode: str, robust_delta=None,
                robust_kernel: str = "gm", diag: bool = False,
                damping: float = 0.0) -> EdgeSystem:
    """K13a on CUDA tensors (one call, two launches on the current
    stream), ``edge_system_reference`` on CPU tensors.  ``mode``: "chi2"
    (chi2 of the base weights only), "dense" (H without the diagonal, or
    with anchor and damping when ``diag``), "cg" (Hd with them)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if _on_cpu(graph.poses, graph.edges_ij, graph.edges_T, graph.edges_w):
        return edge_system_reference(graph, mode, robust_delta,
                                     robust_kernel, diag, damping)
    poses, eij, eT, ew = _check_graph(graph)
    K, E = poses.shape[0], eij.shape[0]
    if mode == "dense" and K > MAX_DENSE_POSES:
        raise ValueError(f"pose graph: the dense H takes at most "
                         f"{MAX_DENSE_POSES} poses, got {K}")
    robust, rho = (_robust_params(robust_delta, robust_kernel)
                   if mode != "chi2" else (0, 0.0))
    dev = poses.device
    jac = mode != "chi2"
    n_rows, n_J, n_r = E * ROW, E * 72 if jac else 0, E * 6
    n_b = K * 6 if jac else 0
    buf = torch.empty(n_rows + n_J + n_r + n_b + 1, dtype=torch.float32,
                      device=dev)
    rows = buf[:n_rows].view(E, ROW)
    J = buf[n_rows:n_rows + n_J].view(E, 6, 12) if jac else None
    r = buf[n_rows + n_J:n_rows + n_J + n_r].view(E, 6)
    b = buf[n_rows + n_J + n_r:-1].view(K, 6) if jac else None
    chi2 = buf[-1:]
    H = bm = None
    if mode == "dense":
        H = torch.empty((6 * K, 6 * K), dtype=torch.float32, device=dev)
    elif mode == "cg":
        H = torch.empty((K, 6, 6), dtype=torch.float32, device=dev)
    if jac:
        bm = torch.empty((2, K, -(-E // 32)), dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    kernels.launch(
        "pg_edge_blocks", poses.get_device(), poses.data_ptr(),
        eij.data_ptr(), eT.data_ptr(), ew.data_ptr(), K, E, robust, rho,
        MODES[mode], int(diag), float(damping), rows.data_ptr(), ptr(J),
        r.data_ptr(), ptr(bm), ptr(b), chi2.data_ptr(), ptr(H))
    global LAUNCHES_EDGE_BLOCKS
    LAUNCHES_EDGE_BLOCKS += 1
    return EdgeSystem(rows=rows, J=J, r=r, b=b, chi2=chi2[0], H=H,
                      bitmaps=bm)


def cg_solve(system: EdgeSystem, graph: PoseGraph, cfg: KeyframeConfig):
    """K13b on CUDA tensors (one cooperative launch on the current stream),
    ``cg_reference`` on CPU tensors: the CG step of a CG-mode ``system``
    and the retract.  (poses (K, 4, 4), delta (K, 6), iterations 0-d
    int32)."""
    if _on_cpu(graph.poses, system.rows):
        return cg_reference(system, graph, cfg)
    poses, eij, _, _ = _check_graph(graph)
    K, E = poses.shape[0], eij.shape[0]
    if (system.bitmaps is None or system.H is None
            or tuple(system.H.shape) != (K, 6, 6)
            or tuple(system.rows.shape) != (E, ROW)):
        raise ValueError("pg_cg_solve takes the EdgeSystem of a CG-mode "
                         "K13a call on this graph")
    dev = poses.device
    floats = torch.empty(K * 36 + 6 * K * 6 + 4 * K + K * 16 + K * 6,
                         dtype=torch.float32, device=dev)
    ints = torch.empty(K + 1, dtype=torch.int32, device=dev)
    n_scratch = K * 36 + 6 * K * 6 + 4 * K
    out = floats[n_scratch:n_scratch + 16 * K].view(K, 4, 4)
    delta = floats[n_scratch + 16 * K:].view(K, 6)
    kernels.launch(
        "pg_cg_solve", poses.get_device(), system.rows.data_ptr(),
        eij.data_ptr(), system.bitmaps.data_ptr(), system.H.data_ptr(),
        system.b.data_ptr(), poses.data_ptr(), K, E, int(cfg.ba_cg_iters),
        float(cfg.ba_damping), float(np.float32(cfg.ba_cg_tol ** 2)),
        floats.data_ptr(), ints.data_ptr(), out.data_ptr(),
        delta.data_ptr(), ints[K:].data_ptr())
    global LAUNCHES_CG
    LAUNCHES_CG += 1
    return out, delta, ints[K]


def retract(delta: torch.Tensor, info: torch.Tensor, poses: torch.Tensor):
    """K13c on CUDA tensors (one launch on the current stream),
    ``retract_reference`` on CPU tensors: (poses retracted by delta (6K,),
    or by 0 unless info == 0 and every delta is finite; the delta applied
    (K, 6))."""
    if _on_cpu(delta, info, poses):
        return retract_reference(delta, info, poses)
    dev = poses.device
    K = poses.shape[0]
    if (dev.type != "cuda" or delta.device != dev or info.device != dev
            or delta.dtype != torch.float32 or poses.dtype != torch.float32
            or info.dtype != torch.int32 or info.numel() != 1
            or delta.numel() != 6 * K or tuple(poses.shape) != (K, 4, 4)
            or not 1 <= K <= MAX_POSES):
        raise ValueError("pg_retract: float32 delta (6K,), int32 info (1,) "
                         "and float32 poses (K, 4, 4) on one CUDA device")
    delta, poses = delta.contiguous(), poses.contiguous()
    buf = torch.empty(K * 22, dtype=torch.float32, device=dev)
    out, used = buf[:16 * K].view(K, 4, 4), buf[16 * K:].view(K, 6)
    kernels.launch("pg_retract", poses.get_device(), delta.data_ptr(),
                   info.contiguous().data_ptr(), poses.data_ptr(), K,
                   out.data_ptr(), used.data_ptr())
    global LAUNCHES_RETRACT
    LAUNCHES_RETRACT += 1
    return out, used


# --------------------------------------------------------------------------
# the solver
# --------------------------------------------------------------------------

def _dense_step(A: torch.Tensor, b: torch.Tensor, poses: torch.Tensor,
                retract_fn):
    """Factor the damped, anchored A (the library's Cholesky), solve A
    delta = -b and retract: (poses, delta applied)."""
    L, info = torch.linalg.cholesky_ex(A)
    delta = torch.cholesky_solve(-b.reshape(-1, 1), L)[:, 0]
    return retract_fn(delta.contiguous(), info, poses)


def _chi2(graph: PoseGraph) -> torch.Tensor:
    return edge_system(graph, "chi2").chi2


def _edge_blocks(graph: PoseGraph, robust_delta=None,
                 robust_kernel: str = "gm"):
    """Per-edge 6x6 Gauss-Newton blocks, the O(E) build both solvers use
    (K13a).  Returns ``(i_idx, j_idx, Hii, Hij, Hjj, bblk, chi2)``: the
    edges' (E, 6, 6) contributions to the (i, i) / (i, j) / (j, j) blocks
    of H ((j, i) is ``Hij^T``) and the assembled (K, 6) gradient."""
    s = edge_system(graph, "cg", robust_delta, robust_kernel)
    Hii, Hij, Hjj = _blocks(s.rows)
    return (graph.edges_ij[:, 0].long(), graph.edges_ij[:, 1].long(), Hii,
            Hij, Hjj, s.b, s.chi2)


def _edge_jacobians(Ti, Tj, Z) -> torch.Tensor:
    """(E, 6, 12) exact Jacobians of the edge residuals with respect to the
    two right perturbations, at zero (plain K13a's)."""
    return _edge_r_J(Ti, Tj, Z)[1]


def build_normal_equations(
    graph: PoseGraph, robust_delta=None, robust_kernel: str = "gm",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H (6K, 6K), b (6K,), chi2) of the weighted Gauss-Newton system
    about the current poses, H without anchor or damping (the sharded path
    sums H over ranks first); ``robust_delta`` > 0 applies the IRLS
    reweighting."""
    s = edge_system(graph, "dense", robust_delta, robust_kernel)
    return s.H, s.b.reshape(-1), s.chi2


def solve_delta_cg(graph: PoseGraph, robust_delta,
                   cfg: KeyframeConfig) -> torch.Tensor:
    """Gauss-Newton step by matrix-free block-Jacobi-preconditioned CG ->
    (K, 6).  Solves the damped, anchored system the dense path solves; H
    is never materialized."""
    s = edge_system(graph, "cg", robust_delta, cfg.ba_robust_kernel,
                    damping=cfg.ba_damping)
    return cg_solve(s, graph, cfg)[1]


def apply_update(graph: PoseGraph, H: torch.Tensor, b: torch.Tensor,
                 cfg: KeyframeConfig) -> PoseGraph:
    """Solve the damped, anchored dense system and retract onto the poses
    (K13c)."""
    K = graph.poses.shape[0]
    dev = H.device
    anchor = torch.zeros((K * 6,), dtype=torch.float32, device=dev)
    anchor[:6] = 1e6
    A = H + torch.diag(anchor) + cfg.ba_damping * torch.eye(
        K * 6, dtype=torch.float32, device=dev)
    return graph._replace(poses=_dense_step(A, b, graph.poses, retract)[0])


def gnc_delta(cfg: KeyframeConfig, i: int):
    """Graduated-non-convexity width of the robust kernel at IRLS
    iteration ``i``: from ``ba_gnc_init_scale x delta`` down geometrically
    to ``delta`` at the last iteration.  None when the kernel is off; a
    Python float when there is no annealing; else a ``np.float32``
    computed in float32 steps as the JAX loop computes it."""
    if cfg.ba_robust_delta <= 0:
        return None
    if cfg.ba_gnc_init_scale <= 1.0:
        return cfg.ba_robust_delta
    # the divisor is a constant of the compiled JAX loop: a reciprocal
    # multiply there (geometry/f32.py), contracted with the subtraction
    # into one fused multiply-add (the product is exact in float64)
    power = np.float32(1.0 - float(i) * recip(max(cfg.ba_iters - 1, 1)))
    return np.float32(cfg.ba_robust_delta) * np.power(
        np.float32(cfg.ba_gnc_init_scale), power)


def _optimize(graph: PoseGraph, cfg: KeyframeConfig, system, cg, retract_fn):
    if cfg.ba_solver not in ("dense", "cg", "auto"):
        raise ValueError(f"unknown ba_solver {cfg.ba_solver!r}")
    chi2_0 = system(graph, "chi2").chi2
    K = graph.poses.shape[0]
    use_cg = cfg.ba_solver == "cg" or (
        cfg.ba_solver == "auto" and K > cfg.ba_dense_max_k)
    for i in range(cfg.ba_iters):
        delta = gnc_delta(cfg, i)
        if use_cg:
            s = system(graph, "cg", delta, cfg.ba_robust_kernel,
                       damping=cfg.ba_damping)
            poses = cg(s, graph, cfg)[0]
        else:
            s = system(graph, "dense", delta, cfg.ba_robust_kernel,
                       diag=True, damping=cfg.ba_damping)
            poses = _dense_step(s.H, s.b, graph.poses, retract_fn)[0]
        graph = graph._replace(poses=poses)
    return graph, BAInfo(chi2_initial=chi2_0,
                         chi2_final=system(graph, "chi2").chi2,
                         iters=cfg.ba_iters)


def optimize(graph: PoseGraph, cfg: KeyframeConfig):
    """Gauss-Newton pose graph optimization on the graph's device: on the
    card a host loop over ``ba_iters`` that only issues launches (K13a, then
    K13b, or the library's Cholesky and K13c), with no host read.  Returns
    (a new graph with optimized poses, BAInfo with 0-d chi2 tensors); the
    input graph's tensors are not written."""
    return _optimize(graph, cfg, edge_system, cg_solve, retract)


def optimize_reference(graph: PoseGraph, cfg: KeyframeConfig):
    """``optimize`` through the plain versions on the graph's device (the
    card's yardstick for K13a-c; it reads the CG loop's condition on the
    host)."""
    return _optimize(graph, cfg, edge_system_reference, cg_reference,
                     retract_reference)
