"""Keyframe pose graph optimization, bundle adjustment over poses (port of
ops/pose_graph.py).

- The graph is padded tensors: poses (K, 4, 4) and edges (indices, SE(3)
  measurements, scalar weights).  Padding edges are (0, 0, identity,
  weight 0), so they add exact zeros.  ``num_poses`` / ``num_edges`` are
  host integers (the JAX version keeps them as device scalars); ``add_pose``
  and ``add_edge`` write the padded tensors in place.
- Residual per edge (i, j): ``r = log(Z_ij^-1 T_i^-1 T_j)`` in se(3).
- Gauss-Newton with the right perturbation ``T_i <- T_i exp(xi_i)``.  Each
  edge's exact 6x12 Jacobian comes from forward-mode differentiation
  through ``se3.exp`` / ``se3.log`` (``torch.func.jacfwd`` under ``vmap``
  over edges) and is scattered into 6x6 blocks: O(E) build cost.
- Two inner solvers share the build (``KeyframeConfig.ba_solver``): a dense
  6K x 6K Cholesky, and matrix-free block-Jacobi-preconditioned CG whose
  loop condition is checked on the host (one device read per iteration).
  "auto" takes CG once the capacity K exceeds ``ba_dense_max_k``.
- Scatter-adds with repeated indices go through
  ``index_put_(accumulate=True)``, which sorts on the card: two runs of one
  solve give the same bits (``index_add_`` uses float atomics there).
- A factorization that fails gives no update (``cholesky_ex`` and its
  ``info``), where the JAX version turns the NaN solve into zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import KeyframeConfig
from ..device import resolve
from ..geometry import se3
from ..geometry.f32 import recip


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


def _edge_r(Ti: torch.Tensor, Tj: torch.Tensor, Z: torch.Tensor):
    return se3.log(se3.inverse(Z) @ se3.inverse(Ti) @ Tj)


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


def _chi2(graph: PoseGraph) -> torch.Tensor:
    r = edge_residuals(graph.poses, graph.edges_ij, graph.edges_T)
    return torch.sum(graph.edges_w * torch.sum(r * r, dim=-1))


def _scatter_add(dst: torch.Tensor, idx, src: torch.Tensor) -> torch.Tensor:
    """dst[idx] += src with repeated indices, repeatable on the card."""
    return dst.index_put_(idx, src, accumulate=True)


def _edge_jacobians(Ti, Tj, Z) -> torch.Tensor:
    """(E, 6, 12) exact Jacobians of the edge residuals with respect to the
    two right perturbations, at zero."""
    def r_of(xi, Ti_e, Tj_e, Z_e):
        # a leading axis of one keeps every intermediate off 0-dim: forward
        # mode promotes the tangent of ``0-dim tensor (op) Python scalar``
        # to float64
        xi = xi[None]
        return _edge_r(Ti_e[None] @ se3.exp(xi[:, :6]),
                       Tj_e[None] @ se3.exp(xi[:, 6:]), Z_e[None])[0]

    zero = torch.zeros((Ti.shape[0], 12), dtype=torch.float32,
                       device=Ti.device)
    return torch.func.vmap(torch.func.jacfwd(r_of))(zero, Ti, Tj, Z)


def _edge_blocks(graph: PoseGraph, robust_delta=None,
                 robust_kernel: str = "gm"):
    """Per-edge 6x6 Gauss-Newton blocks, the O(E) build both solvers use.
    Returns ``(i_idx, j_idx, Hii, Hij, Hjj, bblk, chi2)``: the edges'
    (E, 6, 6) contributions to the (i, i) / (i, j) / (j, j) blocks of H
    ((j, i) is ``Hij^T``) and the assembled (K, 6) gradient."""
    K = graph.poses.shape[0]
    if robust_delta is not None and robust_delta <= 0:
        robust_delta = None
    ew = (robust_edge_weights(graph, robust_delta, robust_kernel)
          if robust_delta is not None else graph.edges_w)

    i_idx = graph.edges_ij[:, 0].long()
    j_idx = graph.edges_ij[:, 1].long()
    Ti = graph.poses[i_idx]
    Tj = graph.poses[j_idx]

    r = _edge_r(Ti, Tj, graph.edges_T)                    # (E, 6)
    J = _edge_jacobians(Ti, Tj, graph.edges_T)            # (E, 6, 12)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    wJi = Ji * ew[:, None, None]
    wJj = Jj * ew[:, None, None]

    Hii = torch.einsum("eab,eac->ebc", wJi, Ji)
    Hij = torch.einsum("eab,eac->ebc", wJi, Jj)
    Hjj = torch.einsum("eab,eac->ebc", wJj, Jj)

    bi = torch.einsum("eab,ea->eb", wJi, r)
    bj = torch.einsum("eab,ea->eb", wJj, r)
    bblk = torch.zeros((K, 6), dtype=torch.float32, device=r.device)
    _scatter_add(bblk, (i_idx,), bi)
    _scatter_add(bblk, (j_idx,), bj)

    chi2 = torch.sum(ew * torch.sum(r * r, dim=-1))
    return i_idx, j_idx, Hii, Hij, Hjj, bblk, chi2


def build_normal_equations(
    graph: PoseGraph, robust_delta=None, robust_kernel: str = "gm",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H (6K, 6K), b (6K,), chi2) of the weighted Gauss-Newton system
    about the current poses; ``robust_delta`` > 0 applies the IRLS
    reweighting."""
    K = graph.poses.shape[0]
    i_idx, j_idx, Hii, Hij, Hjj, bblk, chi2 = _edge_blocks(
        graph, robust_delta, robust_kernel)
    Hblk = torch.zeros((K, K, 6, 6), dtype=torch.float32,
                       device=bblk.device)
    _scatter_add(Hblk, (i_idx, i_idx), Hii)
    _scatter_add(Hblk, (i_idx, j_idx), Hij)
    _scatter_add(Hblk, (j_idx, i_idx), Hij.transpose(1, 2))
    _scatter_add(Hblk, (j_idx, j_idx), Hjj)
    Hn = Hblk.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    return Hn, bblk.reshape(-1), chi2


def solve_delta_cg(graph: PoseGraph, robust_delta,
                   cfg: KeyframeConfig) -> torch.Tensor:
    """Gauss-Newton step by matrix-free block-Jacobi-preconditioned CG ->
    (K, 6).  Solves the damped, anchored system the dense path solves; H
    is never materialized: the matvec gathers the two twists each edge
    touches, applies the edge's blocks and scatter-adds."""
    K = graph.poses.shape[0]
    i_idx, j_idx, Hii, Hij, Hjj, bblk, _ = _edge_blocks(
        graph, robust_delta, cfg.ba_robust_kernel)
    HijT = Hij.transpose(1, 2)
    dev = bblk.device

    diagv = torch.full((K, 6), cfg.ba_damping, dtype=torch.float32,
                       device=dev)
    diagv[0] += 1e6

    def matvec(x):
        xi, xj = x[i_idx], x[j_idx]
        yi = (torch.einsum("ebc,ec->eb", Hii, xi)
              + torch.einsum("ebc,ec->eb", Hij, xj))
        yj = (torch.einsum("ebc,ec->eb", HijT, xi)
              + torch.einsum("ebc,ec->eb", Hjj, xj))
        y = torch.zeros((K, 6), dtype=torch.float32, device=dev)
        _scatter_add(y, (i_idx,), yi)
        _scatter_add(y, (j_idx,), yj)
        return y + diagv * x

    Hd = torch.zeros((K, 6, 6), dtype=torch.float32, device=dev)
    _scatter_add(Hd, (i_idx,), Hii)
    _scatter_add(Hd, (j_idx,), Hjj)
    Hd = Hd + torch.diag_embed(diagv)
    Ld, info = torch.linalg.cholesky_ex(Hd)

    def precond(r):
        return torch.cholesky_solve(r[..., None], Ld)[..., 0]

    def dot(a, b):
        return torch.sum(a * b)

    b = -bblk
    tol2 = (cfg.ba_cg_tol ** 2) * dot(b, b)
    x = torch.zeros((K, 6), dtype=torch.float32, device=dev)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)
    it = 0
    # the loop condition is read on the host: one device read per iteration
    while it < cfg.ba_cg_iters and bool(dot(r, r) > tol2):
        Ap = matvec(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    ok = torch.all(info == 0) & torch.all(torch.isfinite(x))
    return torch.where(ok, x, 0.0)


def _retract(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return poses @ se3.exp(delta)


def apply_update(graph: PoseGraph, H: torch.Tensor, b: torch.Tensor,
                 cfg: KeyframeConfig) -> PoseGraph:
    """Solve the damped, anchored dense system and retract onto the
    poses."""
    K = graph.poses.shape[0]
    dev = H.device
    anchor = torch.zeros((K * 6,), dtype=torch.float32, device=dev)
    anchor[:6] = 1e6
    A = H + torch.diag(anchor) + cfg.ba_damping * torch.eye(
        K * 6, dtype=torch.float32, device=dev)
    L, info = torch.linalg.cholesky_ex(A)
    delta = torch.cholesky_solve(-b[:, None], L)[:, 0].reshape(K, 6)
    ok = (info == 0) & torch.all(torch.isfinite(delta))
    delta = torch.where(ok, delta, 0.0)
    return graph._replace(poses=_retract(graph.poses, delta))


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


def optimize(graph: PoseGraph, cfg: KeyframeConfig):
    """Gauss-Newton pose graph optimization on the graph's device.
    Returns (a new graph with optimized poses, BAInfo); the input graph's
    tensors are not written."""
    chi2_0 = _chi2(graph)
    K = graph.poses.shape[0]
    if cfg.ba_solver not in ("dense", "cg", "auto"):
        raise ValueError(f"unknown ba_solver {cfg.ba_solver!r}")
    use_cg = cfg.ba_solver == "cg" or (
        cfg.ba_solver == "auto" and K > cfg.ba_dense_max_k)
    for i in range(cfg.ba_iters):
        if use_cg:
            delta = solve_delta_cg(graph, gnc_delta(cfg, i), cfg)
            graph = graph._replace(poses=_retract(graph.poses, delta))
        else:
            H, b, _ = build_normal_equations(
                graph, gnc_delta(cfg, i), cfg.ba_robust_kernel)
            graph = apply_update(graph, H, b, cfg)
    return graph, BAInfo(chi2_initial=chi2_0, chi2_final=_chi2(graph),
                         iters=cfg.ba_iters)
