"""Multi-device SLAM: the map sharded over the ranks of a mesh (port of
parallel/sharded.py).

Layout over a 1-D mesh of ``n`` ranks (one process each,
parallel/distributed.py):

- Hash table and block heap: bucket b of the global table lives on rank
  ``b % n``.  Each rank holds an independent local table of
  ``num_buckets / n`` buckets, its own free stack (``free_top`` of shape
  (1,), so the global layout has shape (n,)), and ``num_blocks / n``
  TSDF rows.  A block's owner is a function of its coordinates
  (``spatial_hash % n``, the local bucket ``spatial_hash // n``), so
  allocation masks the replicated candidate keys to the rank's own and
  fusion is local: every voxel has one owner.
- Image work: ICP rows and the model maps are split over the ranks by
  image rows (``H / n`` each).
- Collectives: the 6x6 Gauss-Newton system is ``psum``-ed each ICP
  iteration; the model's depth is all-gathered once per frame for the
  association; the splat z-buffers merge with one ``pmin`` (the march
  gathers the visible halo instead); the step's counters are ``psum``-ed.

The state is each rank's shard, preallocated on its device and updated in
place; the pose, velocity, frame index and StepInfo scalars are replicated
(bit-identical on every rank).  The JAX version runs each piece as one
``shard_map``-ped jit; here each rank runs the same eager code, and every
collective goes through parallel/distributed.py, whose rules hold
throughout: every rank calls every collective in the same order, and no
per-rank value gates one.

Out-of-core streaming (``config.stream.enabled``): each rank evicts its
own stale rows into its own host ``BlockStore`` shard (the JAX package's
multi-process layout) and restores from it; a restore batch is routed to
the owner by the same hash the allocator uses (``_owner_np``).  Eviction
``psum``s its count, so every rank holds the same cycle state; the
restore itself is local.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import HashConfig, PipelineConfig
from ..geometry import camera as cam_geom
from ..geometry import coords, se3
from ..device import host_array
from ..models.hash_slam import HashSLAMState, StepInfo, depth_tensor
from ..ops import hash_ops, hash_raycast
from ..ops import icp as icp_ops
from ..ops import pose_graph
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops
from ..ops.hash_ops import FREE_PTR, HashMap
from ..ops.preprocess import Frame
from ..utils.blockstore import BlockStore, unpack_keys_np
from . import distributed
from .distributed import Mesh, all_gather, pmin, psum

def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over the initialized process group (one rank per
    position); raises unless the group has exactly ``n_devices`` ranks."""
    return distributed.global_mesh(n_devices, device=device)


def _owner_np(blocks: np.ndarray, num_buckets: int, n: int) -> np.ndarray:
    """Host twin of ``_owner`` (the same int32-wraparound hash), for
    routing stored blocks to their owning rank without the device."""
    b = blocks.astype(np.int32)
    with np.errstate(over="ignore"):
        h = ((b[:, 0] * np.int32(coords.HASH_P0))
             ^ (b[:, 1] * np.int32(coords.HASH_P1))
             ^ (b[:, 2] * np.int32(coords.HASH_P2)))
    return (h % np.int32(num_buckets)) % np.int32(n)


def local_hash_config(cfg: HashConfig, n: int) -> HashConfig:
    """One rank's shard of the global hash geometry."""
    for name in ("num_buckets", "num_blocks", "max_active",
                 "max_new_per_frame"):
        if getattr(cfg, name) % n:
            raise ValueError(f"hash.{name} = {getattr(cfg, name)} does not "
                             f"divide over {n} ranks")
    return dataclasses.replace(
        cfg,
        num_buckets=cfg.num_buckets // n,
        num_blocks=cfg.num_blocks // n,
        max_active=cfg.max_active // n,
        max_new_per_frame=cfg.max_new_per_frame // n,
    )


def _owner(blocks: torch.Tensor, cfg: HashConfig, n: int) -> torch.Tensor:
    """Owning rank of each block: the global bucket modulo n."""
    return coords.spatial_hash(blocks, cfg.num_buckets) % n


def _local_bucket_fn(cfg: HashConfig, n: int) -> hash_ops.BucketHash:
    """The owner-local bucket: global bucket // n (valid only for keys
    already routed to their owner); a ``BucketHash``, which K5b takes."""
    return hash_ops.BucketHash(cfg.num_buckets, n)


def _rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x``'s rows (axis 0 divides by the mesh)."""
    h = x.shape[0] // mesh.size
    return x[mesh.rank * h:(mesh.rank + 1) * h]


def create_map(config: PipelineConfig, mesh: Mesh) -> HashMap:
    """An empty map shard on the rank's device."""
    lcfg = local_hash_config(config.hash, mesh.size)
    local = hash_ops.create(lcfg, device=mesh.device)
    return local._replace(free_top=local.free_top.reshape(1))


def create_sharded(config: PipelineConfig, mesh: Mesh) -> HashSLAMState:
    """Initial state: the rank's empty map shard, identity pose, its rows
    of an empty model."""
    cam = config.camera
    if cam.height % mesh.size:
        raise ValueError(f"image height {cam.height} does not divide over "
                         f"{mesh.size} ranks")
    h = cam.height // mesh.size
    f32 = dict(dtype=torch.float32, device=mesh.device)
    empty = Frame(vertices=torch.zeros((h, cam.width, 3), **f32),
                  normals=torch.zeros((h, cam.width, 3), **f32),
                  depth=torch.zeros((h, cam.width), **f32))
    return HashSLAMState(
        hmap=create_map(config, mesh),
        pose=se3.identity(device=mesh.device),
        model=empty,
        frame_idx=0,
        vel=se3.identity(device=mesh.device),
    )


# --------------------------------------------------------------------------
# row-sharded ICP
# --------------------------------------------------------------------------

def _psum_system(mesh: Mesh, sys: icp_ops.NormalSystem,
                 scale: float) -> icp_ops.NormalSystem:
    """The GN system summed over the ranks (one collective), times
    ``scale``."""
    flat = torch.cat([sys.JTJ.reshape(36), sys.JTr.reshape(6),
                      sys.error.reshape(1), sys.count.reshape(1)])
    s = psum(mesh, flat) * scale
    return icp_ops.NormalSystem(JTJ=s[:36].reshape(6, 6), JTr=s[36:42],
                                error=s[42], count=s[43])


def _source_rows(src_l: Frame, mesh: Mesh):
    """(this rank's rows of a pyramid level's source, the scale its ranks'
    sums take).  When the level's rows do not divide over the mesh every
    rank takes the whole image and the sum is scaled back by 1/n: the
    reduction stays, so every rank carries bit-identical values into the
    loop's decisions (the JAX version's replication rule)."""
    if src_l.depth.shape[0] % mesh.size:
        return src_l, 1.0 / mesh.size
    return Frame(*(_rows(x, mesh) for x in src_l)), 1.0


def _icp_level_sharded(src_l: Frame, tgt_packed: torch.Tensor, lcam, cfg,
                       mesh: Mesh, max_iters: int,
                       T0: torch.Tensor) -> icp_ops.ICPResult:
    """One pyramid level of row-sharded Gauss-Newton (``_source_rows``)
    against the level's packed target."""
    src_l, scale = _source_rows(src_l, mesh)
    dev = T0.device
    tol2 = float(np.float32(cfg.update_tol ** 2))
    T, it, dnorm = T0, 0, float("inf")
    err = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    JTJ = torch.zeros((6, 6), dtype=torch.float32, device=dev)
    while it < max_iters and dnorm > tol2:
        # this rank's system: K4s on the card, the plain version on the CPU
        sys = _psum_system(mesh, icp_ops.normal_system(
            T, src_l, tgt_packed, lcam, cfg), scale)
        delta = icp_ops.solve_normal_system(sys, cfg.damping)
        T = se3.exp(delta) @ T
        it += 1
        err = sys.error / torch.clamp(sys.count, min=1.0)
        cnt, JTJ = sys.count, sys.JTJ
        # replicated: every rank takes the same branch
        dnorm = float(torch.sum(delta * delta))
    return icp_ops.ICPResult(
        transform=T, error=err, count=cnt,
        iters=torch.tensor(it, dtype=torch.int32, device=dev), JTJ=JTJ)


def _score_sums(T, src_l: Frame, lcam, cfg, packed, mesh: Mesh):
    """This rank's (num, den) of ``alignment_score_sums`` as a (2,)
    tensor, and the scale its ranks' sum takes (``_source_rows``)."""
    src_l, scale = _source_rows(src_l, mesh)
    num, den = icp_ops.alignment_score_sums(T, src_l, None, lcam, cfg,
                                            packed)
    return torch.stack([num, den]), scale


def _icp_sharded(src: Frame, tgt_depth: torch.Tensor, cam, cfg, mesh: Mesh,
                 prior_T=None) -> icp_ops.ICPResult:
    """Coarse-to-fine row-sharded point-to-plane ICP, with the raced
    constant-velocity prior at the coarsest level.  ``src`` is replicated;
    ``tgt_depth`` is the model's full depth (all-gathered by the caller),
    downsampled per level on every rank.  The levels' inputs come from one
    ``pyramid_inputs`` call: sources min-pooled (the JAX sharded step's
    rule), the finest target's normals from the gathered depth."""
    levels = sorted(set(cfg.pyramid), reverse=True)
    iters = cfg.pyramid_iters
    if len(iters) != len(levels):
        iters = (cfg.max_iters,) * len(levels)
    sources, targets = pre_ops.pyramid_inputs(src.depth, tgt_depth, cam, cfg,
                                              mean_sources=False)
    T = se3.identity(device=src.depth.device)
    result = None
    for li, (factor, max_it, src_l, packed) in enumerate(
            zip(levels, iters, sources, targets)):
        lcam = cam.scaled(factor) if factor > 1 else cam
        result = _icp_level_sharded(src_l, packed, lcam, cfg, mesh, max_it,
                                    T)
        if li == 0 and prior_T is not None:
            raced = _icp_level_sharded(src_l, packed, lcam, cfg, mesh,
                                       max_it, prior_T)
            a, scale = _score_sums(raced.transform, src_l, lcam, cfg,
                                   packed, mesh)
            b, _ = _score_sums(result.transform, src_l, lcam, cfg,
                               packed, mesh)
            # both scores' sums in one collective
            sn, sd, bn, bd = psum(mesh, torch.cat([a, b])) * scale
            result = icp_ops.pick_by_score(
                raced, result,
                sn / torch.clamp(sd, min=1.0), bn / torch.clamp(bd, min=1.0))
        T = result.transform
    return result


# --------------------------------------------------------------------------
# surface prediction over the sharded map
# --------------------------------------------------------------------------

def _raycast_model_sharded(hmap: HashMap, lcfg: HashConfig, T_wc,
                           config: PipelineConfig, mesh: Mesh):
    """The model Frame (this rank's rows) seen from ``T_wc``.

    Splat mode: each rank splats its own visible rows into a full-size
    z-buffer, and the buffers merge with one ``pmin`` (0 = no estimate
    becomes +inf for the minimum).  March mode: the visible halo (blocks,
    sdf and weight rows, valid flags) is all-gathered, every rank builds
    the view-local cache from it and sphere-traces its own rows."""
    cam = config.camera
    active = hash_ops.compact_visible(hmap, lcfg, T_wc, cam, config.fusion)
    if config.raycast.mode == "splat":
        depth = splat_ops.splat_depth_from_map(
            hmap, active, lcfg, T_wc, cam, config.raycast, config.fusion)
        depth = pmin(mesh, torch.where(depth > 0, depth, float("inf")))
        depth = torch.where(torch.isfinite(depth), depth, 0.0)
        out = splat_ops.finalize_depth(depth, cam, config.raycast,
                                       config.fusion)
        return Frame(vertices=_rows(out.points, mesh),
                     normals=_rows(out.normals, mesh),
                     depth=_rows(out.depth, mesh))
    safe = torch.clamp(active.ptrs, 0, hmap.tsdf.shape[0] - 1).long()
    V = lcfg.voxels_per_block
    cache = hash_raycast.densify_rows(
        all_gather(mesh, active.blocks),
        all_gather(mesh, hmap.tsdf[safe]).reshape(-1, V),
        all_gather(mesh, hmap.weight[safe]).reshape(-1, V),
        all_gather(mesh, active.ptrs != FREE_PTR),
        lcfg, config.fusion, T_wc, config.raycast.cache_dims)
    rays = _rows(cam_geom.pixel_rays(cam, device=T_wc.device), mesh)
    out = rc_ops.raycast_rays(cache, T_wc, rays, config.raycast)
    return Frame(vertices=out.points, normals=out.normals, depth=out.depth)


def _route(cand: torch.Tensor, lcfg: HashConfig, config: PipelineConfig,
           mesh: Mesh) -> torch.Tensor:
    """The candidate keys this rank owns (the others EMPTY_KEY)."""
    blocks = coords.unpack_block_key(cand, lcfg.key_bits)
    mine = ((_owner(blocks, config.hash, mesh.size) == mesh.rank)
            & (cand != hash_ops.EMPTY_KEY))
    return torch.where(mine, cand, hash_ops.EMPTY_KEY)


def _fuse_local(hmap, frame: Frame, pose, frame_idx: int, lcfg, config,
                mesh: Mesh, bucket_fn):
    """Owner-routed allocation, then the local compact / touch /
    integrate (the window gather and the stamp run in ``integrate``: K6
    and K7 on the card).  Returns (map, active set, n_allocated)."""
    cam = config.camera
    cand = hash_ops.frame_candidate_keys(frame, pose, cam, lcfg,
                                         config.fusion)
    hmap, n_alloc = hash_ops.insert_blocks(
        hmap, lcfg, _route(cand, lcfg, config, mesh), frame_idx,
        bucket_fn=bucket_fn)
    active = hash_ops.compact_visible(hmap, lcfg, pose, cam, config.fusion)
    hmap = hash_ops.integrate(hmap, active, lcfg, frame.depth, pose, cam,
                              config.fusion, stamp=frame_idx)
    return hmap, active, n_alloc


def make_sharded_step(config: PipelineConfig, mesh: Mesh):
    """The multi-device frame step: ``step(state, depth_raw)`` updates the
    rank's map shard in place and returns (new_state, StepInfo)."""
    n = mesh.size
    lcfg = local_hash_config(config.hash, n)
    cam = config.camera
    if cam.height % n:
        raise ValueError(f"image height {cam.height} does not divide over "
                         f"{n} ranks")
    bucket_fn = _local_bucket_fn(config.hash, n)
    gc = config.gc

    def step(state: HashSLAMState, depth_raw: torch.Tensor):
        frame = pre_ops.preprocess(depth_raw, cam, config.frontend)

        # --- track: row-sharded ICP on the gathered model depth ----------
        tgt_depth = all_gather(mesh, state.model.depth)
        model_valid = torch.sum(tgt_depth > 0) > 100
        result = _icp_sharded(
            frame, tgt_depth, cam, config.icp, mesh,
            prior_T=state.vel if config.icp.use_motion_prior else None)
        ok = (model_valid
              & (result.count > 100)
              & torch.all(torch.isfinite(result.transform))
              & icp_ops.motion_plausible(result.transform, config.icp))
        T_rel = torch.where(ok, result.transform,
                            se3.identity(device=ok.device))
        pose_new = state.pose @ T_rel

        # --- GC: local, before fusion -------------------------------------
        hmap = state.hmap
        n_freed = torch.zeros((), dtype=torch.int32, device=ok.device)
        if gc.enabled and state.frame_idx % gc.interval == gc.interval - 1:
            hmap, n_freed = hash_ops.garbage_collect(
                hmap, lcfg, gc.min_weight, gc.max_blocks_per_gc,
                frame_idx=state.frame_idx, min_age=gc.min_age)

        # --- allocate (owner-routed) and fuse (local) ---------------------
        hmap, active, n_alloc = _fuse_local(
            hmap, frame, pose_new, state.frame_idx, lcfg, config, mesh,
            bucket_fn)

        # --- surface prediction: pmin-merged splat or halo march ---------
        model = _raycast_model_sharded(hmap, lcfg, pose_new, config, mesh)

        counts = psum(mesh, torch.stack([
            n_alloc, active.count, n_freed,
            hmap.free_top[0]]).to(torch.int32))
        info = StepInfo(
            pose=pose_new,
            icp_error=result.error,
            icp_count=result.count,
            icp_iters=result.iters,
            tracked=ok,
            blocks_allocated=counts[0],
            blocks_active=counts[1],
            blocks_freed=counts[2],
            free_blocks=counts[3],
            valid_px=torch.sum(frame.depth > 0).to(torch.int32),
        )
        return HashSLAMState(hmap=hmap, pose=pose_new, model=model,
                             frame_idx=state.frame_idx + 1, vel=T_rel), info

    return step


def make_sharded_fuse_only(config: PipelineConfig, mesh: Mesh):
    """Fuse-only step (no tracking): ``fuse(hmap, depth_raw, pose,
    frame_idx)`` integrates one raw frame at a given pose into the rank's
    shard (the keyframe backend's rebuild primitive).  No collectives."""
    lcfg = local_hash_config(config.hash, mesh.size)
    bucket_fn = _local_bucket_fn(config.hash, mesh.size)

    def fuse(hmap, depth_raw, pose, frame_idx):
        frame = pre_ops.preprocess(depth_raw, config.camera, config.frontend)
        hmap, _, _ = _fuse_local(hmap, frame, pose, int(frame_idx), lcfg,
                                 config, mesh, bucket_fn)
        return hmap

    return fuse


def make_sharded_reintegrate(config: PipelineConfig, mesh: Mesh):
    """Born-gated de-integration at the old pose and re-integration at the
    new pose of one stored frame, each rank moving its own rows.  Returns
    (map, count): the global ``max_active`` when any rank's visible set
    hit its local cap (so the caller's ``count >= max_active`` saturation
    test fires as on one device), else the sum of the ranks' counts."""
    lcfg = local_hash_config(config.hash, mesh.size)
    cam = config.camera

    def reint(hmap, depth_raw, T_old, T_new, frame_born):
        frame = pre_ops.preprocess(depth_raw, cam, config.frontend)
        a_old = hash_ops.compact_visible(hmap, lcfg, T_old, cam,
                                         config.fusion)
        hmap = hash_ops.integrate(hmap, a_old, lcfg, frame.depth, T_old, cam,
                                  config.fusion, sign=-1,
                                  max_born=int(frame_born))
        a_new = hash_ops.compact_visible(hmap, lcfg, T_new, cam,
                                         config.fusion)
        hmap = hash_ops.integrate(hmap, a_new, lcfg, frame.depth, T_new, cam,
                                  config.fusion, max_born=int(frame_born))
        local_max = torch.maximum(a_old.count, a_new.count)
        sat, total = psum(mesh, torch.stack([
            (local_max >= lcfg.max_active).to(torch.int32), local_max]))
        count = torch.where(sat > 0, config.hash.max_active, total)
        return hmap, count.to(torch.int32)

    return reint


def make_sharded_render_model(config: PipelineConfig, mesh: Mesh):
    """Surface prediction at any pose as the rank's rows of a tracking
    Frame: ``render(hmap, pose)`` (refreshes the model after a map
    update)."""
    lcfg = local_hash_config(config.hash, mesh.size)

    def render(hmap, pose):
        return _raycast_model_sharded(hmap, lcfg, pose, config, mesh)

    return render


def make_sharded_render(config: PipelineConfig, mesh: Mesh):
    """Live render of the sharded map at any pose: the rank's rows of a
    RaycastOutput (``fetch_output`` assembles the full image).  Per pixel
    it equals the single-device render of the same map content: the
    z-buffer minimum does not depend on the order."""
    model_fn = make_sharded_render_model(config, mesh)

    def render(hmap, pose):
        m = model_fn(hmap, pose)
        return rc_ops.RaycastOutput(depth=m.depth, points=m.vertices,
                                    normals=m.normals, hit=m.depth > 0)

    return render


def fetch_output(mesh: Mesh, out: rc_ops.RaycastOutput):
    """A row-sharded RaycastOutput as the full image on the host (CPU
    tensors; collective)."""
    return rc_ops.RaycastOutput(*(
        torch.from_numpy(distributed.fetch(mesh, f)) for f in out))


# --------------------------------------------------------------------------
# out-of-core streaming: per-rank eviction, owner-routed restore
# --------------------------------------------------------------------------

def make_sharded_evict(config: PipelineConfig, mesh: Mesh):
    """``evict(hmap, frame_idx)``: each rank evicts its own stale rows
    (``max_evict / n`` at most).  Returns (map, this rank's padded rows
    (keys, tsdf, weight, born) on the device, the ranks' total count as a
    host integer: one collective)."""
    lcfg = local_hash_config(config.hash, mesh.size)
    s = config.stream
    if s.max_evict % mesh.size:
        raise ValueError(f"stream.max_evict = {s.max_evict} does not "
                         f"divide over {mesh.size} ranks")

    def evict(hmap, frame_idx):
        hmap, keys, tsdf, weight, born, cnt = hash_ops.evict_stale(
            hmap, lcfg, int(frame_idx), s.max_age, s.max_evict // mesh.size)
        total = int(psum(mesh, cnt.reshape(1))[0])
        return hmap, (keys, tsdf, weight, born), total

    return evict


def make_sharded_restore(config: PipelineConfig, mesh: Mesh):
    """``restore(hmap, keys, tsdf, weight, born, frame_idx)``: restore an
    owner-routed batch into the rank's shard.  A key this rank does not
    own is masked out (never written into a foreign table).  Returns (map,
    accepted (R,) bool, aligned with the batch).  No collectives."""
    lcfg = local_hash_config(config.hash, mesh.size)
    bucket_fn = _local_bucket_fn(config.hash, mesh.size)
    if config.stream.max_restore % mesh.size:
        raise ValueError(f"stream.max_restore = {config.stream.max_restore}"
                         f" does not divide over {mesh.size} ranks")

    def restore(hmap, keys, tsdf, weight, born, frame_idx):
        blocks = coords.unpack_block_key(keys, lcfg.key_bits)
        mine = ((_owner(blocks, config.hash, mesh.size) == mesh.rank)
                & (keys != hash_ops.EMPTY_KEY))
        hmap, accepted = hash_ops.restore_blocks(
            hmap, lcfg, torch.where(mine, keys, hash_ops.EMPTY_KEY), tsdf,
            weight, int(frame_idx), bucket_fn,
            max_weight=config.fusion.max_weight, born_rows=born)
        return hmap, accepted & mine

    return restore


# --------------------------------------------------------------------------
# edge-sharded bundle adjustment
# --------------------------------------------------------------------------

def optimize_graph_sharded(graph: pose_graph.PoseGraph, kcfg, mesh: Mesh):
    """Bundle adjustment with the edges split over the ranks: each rank
    builds the normal equations of its edges, the dense H and b are
    ``psum``-ed, and every rank solves the same system.  Returns (the
    optimized graph, BAInfo), as ``pose_graph.optimize`` with its dense
    solver (``ba_solver="auto"`` stays dense; an explicit "cg" raises, as
    in the JAX version)."""
    if kcfg.ba_solver == "cg":
        raise ValueError(
            "ba_solver='cg' is single-device only; the sharded BA path "
            "psums the dense normal equations (use 'auto' or 'dense' with "
            "a mesh)")
    if kcfg.ba_solver not in ("dense", "auto"):
        raise ValueError(f"unknown ba_solver {kcfg.ba_solver!r}")
    n = mesh.size
    E = graph.edges_ij.shape[0]
    pad = (-E) % n
    eij, eT, ew = graph.edges_ij, graph.edges_T, graph.edges_w
    if pad:
        # padding edges (0, 0, I, w=0): exactly zero residual / Jacobian
        dev = eij.device
        eij = torch.cat([eij, torch.zeros((pad, 2), dtype=eij.dtype,
                                          device=dev)])
        eT = torch.cat([eT, torch.eye(4, dtype=eT.dtype,
                                      device=dev).repeat(pad, 1, 1)])
        ew = torch.cat([ew, torch.zeros((pad,), dtype=ew.dtype,
                                        device=dev)])
    eij, eT, ew = _rows(eij, mesh), _rows(eT, mesh), _rows(ew, mesh)

    def local(p):
        return pose_graph.PoseGraph(poses=p, num_poses=graph.num_poses,
                                    edges_ij=eij, edges_T=eT, edges_w=ew,
                                    num_edges=eij.shape[0])

    poses = graph.poses
    chi2_0 = psum(mesh, pose_graph._chi2(local(poses)))
    K6 = poses.shape[0] * 6
    for i in range(kcfg.ba_iters):
        H, b, _ = pose_graph.build_normal_equations(
            local(poses), pose_graph.gnc_delta(kcfg, i),
            kcfg.ba_robust_kernel)
        Hb = psum(mesh, torch.cat([H.reshape(-1), b]))
        poses = pose_graph.apply_update(
            local(poses), Hb[:K6 * K6].reshape(K6, K6), Hb[K6 * K6:],
            kcfg).poses
    chi2_1 = psum(mesh, pose_graph._chi2(local(poses)))
    return graph._replace(poses=poses), pose_graph.BAInfo(
        chi2_initial=chi2_0, chi2_final=chi2_1, iters=kcfg.ba_iters)


# --------------------------------------------------------------------------
# the host-side driver
# --------------------------------------------------------------------------

class ShardedHashSLAM:
    """Multi-device voxel-hash SLAM: one instance per rank, every rank
    feeding the same frames.  ``state`` is this rank's shard (replicated
    pose), ``process`` steps one raw depth frame on every rank,
    ``render`` predicts this rank's rows of the surface from any pose
    (``fetch_output`` assembles the image), ``trajectory`` and ``infos``
    collect each frame's pose and StepInfo (replicated).

    With ``config.stream.enabled``, ``store`` is this rank's host store
    shard and a cycle runs at every ``stream.interval``-th frame, before
    the step, on the JAX package's sharded schedule: the restore prepared
    last cycle, the eviction scan (the ranks' count summed), last cycle's
    evicted rows landed in the store, the accepted restored keys taken out
    of it, and the next batch (the store's keys in the frustum predicted
    ``2 x interval`` frames ahead, routed to this rank) uploaded."""

    def __init__(self, config: PipelineConfig, mesh: Mesh):
        self._setup(config, mesh, create_sharded(config, mesh), [],
                    BlockStore(config.hash) if config.stream.enabled
                    else None)

    @classmethod
    def _restore(cls, config: PipelineConfig, mesh: Mesh,
                 state: HashSLAMState, trajectory,
                 store: BlockStore | None = None) -> "ShardedHashSLAM":
        """A ShardedHashSLAM at a given state (checkpoint restore); the
        streaming cycle starts quiesced."""
        slam = cls.__new__(cls)
        if store is None and config.stream.enabled:
            store = BlockStore(config.hash)
        slam._setup(config, mesh, state, list(trajectory), store)
        return slam

    def _setup(self, config, mesh, state, trajectory, store) -> None:
        if config.raycast.mode not in ("splat", "march"):
            raise ValueError(f"unknown raycast mode {config.raycast.mode!r}")
        self.config = config
        self.mesh = mesh
        self.device = mesh.device
        self.state = state
        self.trajectory = trajectory
        self.infos = []
        self.store = store
        self._step = make_sharded_step(config, mesh)
        if store is not None:
            self._evict = make_sharded_evict(config, mesh)
            self._restore_fn = make_sharded_restore(config, mesh)
            self._init_stream_runtime()

    def _init_stream_runtime(self) -> None:
        # (placed keys, uploaded device rows) of the next restore batch
        self._prefetch = None
        # device rows of the last eviction, landed at the next cycle
        self._pending_evict = None

    # -- the streaming cycle -------------------------------------------------

    def _pack_restore(self, keys: np.ndarray):
        """This rank's ``max_restore / n`` slice of a restore batch: the
        stored keys it owns, in the query's order (keys past the slice stay
        in the store for a later cycle).  Returns (placed keys (EMPTY_KEY
        pads), the slice's rows uploaded to the device)."""
        n = self.mesh.size
        cap = self.config.stream.max_restore // n
        V = self.config.hash.voxels_per_block
        placed = np.full(cap, int(hash_ops.EMPTY_KEY), np.int32)
        tsdf = np.zeros((cap, V), np.float32)
        weight = np.zeros((cap, V), np.float32)
        born = np.zeros(cap, np.int32)
        if keys.size:
            owner = _owner_np(unpack_keys_np(keys, self.config.hash.key_bits),
                              self.config.hash.num_buckets, n)
            mine = keys[owner == self.mesh.rank][:cap]
            m = mine.shape[0]
            placed[:m] = mine
            tsdf[:m], weight[:m], born[:m] = self.store.rows_for(mine)
        uploaded = tuple(distributed.shard_rows_to_global(a, self.mesh)
                         for a in (placed, tsdf, weight, born))
        return placed, uploaded

    def _dispatch_restore(self, uploaded) -> torch.Tensor:
        hmap, accepted = self._restore_fn(self.state.hmap, *uploaded,
                                          self.state.frame_idx)
        self.state = self.state._replace(hmap=hmap)
        return accepted

    def _take_accepted(self, placed: np.ndarray, accepted) -> None:
        live = placed != int(hash_ops.EMPTY_KEY)
        if live.any():
            self.store.take(placed[live], host_array(accepted)[live])

    def _land_pending_evict(self) -> None:
        if self._pending_evict is None:
            return
        rows = self._pending_evict
        self._pending_evict = None
        self.store.add(*(host_array(t) for t in rows))

    def stream_sync(self) -> None:
        """Quiesce the cycle: restore the prefetched batch (taking its
        accepted keys out of the store) and land the pending evicted rows.
        No collectives."""
        if self.store is None:
            return
        if self._prefetch is not None:
            placed, uploaded = self._prefetch
            self._prefetch = None
            self._take_accepted(placed, self._dispatch_restore(uploaded))
        self._land_pending_evict()

    def _stream_cycle(self, horizon: int | None = None) -> None:
        s = self.config.stream
        acc = placed_prev = None
        if self._prefetch is not None:
            placed_prev, uploaded = self._prefetch
            self._prefetch = None
            acc = self._dispatch_restore(uploaded)
        # the eviction's count is summed over the ranks: every rank takes
        # the same branch below
        hmap, rows, n_evicted = self._evict(self.state.hmap,
                                            self.state.frame_idx)
        self.state = self.state._replace(hmap=hmap)
        self._land_pending_evict()
        pose = host_array(self.state.pose)
        vel = host_array(self.state.vel)
        if placed_prev is not None:
            self._take_accepted(placed_prev, acc)
        if n_evicted > 0:
            self._pending_evict = rows
        hor = 2 * s.interval if horizon is None else horizon
        pred = pose @ np.linalg.matrix_power(vel, hor)
        keys = (self.store.query_frustum(
            pred, self.config.camera, self.config.fusion,
            s.restore_margin_px, s.max_restore)
            if len(self.store) else np.zeros(0, np.int32))
        # the restore is local: a rank with nothing to restore skips it
        if keys.size:
            self._prefetch = self._pack_restore(keys)

    def _restore_keys(self, keys: np.ndarray) -> None:
        """Restore the given stored keys (this rank's) onto the device now
        (the keyframe backend's moves); quiesces the cycle first."""
        self.stream_sync()
        if keys.size:
            keys = keys[np.fromiter(
                (int(k) in self.store._index for k in keys), bool,
                keys.shape[0])]
        if keys.size == 0:
            return
        placed, uploaded = self._pack_restore(keys)
        self._take_accepted(placed, self._dispatch_restore(uploaded))

    def warm_stream(self) -> None:
        """Nothing to warm: the cycle has no transfer buffers of its own."""

    # -- rebuild spill session (the keyframe backend's streaming rebuild) ----

    def spill_begin(self) -> dict:
        """This rank's spill buffer for a streaming map rebuild: ``4 x
        num_blocks / n`` rows, plus one row that takes the dropped
        writes."""
        cap = max(4 * self.config.hash.num_blocks // self.mesh.size, 1)
        V = self.config.hash.voxels_per_block
        i32 = dict(dtype=torch.int32, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        return {
            "cap": cap,
            "keys": torch.full((cap + 1,), hash_ops.EMPTY_KEY, **i32),
            "tsdf": torch.zeros((cap + 1, V), **f32),
            "weight": torch.zeros((cap + 1, V), **f32),
            "born": torch.zeros((cap + 1,), **i32),
            "count": torch.zeros((), **i32),
        }

    def spill_evict(self, hmap, frame_idx: int, spill: dict):
        """Evict the rank's stale rows into its spill buffer (device only;
        no collectives)."""
        s = self.config.stream
        lcfg = local_hash_config(self.config.hash, self.mesh.size)
        hmap, keys, tsdf, weight, born, n = hash_ops.evict_stale(
            hmap, lcfg, int(frame_idx), s.max_age,
            s.max_evict // self.mesh.size)
        cap = spill["cap"]
        pos = torch.arange(keys.shape[0], device=keys.device)
        idx = torch.where(pos < n, spill["count"] + pos, cap).clamp(max=cap)
        for name, rows in (("keys", keys), ("tsdf", tsdf),
                           ("weight", weight), ("born", born)):
            spill[name][idx] = rows       # row cap collects the drops
        spill["count"] = spill["count"] + n
        return hmap

    def spill_finish(self, spill: dict, store: BlockStore) -> int:
        """Land the rank's spilled rows in ``store``; returns the rows the
        ranks together dropped to buffer overflow (one collective)."""
        n = int(spill["count"])
        cap = spill["cap"]
        m = min(n, cap)
        if m:
            store.add(*(host_array(spill[k][:m])
                        for k in ("keys", "tsdf", "weight", "born")))
        return distributed.psum_host(self.mesh, max(0, n - cap))

    def spill_finish_async(self, spill: dict, store: BlockStore,
                           on_overflow=None) -> None:
        """``spill_finish`` now (the single-device driver defers it; the
        sharded one lands it at once, as the JAX package's does)."""
        overflow = self.spill_finish(spill, store)
        if overflow and on_overflow is not None:
            on_overflow(overflow)

    # -- frames --------------------------------------------------------------

    def process(self, depth_raw) -> StepInfo:
        if (self.store is not None
                and len(self.trajectory) % self.config.stream.interval == 0):
            self._stream_cycle()
        self.state, info = self._step(self.state,
                                      depth_tensor(depth_raw, self.device))
        self.trajectory.append(info.pose)
        self.infos.append(info)
        return info

    def render(self, pose=None) -> rc_ops.RaycastOutput:
        """This rank's rows of the live render from ``pose`` (default: the
        current pose); every rank calls it together."""
        if pose is None:
            pose = self.state.pose
        else:
            pose = torch.as_tensor(pose, dtype=torch.float32,
                                   device=self.device)
        return make_sharded_render(self.config, self.mesh)(self.state.hmap,
                                                           pose)
