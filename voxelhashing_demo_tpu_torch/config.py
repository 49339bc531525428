"""Typed configuration of the PyTorch port.

A pure-Python copy of the JAX package's frozen dataclasses
(voxelhashing_demo_tpu/config.py): the same classes, fields, defaults and
field order, so a config (and later a checkpoint's ``config_json``) moves
between the two packages unchanged.  tests/test_torch_config.py holds the
two equal.  Field-by-field rationale lives in the JAX module's comments.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole depth camera: TUM fr1 intrinsics, 5000 uint16 units per m."""

    width: int = 640
    height: int = 480
    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3
    depth_scale: float = 5000.0
    depth_min: float = 0.1
    depth_max: float = 4.0

    def scaled(self, factor: int) -> "CameraConfig":
        """Intrinsics for an image downsampled by ``factor`` (ICP pyramid)."""
        return dataclasses.replace(
            self,
            width=self.width // factor,
            height=self.height // factor,
            fx=self.fx / factor,
            fy=self.fy / factor,
            # pixel-center convention: (cx + 0.5) / f - 0.5
            cx=(self.cx + 0.5) / factor - 0.5,
            cy=(self.cy + 0.5) / factor - 0.5,
        )


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Depth prefiltering: bilateral filter and flying-pixel rejection."""

    bilateral: bool = False
    bilateral_radius: int = 2
    bilateral_sigma_space: float = 1.5
    bilateral_sigma_depth: float = 0.03
    outlier_reject: bool = False
    outlier_band_base: float = 0.03
    outlier_band_quad: float = 0.007
    outlier_min_support: int = 3


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Point-to-plane ICP solved by damped Gauss-Newton."""

    max_iters: int = 20
    dist_thresh: float = 0.08
    normal_thresh: float = 0.6
    damping: float = 1e-6
    huber_delta: float = 0.0
    update_tol: float = 1e-5
    use_motion_prior: bool = True
    max_motion_trans: float = 0.30
    max_motion_rot_deg: float = 25.0
    pyramid: Tuple[int, ...] = (1,)
    pyramid_iters: Tuple[int, ...] = (20,)
    source_pools: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Curless-Levoy TSDF fusion parameters."""

    voxel_size: float = 0.02
    truncation: float = 0.10
    trunc_scale: float = 0.01
    max_weight: float = 255.0
    weight_sample: float = 1.0
    depth_weight_falloff: bool = True


@dataclasses.dataclass(frozen=True)
class DenseGridConfig:
    """Dense (non-hashed) TSDF volume."""

    dims: Tuple[int, int, int] = (128, 128, 128)
    origin: Tuple[float, float, float] = (-1.28, -1.28, 0.0)


@dataclasses.dataclass(frozen=True)
class HashConfig:
    """Voxel block hash table geometry.

    ``use_pallas_gather`` keeps the JAX package's name so configs stay
    interchangeable; in this package it routes the integrate depth gather
    through the window-gather kernel (ops/window_gather.py)."""

    num_buckets: int = 32768
    bucket_size: int = 4
    num_blocks: int = 16384
    block_size: int = 8
    max_active: int = 8192
    max_new_per_frame: int = 4096
    band_steps: int = 3
    candidate_stride: int = 1
    integrate_chunk: int = 128
    key_bits: int = 10
    use_pallas_gather: bool = False

    @property
    def voxels_per_block(self) -> int:
        return self.block_size ** 3

    @property
    def table_size(self) -> int:
        return self.num_buckets * self.bucket_size


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Surface prediction: ``mode`` "splat" (z-buffer splat of the surface
    band) or "march" (sphere trace of a view-local dense cache)."""

    max_steps: int = 96
    step_scale: float = 0.9
    min_step: float = 0.5
    coarse_step: float = 2.0
    near: float = 0.1
    far: float = 5.0
    normal_mode: str = "gradient"
    cache_dims: Tuple[int, int, int] = (256, 256, 256)
    mode: str = "splat"
    splat_band: float = 1.0
    splat_fill_rounds: int = 2
    splat_smooth_sigma: float = 3.0


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """Periodic garbage collection of stale voxel blocks."""

    enabled: bool = True
    interval: int = 8
    min_weight: float = 0.5
    max_blocks_per_gc: int = 1024
    min_age: int = 16


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Out-of-frustum block streaming to a host store (models/hash_slam)."""

    enabled: bool = False
    interval: int = 8
    max_age: int = 30
    max_evict: int = 2048
    max_restore: int = 2048
    restore_margin_px: float = 64.0


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe backend (models/keyframe_slam.py, ops/pose_graph.py):
    keyframe selection, loop gating, BA scheduling and solver, map
    rebuild / incremental reintegration, relocalization, host batching."""

    max_keyframes: int = 64
    max_edges: int = 256
    grow_on_capacity: bool = True
    min_rotation_deg: float = 10.0
    min_translation: float = 0.15
    ba_iters: int = 5
    ba_damping: float = 1e-4
    ba_solver: str = "auto"
    ba_dense_max_k: int = 128
    ba_cg_iters: int = 64
    ba_cg_tol: float = 1e-6
    ba_defer_edges: int = 1
    ba_defer_frames: int = 0
    ba_async: bool = False
    ba_robust_delta: float = 0.1
    ba_robust_kernel: str = "gm"
    kf_async_edges: bool = True
    ba_gnc_init_scale: float = 8.0
    icp_downsample: int = 2
    loop_radius: float = 0.8
    min_loop_separation: int = 3
    min_loop_inliers: int = 500
    max_loop_error: float = 1e-4
    loop_max_angle_deg: float = 75.0
    min_loop_obs: float = 1e-3
    loop_mutual_check: bool = False
    loop_mutual_max_trans: float = 0.03
    loop_mutual_max_rot_deg: float = 2.0
    loop_weight: float = 1.0
    odometry_weight: float = 1.0
    odometry_source: str = "icp"
    rebuild_map: bool = True
    rebuild_min_trans: float = 0.02
    rebuild_min_rot_deg: float = 1.0
    rebuild_incremental: bool = True
    rebuild_move_min_trans: float = 0.005
    rebuild_move_min_rot_deg: float = 0.25
    rebuild_incremental_cost: float = 0.0
    rebuild_window: int = 64
    relocalize: bool = True
    reloc_after: int = 3
    reloc_interval: int = 2
    reloc_max_candidates: int = 16
    reloc_procrustes: bool = True
    reloc_procrustes_rounds: int = 2
    sync_every: int = 1
    loop_max_batch: int = 4
    loop_icp_max_iters: int = 10


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level composition used by the SLAM pipelines in models/."""

    camera: CameraConfig = CameraConfig()
    frontend: FrontendConfig = FrontendConfig()
    icp: ICPConfig = ICPConfig()
    fusion: FusionConfig = FusionConfig()
    grid: DenseGridConfig = DenseGridConfig()
    hash: HashConfig = HashConfig()
    raycast: RaycastConfig = RaycastConfig()
    gc: GCConfig = GCConfig()
    keyframes: KeyframeConfig = KeyframeConfig()
    stream: StreamConfig = StreamConfig()


def tiny_config() -> PipelineConfig:
    """Small config for fast CPU tests: 80x60 image, small hash table."""
    cam = CameraConfig(width=80, height=60, fx=64.6625, fy=64.5625,
                       cx=39.7, cy=29.8)
    return PipelineConfig(
        camera=cam,
        grid=DenseGridConfig(dims=(64, 64, 64), origin=(-0.64, -0.64, 0.0)),
        hash=HashConfig(num_buckets=1024, bucket_size=4, num_blocks=1024,
                        max_active=512, max_new_per_frame=512),
        raycast=RaycastConfig(max_steps=64, cache_dims=(128, 128, 128)),
    )


def flagship_config() -> PipelineConfig:
    """The flagship configuration (same values as the JAX package's
    ``__graft_entry__.flagship_config``): 640x480 TUM fr1 camera, robust
    frontend, pyramid ICP (4, 2, 1) with the raced motion prior, 2 cm
    voxels, 65 536 buckets x 4 and 65 536 blocks, splat prediction."""
    return PipelineConfig(
        camera=CameraConfig(),
        frontend=FrontendConfig(bilateral=True, outlier_reject=True),
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2),
                      source_pools=(1, 1, 2), huber_delta=0.01),
        fusion=FusionConfig(voxel_size=0.02, truncation=0.08),
        hash=HashConfig(num_buckets=65536, bucket_size=4, num_blocks=65536,
                        max_active=4096, max_new_per_frame=4096,
                        candidate_stride=3),
        raycast=RaycastConfig(mode="splat", max_steps=96,
                              cache_dims=(256, 256, 256)),
        gc=GCConfig(enabled=True, interval=16),
        keyframes=KeyframeConfig(sync_every=16, icp_downsample=4,
                                 ba_defer_edges=6, ba_defer_frames=70,
                                 rebuild_window=192,
                                 rebuild_incremental_cost=5.0),
    )


def flagship_gather_config() -> PipelineConfig:
    """The flagship configuration with the integrate depth gather routed
    through the window-gather kernel (``use_pallas_gather=True``)."""
    cfg = flagship_config()
    return dataclasses.replace(
        cfg, hash=dataclasses.replace(cfg.hash, use_pallas_gather=True)
    )
