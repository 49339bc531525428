"""Synthetic depth sequences with exact ground truth (port of
utils/synthetic.py): two analytic scenes, their sphere-traced depth, the
Kinect-class sensor noise model, and the orbit, ramp and room-sweep
trajectories.

Frames come back as host uint16 numpy images in TUM units, the form a
depth camera delivers; the rendering runs on ``device`` (the CUDA card
unless the caller names another, see ``device.py``).

Random numbers.  The noise model is split in two: ``sensor_noise_core``
is deterministic and takes its five random fields as arguments;
``add_sensor_noise`` draws them from a ``torch.Generator`` in one fixed
order, each of the image's shape:

    normal (standard normal), u_edge, u_drop, u_out (uniform [0, 1)),
    z_out (uniform [0.4, 4.0))

The sequence makers seed a CPU generator from ``noise_seed`` and draw
frame after frame from it, whatever device renders, so a sequence is a
function of its arguments alone.  (torch's Philox stream differs from
JAX's threefry: the two packages agree on the core given the same fields,
and on the statistics of the whole.)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CameraConfig
from ..device import resolve
from ..geometry import camera as cam_geom
from ..geometry import se3
from ..ops.preprocess import _norm


def _vec(p: torch.Tensor, xs) -> torch.Tensor:
    return torch.tensor(xs, dtype=p.dtype, device=p.device)


def _box(p: torch.Tensor, center, half) -> torch.Tensor:
    q = torch.abs(p - _vec(p, center)) - _vec(p, half)
    return _norm(torch.clamp(q, min=0.0)) + torch.clamp(
        q.amax(dim=-1), max=0.0)


def _sphere(p: torch.Tensor, center, r: float) -> torch.Tensor:
    return _norm(p - _vec(p, center)) - r


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """Analytic scene: a sphere, a box, a back wall and a floor, in the
    world frame (= first camera frame; +z into the scene, +y down)."""
    d_sphere = _sphere(p, (0.0, 0.1, 1.6), 0.35)
    d_box = _box(p, (0.55, 0.25, 1.9), (0.22, 0.3, 0.22))
    d_wall = 2.6 - p[..., 2]
    d_floor = 0.62 - p[..., 1]
    return torch.minimum(torch.minimum(d_sphere, d_box),
                         torch.minimum(d_wall, d_floor))


def room_sdf(p: torch.Tensor) -> torch.Tensor:
    """Room-scale analytic scene: a 4 x 2 x 4 m room interior (+y down,
    camera starts inside looking +z) furnished with a pillar, spheres and
    boxes on every side, so a full sweep keeps ICP well-conditioned while
    the map grows to thousands of blocks.  (..., 3) -> (...)."""
    d = -_box(p, (0.0, -0.2, 1.0), (2.0, 1.0, 2.0))        # interior
    d = torch.minimum(d, _box(p, (1.45, 0.15, 2.2), (0.25, 0.65, 0.25)))
    d = torch.minimum(d, _sphere(p, (-1.35, 0.45, 1.6), 0.35))
    d = torch.minimum(d, _box(p, (-0.9, 0.45, -0.35), (0.3, 0.35, 0.3)))
    d = torch.minimum(d, _sphere(p, (0.7, 0.5, -0.2), 0.3))
    d = torch.minimum(d, _box(p, (0.1, 0.65, 2.35), (0.5, 0.15, 0.3)))
    d = torch.minimum(d, _sphere(p, (1.5, 0.55, 0.4), 0.25))
    return d


def render_depth(
    T_wc: torch.Tensor,
    cam: CameraConfig,
    max_steps: int = 128,
    sdf=scene_sdf,
) -> torch.Tensor:
    """Sphere-trace ``sdf`` from camera-to-world pose ``T_wc``; returns
    metric z-depth (H, W) on T_wc's device, 0 where nothing is hit in
    range."""
    rays_cam = cam_geom.pixel_rays(cam, device=T_wc.device)
    R = T_wc[:3, :3]
    origin = T_wc[:3, 3]
    dirs = rays_cam @ R.T
    inv_len = 1.0 / _norm(dirs)
    H, W = rays_cam.shape[:2]
    t = torch.full((H, W), 0.05, dtype=torch.float32, device=T_wc.device)
    hit = torch.zeros((H, W), dtype=torch.bool, device=T_wc.device)
    for _ in range(max_steps):
        s = sdf(origin + dirs * t[..., None])
        hit = hit | (s < 1e-4)
        t = torch.where(hit, t, t + torch.clamp(s, min=1e-4) * inv_len)
    valid = hit & (t > cam.depth_min) & (t < cam.depth_max)
    return torch.where(valid, t, 0.0)


def depth_to_raw(depth_m: torch.Tensor, cam: CameraConfig) -> np.ndarray:
    """Metric depth -> host uint16 image in camera units (quantized, like a
    real sensor)."""
    raw = torch.round(depth_m * cam.depth_scale).to(torch.int32)
    return raw.cpu().numpy().astype(np.uint16)


# --------------------------------------------------------------------------
# sensor noise
# --------------------------------------------------------------------------

def sensor_noise_core(
    depth_m: torch.Tensor,
    normal: torch.Tensor,
    u_edge: torch.Tensor,
    u_drop: torch.Tensor,
    u_out: torch.Tensor,
    z_out: torch.Tensor,
    disparity_quant: bool = False,
) -> torch.Tensor:
    """Kinect-class sensor noise on clean metric depth, given its random
    fields (all of depth_m's shape and device).

    - axial noise sigma(z) = 1.2 mm + 1.9 mm * (z - 0.4)^2 times ``normal``;
    - edge dropout: pixels whose 3x3 neighbourhood on the CLEAN depth
      spans more than 10 cm, or touches an invalid pixel, drop where
      ``u_edge < 0.8``;
    - random dropout where ``u_drop < 0.01``;
    - outliers: where ``u_out < 0.002`` the depth becomes ``z_out``;
    - ``disparity_quant``: depth quantized through a 1/8-pixel disparity
      over a 75 mm baseline at fx = 580 (Kinect v1 banding).

    Returns metric depth with 0 = invalid.
    """
    sigma_base, sigma_quad = 1.2e-3, 1.9e-3
    edge_band, p_edge = 0.10, 0.8
    p_drop, p_outlier = 0.01, 0.002

    valid = depth_m > 0
    z = depth_m
    sigma = sigma_base + sigma_quad * torch.square(torch.clamp(z - 0.4,
                                                               min=0.0))
    z = z + sigma * normal

    # 3x3 max-pools pad with -inf, as reduce_window's "SAME" identity does
    def pool(x):
        return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]

    inf = float("inf")
    mn = -pool(-torch.where(valid, depth_m, inf))
    mx = pool(torch.where(valid, depth_m, -inf))
    at_edge = ~torch.isfinite(mn) | ((mx - mn) > edge_band)

    drop = (at_edge & (u_edge < p_edge)) | (u_drop < p_drop)
    z = torch.where(u_out < p_outlier, z_out, z)

    if disparity_quant:
        bf8 = 8.0 * 0.075 * 580.0
        d8 = torch.round(bf8 / torch.clamp(z, min=1e-3))
        z = torch.where(z > 0, bf8 / torch.clamp(d8, min=1.0), z)

    return torch.where(valid & ~drop, torch.clamp(z, min=0.0), 0.0)


def draw_noise_fields(shape, generator: torch.Generator):
    """The five random fields of ``sensor_noise_core``, drawn from
    ``generator`` in the documented order, on the generator's device."""
    kw = dict(generator=generator, dtype=torch.float32,
              device=generator.device)
    normal = torch.randn(shape, **kw)
    u_edge = torch.rand(shape, **kw)
    u_drop = torch.rand(shape, **kw)
    u_out = torch.rand(shape, **kw)
    z_out = 0.4 + (4.0 - 0.4) * torch.rand(shape, **kw)
    return normal, u_edge, u_drop, u_out, z_out


def add_sensor_noise(
    depth_m: torch.Tensor,
    generator: torch.Generator,
    disparity_quant: bool = False,
) -> torch.Tensor:
    """``sensor_noise_core`` with its fields drawn from ``generator`` (and
    moved to depth_m's device).  Deterministic in the generator's state."""
    fields = [f.to(depth_m.device)
              for f in draw_noise_fields(depth_m.shape, generator)]
    return sensor_noise_core(depth_m, *fields,
                             disparity_quant=disparity_quant)


def _noise_generator(noise_seed: int | None):
    if noise_seed is None:
        return None
    return torch.Generator(device="cpu").manual_seed(int(noise_seed))


# --------------------------------------------------------------------------
# trajectories and sequences
# --------------------------------------------------------------------------

def orbit_pose(t: float, trans_amp: float = 0.15,
               rot_amp_deg: float = 6.0) -> np.ndarray:
    """Smooth ground-truth trajectory at phase t in [0, 1] (numpy 4x4)."""
    rot_amp = np.deg2rad(rot_amp_deg)
    v = np.array([
        trans_amp * np.sin(2 * np.pi * t),
        0.5 * trans_amp * np.sin(4 * np.pi * t),
        0.3 * trans_amp * (1 - np.cos(2 * np.pi * t)),
    ])
    w = np.array([
        0.4 * rot_amp * np.sin(2 * np.pi * t),
        rot_amp * np.sin(2 * np.pi * t),
        0.2 * rot_amp * np.cos(2 * np.pi * t) - 0.2 * rot_amp,
    ])
    xi = torch.as_tensor(np.concatenate([v, w]), dtype=torch.float32)
    return se3.exp(xi).numpy()


def _frame(T: np.ndarray, cam: CameraConfig, sdf, gen, as_raw: bool, device):
    """One rendered (and, with a generator, noised) frame at pose T."""
    d = render_depth(torch.as_tensor(T, dtype=torch.float32, device=device),
                     cam, sdf=sdf)
    if gen is not None:
        d = add_sensor_noise(d, gen)
    return depth_to_raw(d, cam) if as_raw else d


def make_ramp_sequence(
    cam: CameraConfig,
    num_frames: int,
    max_trans_step: float = 0.04,
    max_rot_step_deg: float = 2.0,
    as_raw: bool = True,
    device=None,
):
    """Accelerating-motion sequence: per-frame motion ramps linearly from
    ~0 up to (max_trans_step m, max_rot_step_deg deg) along a fixed screw
    direction; the hard case for identity-initialized ICP and the
    demonstration of the constant-velocity prior."""
    device = resolve(device)
    v_dir = np.array([0.7, 0.25, 0.35])
    v_dir /= np.linalg.norm(v_dir)
    w_dir = np.array([0.15, 1.0, 0.1])
    w_dir /= np.linalg.norm(w_dir)
    depths, poses = [], []
    T = np.eye(4, dtype=np.float32)
    for i in range(num_frames):
        if i > 0:
            ramp = i / max(num_frames - 1, 1)
            xi = np.concatenate([
                ramp * max_trans_step * v_dir,
                ramp * np.deg2rad(max_rot_step_deg) * w_dir,
            ])
            T = T @ se3.exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()
        depths.append(_frame(T, cam, scene_sdf, None, as_raw, device))
        poses.append(T.copy())
    return depths, poses


def make_sequence(
    cam: CameraConfig,
    num_frames: int,
    trans_amp: float = 0.12,
    rot_amp_deg: float = 5.0,
    as_raw: bool = True,
    noise_seed: int | None = None,
    device=None,
):
    """(depths, poses): ``num_frames`` depth frames along ``orbit_pose``
    and their exact camera-to-world poses.  depths are host uint16 images
    (as_raw) or metric float32 tensors on ``device``.  ``noise_seed``
    applies the sensor model per frame."""
    device = resolve(device)
    gen = _noise_generator(noise_seed)
    depths, poses = [], []
    for i in range(num_frames):
        t = i / max(num_frames - 1, 1)
        T = orbit_pose(t, trans_amp, rot_amp_deg)
        depths.append(_frame(T, cam, scene_sdf, gen, as_raw, device))
        poses.append(T)
    return depths, poses


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def room_sweep_pose(t: float, sweep_deg: float = 360.0,
                    orbit_radius: float = 0.5, bob: float = 0.08
                    ) -> np.ndarray:
    """Camera-to-world pose at phase t in [0, 1] of a room-scale sweep:
    the camera circles the center of ``room_sdf``'s room on a small orbit,
    yawing with the orbit so it always faces across the room, with a
    gentle vertical bob."""
    a = np.deg2rad(sweep_deg) * t
    R = _rot_y(a)
    center = np.array([0.0, -0.05, 1.0])   # mid-room (+y is down)
    pos = center - orbit_radius * (R @ np.array([0.0, 0.0, 1.0]))
    pos[1] += bob * np.sin(2 * a)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = pos
    return T


def make_room_sweep(
    cam: CameraConfig,
    num_frames: int,
    sweep_deg: float = 360.0,
    as_raw: bool = True,
    noise_seed: int | None = None,
    device=None,
):
    """Room-scale growing-map workload: a ``sweep_deg`` pan of ``room_sdf``
    from a small central orbit.  The map grows for the whole sweep (new
    walls keep entering the frustum), unlike ``make_sequence`` whose scene
    is fully observed after a few frames.  With ``noise_seed``, frames
    carry the sensor noise.

    Returned poses are first-camera-relative (pose[0] == I): the world
    frame of a SLAM run is its first camera frame."""
    device = resolve(device)
    gen = _noise_generator(noise_seed)
    depths, poses = [], []
    T0_inv = np.linalg.inv(room_sweep_pose(0.0, sweep_deg))
    for i in range(num_frames):
        T = room_sweep_pose(i / max(num_frames, 1), sweep_deg)
        depths.append(_frame(T, cam, room_sdf, gen, as_raw, device))
        poses.append((T0_inv @ T).astype(np.float32))
    return depths, poses
