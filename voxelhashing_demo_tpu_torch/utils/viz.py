"""Offline visualization: shading, colormaps, camera paths, frustum overlay
(port of utils/viz.py).

The reference's display stack is interactive OpenGL: SDL window
(Window.cpp), Phong point-cloud shader (MainShader.frag), fly camera
(camera.cpp), debug frustum lines (Frustum.cpp), and PNG texture dumps
(SDFRenderer.cpp:139-149).  Here there is no window; the equivalent
surface is offline rendering — raycast any viewpoint (ops/splat.py or
ops/raycast.py), shade it here, and write PNGs.  Every capability maps:

- Phong display          -> ``shade_rgb`` (Lambert + Blinn-Phong specular)
- fly/orbit camera       -> ``orbit_poses`` / ``look_at`` path generators
- debug frustum draw     -> ``draw_frustum`` wireframe overlay
- printDebugImage (PNG)  -> ``write_png_rgb`` (pure-stdlib encoder)

The shading functions take the port's ``RaycastOutput`` (or numpy arrays):
tensors on any device, fetched to the host in one copy per call, then
shaded in numpy as the JAX package does.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import CameraConfig

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


# --------------------------------------------------------------------------
# PNG output (8-bit RGB)
# --------------------------------------------------------------------------

def write_png_rgb(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an RGB PNG (reference: printDebugImage's
    stbi_write_png, SDFRenderer.cpp:146-147)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    assert c == 3
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        data = ctype + payload
        return (
            struct.pack(">I", len(payload))
            + data
            + struct.pack(">I", zlib.crc32(data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(
            _PNG_SIG
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b"")
        )


# --------------------------------------------------------------------------
# shading and colormaps
# --------------------------------------------------------------------------

def _host(*arrays):
    """The arrays as float32 numpy; tensors (of one device) are fetched in
    one copy, flattened and concatenated there first."""
    if not any(isinstance(a, torch.Tensor) for a in arrays):
        return [np.asarray(a, dtype=np.float32) for a in arrays]
    ts = [torch.as_tensor(a) for a in arrays]
    flat = torch.cat([t.to(device=ts[0].device, dtype=torch.float32)
                      .reshape(-1) for t in ts]).cpu().numpy()
    out, at = [], 0
    for t in ts:
        out.append(flat[at: at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def shade_rgb(
    out,
    light_dir: Sequence[float] = (0.3, -0.4, 0.85),
    base_color: Sequence[float] = (0.75, 0.78, 0.82),
    specular: float = 0.25,
    shininess: float = 32.0,
    background: Sequence[float] = (0.05, 0.05, 0.08),
) -> np.ndarray:
    """Blinn-Phong shading of a RaycastOutput -> (H, W, 3) uint8.

    Camera-space: the viewer looks down +z, so view dir is -ray.  Matches
    the intent of the reference's MainShader.frag Phong debug display.
    """
    n, hit, p = _host(out.normals, out.hit, out.points)
    hit = hit > 0.5
    l = -np.asarray(light_dir, dtype=np.float32)
    l /= np.linalg.norm(l)

    v = -p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    h_vec = l + v
    h_vec /= np.maximum(np.linalg.norm(h_vec, axis=-1, keepdims=True), 1e-9)

    lam = np.clip((n * l).sum(-1), 0.0, 1.0)
    spec = np.clip((n * h_vec).sum(-1), 0.0, 1.0) ** shininess

    base = np.asarray(base_color, dtype=np.float32)
    rgb = (0.15 + 0.85 * lam[..., None]) * base + specular * spec[..., None]
    bg = np.asarray(background, dtype=np.float32)
    rgb = np.where(hit[..., None], rgb, bg)
    return (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)


def depth_rgb(depth, d_min: float = 0.3, d_max: float = 4.0) -> np.ndarray:
    """Turbo-like depth colormap -> (H, W, 3) uint8; invalid (0) is black."""
    (d,) = _host(depth)
    t = np.clip((d - d_min) / max(d_max - d_min, 1e-6), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * t - 1.0), 0.0, 1.0)
    rgb = np.stack([r, g, b], axis=-1)
    rgb = np.where((d > 0)[..., None], rgb, 0.0)
    return (rgb * 255).astype(np.uint8)


def normal_rgb(normals, hit=None) -> np.ndarray:
    """Normals -> RGB ((n+1)/2 convention), (H, W, 3) uint8."""
    if hit is None:
        (n,) = _host(normals)
    else:
        n, hit = _host(normals, hit)
    rgb = (n + 1.0) * 0.5
    if hit is not None:
        rgb = np.where((hit > 0.5)[..., None], rgb, 0.0)
    return (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)


# --------------------------------------------------------------------------
# camera paths (reference: camera.cpp fly camera, offline form)
# --------------------------------------------------------------------------

def look_at(
    eye: Sequence[float],
    target: Sequence[float],
    up: Sequence[float] = (0.0, -1.0, 0.0),
) -> np.ndarray:
    """Camera-to-world pose looking from ``eye`` at ``target``.

    Convention: camera +z forward, +y down (depth-image convention used
    throughout the framework); ``up`` defaults to world -y.
    """
    eye = np.asarray(eye, dtype=np.float32)
    fwd = np.asarray(target, dtype=np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    upn = np.asarray(up, dtype=np.float32)
    right = np.cross(-upn, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0] = right
    T[:3, 1] = down
    T[:3, 2] = fwd
    T[:3, 3] = eye
    return T


def orbit_poses(
    center: Sequence[float],
    radius: float,
    height: float,
    n_frames: int,
    sweep_deg: float = 360.0,
) -> List[np.ndarray]:
    """Circular orbit around ``center``, always looking at it — the offline
    replacement for the reference's interactive WASD fly camera."""
    out = []
    c = np.asarray(center, dtype=np.float32)
    for i in range(n_frames):
        a = np.deg2rad(sweep_deg) * i / max(n_frames, 1)
        eye = c + np.array(
            [radius * np.sin(a), height, -radius * np.cos(a)],
            dtype=np.float32,
        )
        out.append(look_at(eye, c))
    return out


# --------------------------------------------------------------------------
# frustum overlay (reference: Frustum.cpp debug wireframe)
# --------------------------------------------------------------------------

def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Bresenham line into (H, W, 3) uint8, clipped."""
    h, w = img.shape[:2]
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    steps = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.linspace(x0, x1, steps + 1).round().astype(int)
    ys = np.linspace(y0, y1, steps + 1).round().astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def frustum_corners(
    cam: CameraConfig, T_wc: np.ndarray, near: float, far: float
) -> np.ndarray:
    """(8, 3) world-space frustum corners of a camera pose (reference:
    Frustum::setFromVectors, Frustum.cpp:28-107)."""
    T = np.asarray(T_wc, dtype=np.float32)
    corners = []
    for z in (near, far):
        for u, v in ((0, 0), (cam.width, 0), (cam.width, cam.height),
                     (0, cam.height)):
            x = (u - cam.cx) / cam.fx * z
            y = (v - cam.cy) / cam.fy * z
            corners.append(T[:3, :3] @ np.array([x, y, z]) + T[:3, 3])
    return np.stack(corners)


def draw_frustum(
    img: np.ndarray,
    cam_view: CameraConfig,
    T_view: np.ndarray,
    cam_frustum: CameraConfig,
    T_frustum: np.ndarray,
    near: float = 0.2,
    far: float = 2.0,
    color: Tuple[int, int, int] = (255, 80, 80),
) -> np.ndarray:
    """Overlay the wireframe of camera ``T_frustum`` onto an image rendered
    from ``T_view`` (the reference's GL_LINES frustum, Frustum.cpp:119-130,
    as a host-side image-space op)."""
    img = img.copy()
    corners = frustum_corners(cam_frustum, T_frustum, near, far)
    T = np.asarray(T_view, dtype=np.float32)
    R_cw = T[:3, :3].T
    pc = (corners - T[:3, 3]) @ R_cw.T
    z = np.maximum(pc[:, 2], 1e-6)
    uv = np.stack(
        [pc[:, 0] / z * cam_view.fx + cam_view.cx,
         pc[:, 1] / z * cam_view.fy + cam_view.cy],
        axis=-1,
    )
    visible = pc[:, 2] > 1e-3
    edges = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        if visible[a] and visible[b]:
            _draw_line(img, uv[a], uv[b], color)
    return img
