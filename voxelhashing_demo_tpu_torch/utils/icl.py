"""ICL-NUIM dataset support (native POV-Ray format): load, convert, export
(port of utils/icl.py; host numpy).

ICL-NUIM (Handa et al., ICRA 2014) is the standard synthetic living-room /
office benchmark named by BASELINE configs 3-4.  Two distributions exist:
the "TUM-compatible" one (depth.txt + 16-bit PNGs — ``utils/tum.py`` reads
those directly) and the NATIVE one handled here:

- ``scene_NN_FFFF.depth`` (or ``<prefix>FFFF.depth``): whitespace-separated
  float EUCLIDEAN depths, one per pixel row-major — the distance from the
  camera center along each pixel's ray, NOT planar z.  Conversion:
  ``z = d / |ray(u, v)|``.
- ``scene_NN_FFFF.txt``: POV-Ray camera parameters
  (``cam_pos/cam_dir/cam_up/cam_right = [x, y, z];``).  POV-Ray's frame is
  left-handed with +y UP; this engine's camera convention (+y DOWN,
  +z forward, right-handed — the TUM/Kinect convention the reference
  hard-codes, common.h:7-10) maps as columns ``[right, -up, dir]``.

ICL intrinsics: 640x480, fx=481.20, fy=480.0, cx=319.5, cy=239.5 (the
dataset page's calibration, expressed with +y down).

``export_icl_sequence`` writes synthetic sequences in the native format —
how the loader is exercised end-to-end in an image with no dataset files
(same strategy as utils/tum.export_sequence).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from ..config import CameraConfig


def icl_camera() -> CameraConfig:
    """The ICL-NUIM calibration (dataset page), +y-down convention."""
    return CameraConfig(
        width=640, height=480, fx=481.20, fy=480.0, cx=319.5, cy=239.5,
        depth_scale=5000.0,
    )


def _ray_norms(cam: CameraConfig) -> np.ndarray:
    """(H, W) norm of the pixel rays ((u-cx)/fx, (v-cy)/fy, 1)."""
    u = (np.arange(cam.width, dtype=np.float64) - cam.cx) / cam.fx
    v = (np.arange(cam.height, dtype=np.float64) - cam.cy) / cam.fy
    return np.sqrt(u[None, :] ** 2 + v[:, None] ** 2 + 1.0)


def euclidean_to_z(depth_euc: np.ndarray, cam: CameraConfig) -> np.ndarray:
    """Euclidean ray depth -> planar z depth (meters)."""
    return np.asarray(depth_euc, np.float64) / _ray_norms(cam)


def z_to_euclidean(depth_z: np.ndarray, cam: CameraConfig) -> np.ndarray:
    return np.asarray(depth_z, np.float64) * _ray_norms(cam)


_VEC_RE = re.compile(
    r"cam_(\w+)\s*=\s*\[([^\]]*)\]", re.MULTILINE
)


def parse_cam_file(path: str) -> dict:
    """Parse a POV-Ray camera .txt file into {name: np.array(3)}."""
    with open(path) as f:
        text = f.read()
    out = {}
    for name, vec in _VEC_RE.findall(text):
        vals = [float(x) for x in vec.replace(",", " ").split()]
        if len(vals) == 3:
            out[name] = np.array(vals, dtype=np.float64)
    return out


def pose_from_cam(params: dict) -> np.ndarray:
    """POV-Ray camera params -> T_wc in this engine's convention.

    Columns [right, -up, dir], normalized and re-orthogonalized (the
    dataset's right vectors carry the 4:3 aspect scaling).
    """
    d = params["dir"] / np.linalg.norm(params["dir"])
    r = params["right"] / np.linalg.norm(params["right"])
    u = params["up"] / np.linalg.norm(params["up"])
    # re-orthogonalize: dir is authoritative, then right, then up
    r = r - d * (r @ d)
    r /= np.linalg.norm(r)
    u2 = np.cross(d, r)  # right-handed down vector = dir x right
    y = u2 if (u2 @ (-u)) > 0 else -u2
    T = np.eye(4, dtype=np.float32)
    T[:3, 0] = r
    T[:3, 1] = y
    T[:3, 2] = d
    T[:3, 3] = params["pos"]
    return T


def read_depth_file(path: str, cam: CameraConfig) -> np.ndarray:
    """Read a native .depth file -> planar metric z depth (H, W) float32.

    Values <= 0 (POV-Ray background) become invalid (0).
    """
    with open(path) as f:
        vals = np.array(f.read().split(), dtype=np.float64)
    if vals.size != cam.width * cam.height:
        raise ValueError(
            f"{path}: {vals.size} values, expected "
            f"{cam.width * cam.height} ({cam.width}x{cam.height})"
        )
    euc = vals.reshape(cam.height, cam.width)
    z = euclidean_to_z(euc, cam)
    z = np.where(euc > 0, z, 0.0)
    return z.astype(np.float32)


class ICLSequence:
    """A native-format ICL-NUIM sequence directory: iterable
    (depth uint16 TUM-units, T_wc | None)."""

    _FRAME_RE = re.compile(r"^(.*?)(\d+)\.depth$")

    def __init__(self, root: str, cam: Optional[CameraConfig] = None,
                 max_frames: Optional[int] = None):
        self.root = root
        self.cam = cam or icl_camera()
        frames = []
        for name in os.listdir(root):
            m = self._FRAME_RE.match(name)
            if m:
                frames.append((int(m.group(2)), name,
                               f"{m.group(1)}{m.group(2)}.txt"))
        frames.sort()
        if not frames:
            raise FileNotFoundError(f"no .depth files under {root}")
        self.entries: List[Tuple[int, str, Optional[str]]] = [
            (i, d, c if os.path.exists(os.path.join(root, c)) else None)
            for i, d, c in frames
        ]
        if max_frames:
            self.entries = self.entries[:max_frames]

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        for _, depth_name, cam_name in self.entries:
            z = read_depth_file(
                os.path.join(self.root, depth_name), self.cam
            )
            raw = np.round(z * self.cam.depth_scale).astype(np.uint16)
            pose = None
            if cam_name is not None:
                pose = pose_from_cam(
                    parse_cam_file(os.path.join(self.root, cam_name))
                )
            yield raw, pose

    def load_all(self):
        depths, poses = [], []
        for raw, pose in self:
            depths.append(raw)
            poses.append(pose)
        return depths, poses


def export_icl_sequence(
    root: str,
    depths_raw: List[np.ndarray],
    poses: List[np.ndarray],
    cam: CameraConfig,
    prefix: str = "scene_00_",
) -> None:
    """Write a synthetic sequence in native ICL-NUIM format (euclidean
    .depth text + POV-Ray camera .txt), the loaders' round-trip fixture."""
    os.makedirs(root, exist_ok=True)
    for i, (raw, T) in enumerate(zip(depths_raw, poses)):
        z = np.asarray(raw, np.float64) / cam.depth_scale
        euc = z_to_euclidean(z, cam)
        euc = np.where(z > 0, euc, -1.0)  # POV-Ray background marker
        with open(os.path.join(root, f"{prefix}{i}.depth"), "w") as f:
            f.write(" ".join(f"{v:.6f}" for v in euc.ravel()))
        T = np.asarray(T, np.float64)
        r, y, d = T[:3, 0], T[:3, 1], T[:3, 2]
        lines = [
            f"cam_pos = [{T[0, 3]}, {T[1, 3]}, {T[2, 3]}];",
            f"cam_dir = [{d[0]}, {d[1]}, {d[2]}];",
            f"cam_up = [{-y[0]}, {-y[1]}, {-y[2]}];",
            f"cam_right = [{r[0]}, {r[1]}, {r[2]}];",
            "cam_angle = 90;",
        ]
        with open(os.path.join(root, f"{prefix}{i}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
