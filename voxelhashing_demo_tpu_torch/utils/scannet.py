"""ScanNet dataset support (extracted-frames format): load and export
(port of utils/scannet.py; host numpy, the native codec of utils/io.py).

ScanNet (Dai et al., CVPR 2017) is the room-scale RGB-D benchmark named by
BASELINE config 4 ("ScanNet room scene: map blocks sharded over 2 hosts").
Scenes ship as `.sens` archives; the project's standard extraction tool
writes per-scene directories that this loader reads:

    scene0000_00/
      depth/<frame>.png              16-bit PNG, depth in MILLIMETERS
      pose/<frame>.txt               4x4 camera-to-world, row-major text
      intrinsic/intrinsic_depth.txt  4x4 depth-camera intrinsics

Differences from TUM that matter to the engine (the reference hard-codes
the TUM convention, common.h:7-18):

- depth scale is 1000 units/m (millimeters), not TUM's 5000 — carried in
  the returned ``CameraConfig.depth_scale`` so ``preprocess`` divides
  correctly.
- poses are plain 4x4 row-major matrices (already T_wc, +y-down camera —
  the same convention the engine uses, no basis change needed), with
  untracked frames marked by non-finite entries (``-inf`` rows in the
  official exports) — those yield ``pose=None``.
- intrinsics come from a file per scene rather than a global calibration.

``export_scannet_sequence`` writes synthetic sequences in this exact
layout so the loader is exercised end-to-end in an image with no dataset
files (same strategy as utils/tum.export_sequence and
utils/icl.export_icl_sequence).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from ..config import CameraConfig
from . import io as depth_io


def read_matrix_txt(path: str) -> np.ndarray:
    """Read a whitespace-separated 4x4 matrix text file (pose/intrinsic)."""
    with open(path) as f:
        vals = np.array(f.read().split(), dtype=np.float64)
    if vals.size != 16:
        raise ValueError(f"{path}: {vals.size} values, expected 16 (4x4)")
    return vals.reshape(4, 4)


def camera_from_intrinsic(path: str, width: int, height: int,
                          depth_scale: float = 1000.0) -> CameraConfig:
    """ScanNet intrinsic_depth.txt -> CameraConfig (fx/fy/cx/cy from the
    4x4 K matrix; ScanNet depth PNGs are millimeters)."""
    K = read_matrix_txt(path)
    return CameraConfig(
        width=width, height=height,
        fx=float(K[0, 0]), fy=float(K[1, 1]),
        cx=float(K[0, 2]), cy=float(K[1, 2]),
        depth_scale=depth_scale,
    )


class ScanNetSequence:
    """An extracted ScanNet scene directory: iterable
    (depth uint16 in millimeters, T_wc | None).

    The engine consumes raw uint16 frames in ``cam.depth_scale`` units;
    ScanNet PNGs are already millimeters, so frames pass through undecoded
    beyond the PNG16 codec (native C++ decoder via utils/io.py).
    """

    _FRAME_RE = re.compile(r"^(\d+)\.png$")

    def __init__(self, root: str, cam: Optional[CameraConfig] = None,
                 max_frames: Optional[int] = None):
        self.root = root
        depth_dir = os.path.join(root, "depth")
        if not os.path.isdir(depth_dir):
            raise FileNotFoundError(f"no depth/ directory under {root}")
        frames = []
        for name in os.listdir(depth_dir):
            m = self._FRAME_RE.match(name)
            if m:
                frames.append((int(m.group(1)), name))
        frames.sort()
        if not frames:
            raise FileNotFoundError(f"no <frame>.png files under {depth_dir}")
        if max_frames:
            frames = frames[:max_frames]
        self.entries: List[Tuple[int, str, Optional[str]]] = []
        for idx, name in frames:
            pose_path = os.path.join(root, "pose", f"{idx}.txt")
            self.entries.append(
                (idx, name, pose_path if os.path.exists(pose_path) else None)
            )

        if cam is None:
            intr = os.path.join(root, "intrinsic", "intrinsic_depth.txt")
            first = depth_io.read_depth_png(
                os.path.join(depth_dir, frames[0][1])
            )
            h, w = first.shape
            if os.path.exists(intr):
                cam = camera_from_intrinsic(intr, w, h)
            else:
                # no calibration shipped: fall back to the TUM-class
                # defaults scaled to the file resolution, mm depth
                base = CameraConfig()
                s = w / base.width
                cam = CameraConfig(
                    width=w, height=h, fx=base.fx * s, fy=base.fy * s,
                    cx=(w - 1) / 2.0, cy=(h - 1) / 2.0, depth_scale=1000.0,
                )
        self.cam = cam

    def __len__(self):
        return len(self.entries)

    @property
    def has_gt(self) -> bool:
        return all(p is not None for _, _, p in self.entries)

    @staticmethod
    def _pose_or_none(path: Optional[str]) -> Optional[np.ndarray]:
        if path is None:
            return None
        T = read_matrix_txt(path)
        if not np.all(np.isfinite(T)):
            return None  # untracked frame (-inf rows in official exports)
        return T.astype(np.float32)

    def __iter__(self):
        for _, depth_name, pose_path in self.entries:
            raw = depth_io.read_depth_png(
                os.path.join(self.root, "depth", depth_name)
            )
            yield raw, self._pose_or_none(pose_path)

    def load_all(self):
        depths, poses = [], []
        for raw, pose in self:
            depths.append(raw)
            poses.append(pose)
        return depths, poses


def export_scannet_sequence(
    root: str,
    depths_raw: List[np.ndarray],
    poses: List[Optional[np.ndarray]],
    cam: CameraConfig,
) -> None:
    """Write a synthetic sequence in the extracted-ScanNet layout (mm depth
    PNGs + 4x4 pose text + intrinsic file), the loader's round-trip
    fixture.  ``depths_raw`` is uint16 in ``cam.depth_scale`` units and is
    rescaled to millimeters."""
    for sub in ("depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = cam.fx, cam.fy, cam.cx, cam.cy
    with open(os.path.join(root, "intrinsic", "intrinsic_depth.txt"),
              "w") as f:
        for row in K:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    scale = 1000.0 / cam.depth_scale
    for i, (raw, T) in enumerate(zip(depths_raw, poses)):
        mm = np.round(np.asarray(raw, np.float64) * scale)
        mm = np.clip(mm, 0, np.iinfo(np.uint16).max).astype(np.uint16)
        depth_io.write_depth_png(
            os.path.join(root, "depth", f"{i}.png"), mm
        )
        with open(os.path.join(root, "pose", f"{i}.txt"), "w") as f:
            M = (np.full((4, 4), -np.inf) if T is None
                 else np.asarray(T, np.float64))
            for row in M:
                f.write(" ".join(f"{v}" for v in row) + "\n")
