"""TUM RGB-D dataset support: association, loading, export (port of
utils/tum.py; host numpy, the native codec of utils/io.py).

The reference hard-codes two TUM-format depth PNGs and TUM fr1 intrinsics
(reference: Application.cpp:28-29, common.h:7-10) but has no dataset layer.
This module reads real TUM sequences (depth.txt / groundtruth.txt with
timestamp association) and can also *export* synthetic sequences in TUM
format — which is how the loaders get exercised end-to-end in an image with
no dataset files.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from . import io as depth_io


def _parse_list(path: str) -> List[Tuple[float, List[str]]]:
    """Parse a TUM-format list file: ``timestamp data...`` per line.

    Returned sorted by timestamp — real-world list files are not always
    ordered, and both the greedy ``associate`` walk and sequential SLAM
    ingestion assume monotone time."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    out.sort(key=lambda e: e[0])
    return out


def associate(
    a: List[Tuple[float, List[str]]],
    b: List[Tuple[float, List[str]]],
    max_dt: float = 0.02,
):
    """Greedy nearest-timestamp association of two TUM lists."""
    pairs = []
    j = 0
    for t_a, da in a:
        while j + 1 < len(b) and abs(b[j + 1][0] - t_a) <= abs(b[j][0] - t_a):
            j += 1
        if b and abs(b[j][0] - t_a) <= max_dt:
            pairs.append((t_a, da, b[j][0], b[j][1]))
    return pairs


def quat_to_matrix(qx, qy, qz, qw) -> np.ndarray:
    """Unit quaternion -> 3x3 rotation (TUM groundtruth convention)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
             2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
             2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
             1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def matrix_to_quat(R: np.ndarray):
    """3x3 rotation -> (qx, qy, qz, qw)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return qx, qy, qz, qw


class TUMSequence:
    """A TUM RGB-D sequence on disk: iterable (depth uint16, T_wc | None)."""

    def __init__(self, root: str, max_frames: Optional[int] = None,
                 max_dt: float = 0.02):
        self.root = root
        depth_list = _parse_list(os.path.join(root, "depth.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.has_gt = os.path.exists(gt_path)
        if self.has_gt:
            gt_list = _parse_list(gt_path)
            pairs = associate(depth_list, gt_list, max_dt)
            self.entries = [
                (t_d, d[0], self._pose_from(gt)) for t_d, d, _, gt in pairs
            ]
        else:
            self.entries = [(t, d[0], None) for t, d in depth_list]
        if max_frames:
            self.entries = self.entries[:max_frames]

    @staticmethod
    def _pose_from(data: List[str]) -> np.ndarray:
        tx, ty, tz, qx, qy, qz, qw = (float(x) for x in data[:7])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
        T[:3, 3] = (tx, ty, tz)
        return T

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        for _, rel, pose in self.entries:
            depth = depth_io.read_depth_png(os.path.join(self.root, rel))
            yield depth, pose

    def load_all(self, width: int, height: int):
        """Batch-decode every depth frame with the native threaded loader."""
        paths = [os.path.join(self.root, rel) for _, rel, _ in self.entries]
        depths = depth_io.read_depth_batch(paths, width, height)
        poses = [p for _, _, p in self.entries]
        return depths, poses


def export_sequence(
    root: str,
    depths: List[np.ndarray],
    poses: List[np.ndarray],
    fps: float = 30.0,
) -> None:
    """Write a synthetic sequence as a TUM-format dataset directory."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    depth_lines = ["# depth maps", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory",
                "# timestamp tx ty tz qx qy qz qw"]
    for i, (d, T) in enumerate(zip(depths, poses)):
        ts = i / fps
        rel = f"depth/{ts:.6f}.png"
        depth_io.write_depth_png(
            os.path.join(root, rel), np.asarray(d, dtype=np.uint16)
        )
        depth_lines.append(f"{ts:.6f} {rel}")
        T = np.asarray(T)
        qx, qy, qz, qw = matrix_to_quat(T[:3, :3])
        tx, ty, tz = T[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(depth_lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
