"""Surface point-cloud extraction and PLY export (port of
utils/pointcloud.py).

The map exports as a standard PLY point cloud (binary little-endian)
loadable by MeshLab / Open3D / CloudCompare.  Voxels in the zero-crossing
band (weight > 0, |sdf| < band) are pushed onto the measured surface
along the central-difference TSDF gradient, and carry that normal when
requested.  Host numpy code; the map's tensors may live on any device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import FusionConfig, HashConfig
from ..device import host_array as _host
from ..geometry import coords
from ..ops.hash_ops import HashMap, _local_offsets


def extract_surface_points(
    hmap: HashMap,
    cfg: HashConfig,
    fusion: FusionConfig,
    band: float = 0.5,
    with_normals: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """(points (N, 3), normals (N, 3) | None, weights (N,)) of the surface
    band, world frame.  Host-side (offline export path): each of the map's
    tensors comes to the host once."""
    ptrs = _host(hmap.ptrs)
    keys = _host(hmap.keys)
    occ = np.nonzero(ptrs >= 0)[0]
    if occ.size == 0:
        empty = np.zeros((0, 3), np.float32)
        return empty, (empty if with_normals else None), np.zeros(0)

    blocks = coords.unpack_block_key(
        torch.from_numpy(keys[occ]), cfg.key_bits).numpy()
    rows = ptrs[occ]
    sdf = _host(hmap.tsdf)[rows]                 # (A, V)
    wgt = _host(hmap.weight)[rows]
    local = _local_offsets(cfg.block_size).numpy()       # (V, 3)

    vox = blocks[:, None, :] * cfg.block_size + local[None]   # (A, V, 3)
    surf = (wgt > 0) & (np.abs(sdf) < band * fusion.voxel_size)
    pts_vox = vox[surf].astype(np.float32)
    pts = pts_vox * fusion.voxel_size
    sdf_s = sdf[surf]
    wgt_s = wgt[surf]

    # normals (the surface push needs them, wanted or not): central
    # differences of the TSDF within each block row where the
    # neighbors exist; fall back to zero normal at block borders
    g = np.zeros((surf.sum(), 3), dtype=np.float32)
    B = cfg.block_size
    sdf3 = sdf.reshape(-1, B, B, B)
    w3 = wgt.reshape(-1, B, B, B)
    a_idx, v_idx = np.nonzero(surf)
    lx, ly, lz = (local[v_idx, 0], local[v_idx, 1], local[v_idx, 2])
    for axis, l in enumerate((lx, ly, lz)):
        hi = np.minimum(l + 1, B - 1)
        lo = np.maximum(l - 1, 0)
        sel_hi = [a_idx, lx.copy(), ly.copy(), lz.copy()]
        sel_lo = [a_idx, lx.copy(), ly.copy(), lz.copy()]
        sel_hi[1 + axis] = hi
        sel_lo[1 + axis] = lo
        d_hi = sdf3[tuple(sel_hi)]
        d_lo = sdf3[tuple(sel_lo)]
        ok = (w3[tuple(sel_hi)] > 0) & (w3[tuple(sel_lo)] > 0)
        g[:, axis] = np.where(
            ok, (d_hi - d_lo) / ((hi - lo) * fusion.voxel_size + 1e-9),
            0.0,
        )
    norm = np.linalg.norm(g, axis=-1, keepdims=True)
    normals_all = np.where(norm > 1e-6, g / np.maximum(norm, 1e-6), 0.0)
    # push points onto the measured surface along the normal
    pts = pts - normals_all * sdf_s[:, None]
    normals = normals_all.astype(np.float32) if with_normals else None

    return pts.astype(np.float32), normals, wgt_s


def save_ply(
    path: str,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
) -> int:
    """Binary little-endian PLY of (N, 3) points (+ optional normals).
    Returns the number of points written."""
    n = len(points)
    props = ["property float x", "property float y", "property float z"]
    cols = [np.asarray(points, dtype="<f4")]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(normals, dtype="<f4"))
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n}"] + props + ["end_header", ""]
    )
    body = np.concatenate(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(body.tobytes())
    return n


def load_ply_points(path: str) -> np.ndarray:
    """Minimal reader for the PLYs written above (used by tests)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode()
    n = int([l for l in header.splitlines()
             if l.startswith("element vertex")][0].split()[-1])
    n_props = sum(1 for l in header.splitlines()
                  if l.startswith("property float"))
    arr = np.frombuffer(data[head_end:], dtype="<f4", count=n * n_props)
    return arr.reshape(n, n_props)[:, :3]


def export_map_ply(
    path: str,
    hmap: HashMap,
    cfg: HashConfig,
    fusion: FusionConfig,
    with_normals: bool = True,
) -> int:
    pts, normals, _ = extract_surface_points(
        hmap, cfg, fusion, with_normals=with_normals
    )
    return save_ply(path, pts, normals)
