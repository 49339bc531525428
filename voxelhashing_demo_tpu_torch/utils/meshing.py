"""Triangle-mesh extraction from the voxel-hashed TSDF by marching
tetrahedra (port of utils/meshing.py).

- every occupied block is assembled into a (B+1)^3 corner grid, borrowing
  the +x/+y/+z face/edge/corner layers from neighboring blocks through the
  hash map (so surfaces crossing block boundaries are seamless);
- each cell splits into 6 tetrahedra; each tetrahedron with a sign change
  emits 1-2 triangles with linear interpolation along its cut edges;
- output is a triangle soup (no vertex welding) written as binary PLY.

Host numpy code, chunked over blocks: the offline export path.  The map's
tensors may live on any device; each comes to the host once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import FusionConfig, HashConfig
from ..device import host_array as _host
from ..geometry import coords
from ..ops.hash_ops import HashMap

# 6-tetrahedra decomposition of the unit cube sharing the 0-7 diagonal
# (corner ids 0..7 with corner c = (x, y, z) bits: c = x + 2y + 4z)
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 7, 5],
    [0, 5, 7, 4],
    [0, 4, 7, 6],
    [0, 6, 7, 2],
    [0, 2, 7, 3],
], dtype=np.int32)

_CORNERS = np.array(
    [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int32
)

# tetrahedron edges: pairs of local vertex ids 0..3
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# triangles per sign case (bit i set = vertex i inside, sdf < 0).
# each entry: list of triangles, each a triple of edge ids into _TET_EDGES.
_CASE_TRIS = {
    1: [(0, 1, 2)],
    2: [(0, 4, 3)],
    4: [(1, 3, 5)],
    8: [(2, 5, 4)],
    14: [(0, 2, 1)],
    13: [(0, 3, 4)],
    11: [(1, 5, 3)],
    7: [(2, 4, 5)],
    3: [(1, 2, 4), (1, 4, 3)],
    12: [(1, 4, 2), (1, 3, 4)],
    5: [(0, 2, 5), (0, 5, 3)],
    10: [(0, 5, 2), (0, 3, 5)],
    6: [(0, 4, 5), (0, 5, 1)],
    9: [(0, 5, 4), (0, 1, 5)],
}


def _corner_grids(
    hmap: HashMap, cfg: HashConfig
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(blocks (N,3), sdf (N,B+1,B+1,B+1), weight (...)) with +1 layers
    stitched from neighbor blocks via the hash map."""
    B = cfg.block_size
    ptrs = _host(hmap.ptrs)
    keys = _host(hmap.keys)
    occ = np.nonzero(ptrs >= 0)[0]
    blocks = coords.unpack_block_key(
        torch.from_numpy(keys[occ]), cfg.key_bits).numpy()
    rows = ptrs[occ]
    coord2row: Dict[Tuple[int, int, int], int] = {
        tuple(b): r for b, r in zip(blocks.tolist(), rows.tolist())
    }
    # hash rows are linearized z-major (coords.linearize_voxel: z*B^2 +
    # y*B + x), so the raw reshape is [z][y][x]; transpose to [x][y][z]
    sdf_rows = (
        _host(hmap.tsdf).reshape(-1, B, B, B).transpose(0, 3, 2, 1)
    )
    w_rows = (
        _host(hmap.weight).reshape(-1, B, B, B).transpose(0, 3, 2, 1)
    )

    N = len(occ)
    G = B + 1
    sdf = np.zeros((N, G, G, G), dtype=np.float32)
    wgt = np.zeros((N, G, G, G), dtype=np.float32)
    sdf[:, :B, :B, :B] = sdf_rows[rows]
    wgt[:, :B, :B, :B] = w_rows[rows]

    # neighbor offsets covering the +face/+edge/+corner layers
    slices = {0: slice(0, B), 1: slice(B, G)}
    src_sl = {0: slice(0, B), 1: slice(0, 1)}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                if dx == dy == dz == 0:
                    continue
                for i, b in enumerate(blocks):
                    nb = (b[0] + dx, b[1] + dy, b[2] + dz)
                    r = coord2row.get(nb)
                    if r is None:
                        continue
                    sdf[i, slices[dx], slices[dy], slices[dz]] = (
                        sdf_rows[r][src_sl[dx], src_sl[dy], src_sl[dz]]
                    )
                    wgt[i, slices[dx], slices[dy], slices[dz]] = (
                        w_rows[r][src_sl[dx], src_sl[dy], src_sl[dz]]
                    )
    return blocks, sdf, wgt


def extract_mesh(
    hmap: HashMap,
    cfg: HashConfig,
    fusion: FusionConfig,
    chunk_blocks: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """Marching-tetrahedra mesh of the TSDF zero level set.

    Returns (vertices (V, 3) float32 world coords, faces (F, 3) int32).
    Triangle soup: V == 3 F (no welding).  Winding is consistent per case
    table but not globally guaranteed; viewers with back-face culling off
    render it correctly.
    """
    blocks, sdf, wgt = _corner_grids(hmap, cfg)
    B = cfg.block_size
    if len(blocks) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    all_tris = []
    for c0 in range(0, len(blocks), chunk_blocks):
        blk = blocks[c0 : c0 + chunk_blocks]
        s = sdf[c0 : c0 + chunk_blocks]
        w = wgt[c0 : c0 + chunk_blocks]
        n = len(blk)

        # cell corner values: (n, B, B, B, 8)
        cell_s = np.empty((n, B, B, B, 8), dtype=np.float32)
        cell_w = np.empty((n, B, B, B, 8), dtype=np.float32)
        for c in range(8):
            ox, oy, oz = _CORNERS[c]
            cell_s[..., c] = s[:, ox : ox + B, oy : oy + B, oz : oz + B]
            cell_w[..., c] = w[:, ox : ox + B, oy : oy + B, oz : oz + B]

        # world position of cell origin (voxel centers define the lattice)
        bx = blk[:, 0][:, None, None, None]
        by = blk[:, 1][:, None, None, None]
        bz = blk[:, 2][:, None, None, None]
        ix, iy, iz = np.meshgrid(
            np.arange(B), np.arange(B), np.arange(B), indexing="ij"
        )
        cell_pos = np.stack(
            [bx * B + ix, by * B + iy, bz * B + iz], axis=-1
        ).astype(np.float32)                      # (n, B, B, B, 3)

        flat_s = cell_s.reshape(-1, 8)
        flat_w = cell_w.reshape(-1, 8)
        flat_p = cell_pos.reshape(-1, 3)

        # only cells whose 8 corners are all observed
        ok = (flat_w > 0).all(axis=1)
        if not ok.any():
            continue
        flat_s = flat_s[ok]
        flat_p = flat_p[ok]

        corners_f = _CORNERS.astype(np.float32)   # (8, 3)
        for tet in _TETS:
            ts = flat_s[:, tet]                    # (M, 4)
            case = (
                (ts[:, 0] < 0).astype(np.int32)
                | ((ts[:, 1] < 0).astype(np.int32) << 1)
                | ((ts[:, 2] < 0).astype(np.int32) << 2)
                | ((ts[:, 3] < 0).astype(np.int32) << 3)
            )
            tp = flat_p[:, None, :] + corners_f[tet][None]   # (M, 4, 3)
            # interpolated crossing point on each of the 6 tet edges
            a = _TET_EDGES[:, 0]
            b = _TET_EDGES[:, 1]
            sa, sb = ts[:, a], ts[:, b]                      # (M, 6)
            denom = sa - sb
            t = np.where(np.abs(denom) > 1e-12, sa / np.where(
                np.abs(denom) > 1e-12, denom, 1.0), 0.5)
            t = np.clip(t, 0.0, 1.0)
            pe = tp[:, a] + t[..., None] * (tp[:, b] - tp[:, a])  # (M,6,3)

            for case_id, tris in _CASE_TRIS.items():
                m = case == case_id
                if not m.any():
                    continue
                for e0, e1, e2 in tris:
                    all_tris.append(
                        np.stack(
                            [pe[m, e0], pe[m, e1], pe[m, e2]], axis=1
                        )
                    )

    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(all_tris, axis=0)       # (F, 3, 3) voxel coords
    verts = (tris.reshape(-1, 3) * fusion.voxel_size).astype(np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts, faces


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> int:
    """Binary little-endian PLY with triangle faces. Returns face count."""
    header = "\n".join([
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header", "",
    ])
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.asarray(verts, dtype="<f4").tobytes())
        body = np.empty(
            len(faces),
            dtype=[("n", "u1"), ("v", "<i4", (3,))],
        )
        body["n"] = 3
        body["v"] = faces
        f.write(body.tobytes())
    return len(faces)


def export_mesh_ply(
    path: str, hmap: HashMap, cfg: HashConfig, fusion: FusionConfig
) -> int:
    verts, faces = extract_mesh(hmap, cfg, fusion)
    return save_mesh_ply(path, verts, faces)
