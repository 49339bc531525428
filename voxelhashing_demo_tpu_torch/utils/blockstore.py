"""Host-side out-of-core voxel block store for streaming SLAM (the port's
own copy of the JAX package's utils/blockstore.py, same bookkeeping).

The device hash table holds only the working set (blocks near the current
frustum); blocks out of view long enough are evicted here
(``ops.hash_ops.evict_stale``) and re-inserted on revisit
(``ops.hash_ops.restore_blocks``).  This is the host half of the original
VoxelHashing paper's GPU<->host streaming.  Plain numpy: no torch, no
device work, safe to call from the per-frame loop.

The order of its answers is part of the result: holes left by ``take`` are
reused last-in first-out, and ``query_frustum`` returns keys in store-row
order, cut nearest-first past ``max_n``.  That order is the restore order,
which decides the free-list rows the keys get on the device.

Storage is columnar (one dict from packed key -> row index into growable
numpy arrays) so frustum queries over the whole store are a single
vectorized pass.
"""

from __future__ import annotations

import numpy as np

from ..config import CameraConfig, FusionConfig, HashConfig

EMPTY_KEY = np.int32(0x7FFFFFFF)  # == geometry.coords.EMPTY_KEY


def unpack_keys_np(keys: np.ndarray, key_bits: int) -> np.ndarray:
    """numpy twin of geometry.coords.unpack_block_key."""
    bias = 1 << (key_bits - 1)
    mask = (1 << key_bits) - 1
    x = ((keys >> (2 * key_bits)) & mask) - bias
    y = ((keys >> key_bits) & mask) - bias
    z = (keys & mask) - bias
    return np.stack([x, y, z], axis=-1).astype(np.int32)


def blocks_in_frustum_np(
    blocks: np.ndarray,
    T_wc: np.ndarray,
    cam: CameraConfig,
    hcfg: HashConfig,
    fusion: FusionConfig,
    margin_px: float,
) -> np.ndarray:
    """numpy twin of ops.hash_ops.block_in_frustum (z-adaptive margin), for
    querying the host store against a (predicted) camera pose."""
    half = 0.5 * hcfg.block_size * fusion.voxel_size
    radius = half * 1.7320508
    center = blocks.astype(np.float32) * (
        hcfg.block_size * fusion.voxel_size
    ) + half
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    pc = (center - t) @ R  # R^T @ (c - t)
    z = pc[:, 2]
    safe_z = np.maximum(z, 1e-6)
    u = pc[:, 0] / safe_z * cam.fx + cam.cx
    v = pc[:, 1] / safe_z * cam.fy + cam.cy
    zm = np.maximum(z, 0.05)
    mu = margin_px + radius * cam.fx / zm
    mv = margin_px + radius * cam.fy / zm
    near = cam.depth_min - 2.0 * half
    far = cam.depth_max + 2.0 * half
    return (
        (z > near)
        & (z < far)
        & (u >= -mu)
        & (u < cam.width + mu)
        & (v >= -mv)
        & (v < cam.height + mv)
    )


class BlockStore:
    """Growable columnar store: packed key -> (tsdf row, weight row)."""

    def __init__(self, hcfg: HashConfig, capacity: int = 4096):
        self._hcfg = hcfg
        V = hcfg.voxels_per_block
        self._index: dict[int, int] = {}       # key -> row
        self._keys = np.full(capacity, EMPTY_KEY, dtype=np.int32)
        self._blocks = np.zeros((capacity, 3), dtype=np.int32)
        self._tsdf = np.zeros((capacity, V), dtype=np.float32)
        self._weight = np.zeros((capacity, V), dtype=np.float32)
        # original device-row allocation stamp (frame idx): preserved
        # across evict/restore so born-gated incremental reintegration
        # (models/keyframe_slam) stays exact for streamed maps
        self._born = np.zeros(capacity, dtype=np.int32)
        self._n = 0
        self._free: list[int] = []             # holes from take()
        self.total_evicted = 0
        self.total_restored = 0

    def __len__(self) -> int:
        return len(self._index)

    def _grow(self, need: int) -> None:
        cap = self._keys.shape[0]
        if self._n + need <= cap:
            return
        new_cap = max(cap * 2, self._n + need)
        V = self._tsdf.shape[1]

        def grow(a, shape):
            out = np.zeros(shape, dtype=a.dtype)
            out[: self._n] = a[: self._n]
            return out

        self._keys = np.concatenate(
            [self._keys[: self._n],
             np.full(new_cap - self._n, EMPTY_KEY, dtype=np.int32)]
        )
        self._blocks = grow(self._blocks, (new_cap, 3))
        self._tsdf = grow(self._tsdf, (new_cap, V))
        self._weight = grow(self._weight, (new_cap, V))
        self._born = grow(self._born, (new_cap,))

    def add(
        self, keys: np.ndarray, tsdf: np.ndarray, weight: np.ndarray,
        born: np.ndarray | None = None,
    ) -> int:
        """Ingest an eviction batch (padded with EMPTY_KEY).  A key that is
        already stored is overwritten (the incoming copy is newer: it was
        restored, re-observed, and evicted again).  Returns #stored."""
        keys = np.asarray(keys)
        live = keys != EMPTY_KEY
        idxs = np.nonzero(live)[0]
        if idxs.size == 0:
            return 0
        blocks = unpack_keys_np(keys[idxs], self._hcfg.key_bits)
        stored = 0
        for j, i in enumerate(idxs):
            k = int(keys[i])
            row = self._index.get(k)
            if row is None:
                row = self._free.pop() if self._free else None
                if row is None:
                    self._grow(1)
                    row = self._n
                    self._n += 1
                self._index[k] = row
            self._keys[row] = k
            self._blocks[row] = blocks[j]
            self._tsdf[row] = tsdf[i]
            self._weight[row] = weight[i]
            self._born[row] = 0 if born is None else born[i]
            stored += 1
        self.total_evicted += stored
        return stored

    def query_frustum(
        self,
        T_wc: np.ndarray,
        cam: CameraConfig,
        fusion: FusionConfig,
        margin_px: float,
        max_n: int,
    ) -> np.ndarray:
        """Stored keys whose blocks fall in the frustum of ``T_wc``
        (at most max_n, nearest-first so the visible set restores before
        the periphery when the batch overflows)."""
        if not self._index:
            return np.zeros(0, dtype=np.int32)
        n = self._n
        occ = self._keys[:n] != EMPTY_KEY
        vis = np.zeros(n, dtype=bool)
        vis[occ] = blocks_in_frustum_np(
            self._blocks[:n][occ], T_wc, cam, self._hcfg, fusion, margin_px
        )
        idx = np.nonzero(vis)[0]
        if idx.size > max_n:
            half = 0.5 * self._hcfg.block_size * fusion.voxel_size
            center = self._blocks[:n][idx].astype(np.float32) * (
                self._hcfg.block_size * fusion.voxel_size
            ) + half
            d = np.linalg.norm(center - T_wc[:3, 3], axis=-1)
            idx = idx[np.argsort(d)[:max_n]]
        return self._keys[idx].astype(np.int32)

    def rows_for(self, keys: np.ndarray):
        """(tsdf, weight, born) payload rows for the given keys (must be
        stored)."""
        rows = np.array([self._index[int(k)] for k in keys], dtype=np.int64)
        return self._tsdf[rows], self._weight[rows], self._born[rows]

    def take(self, keys: np.ndarray, accepted: np.ndarray) -> int:
        """Drop accepted keys (now on-device).  Returns #dropped."""
        dropped = 0
        for k, a in zip(keys, accepted):
            if not a:
                continue
            row = self._index.pop(int(k), None)
            if row is not None:
                self._keys[row] = EMPTY_KEY
                self._free.append(row)
                dropped += 1
        self.total_restored += dropped
        return dropped

    # --- checkpoint support -------------------------------------------------
    def state_arrays(self) -> dict:
        """Dense copies of the live contents (for checkpointing)."""
        n = self._n
        occ = np.nonzero(self._keys[:n] != EMPTY_KEY)[0]
        return {
            "keys": self._keys[occ].copy(),
            "tsdf": self._tsdf[occ].copy(),
            "weight": self._weight[occ].copy(),
            "born": self._born[occ].copy(),
        }

    @classmethod
    def from_arrays(
        cls, hcfg: HashConfig, keys: np.ndarray, tsdf: np.ndarray,
        weight: np.ndarray, born: np.ndarray | None = None,
        born_default: int = 0,
    ) -> "BlockStore":
        """Rebuild a store from checkpoint arrays.

        ``born`` may be absent in pre-r4 checkpoints.  Stamp 0 would be
        the PERMISSIVE direction for the born<=frame de-integration gate
        (every frame's de-integration would reach the row), so legacy
        rows must instead be stamped with the restore-time frame index
        (``born_default``, matching ``hash_ops.restore_blocks``'s
        born_rows=None fallback): the row becomes invisible to
        de-integration of any already-fused frame, which is safe — the
        ledger starts invalid after a load anyway and the next full
        rebuild discards the old store."""
        store = cls(hcfg, capacity=max(4096, len(keys)))
        if born is None:
            born = np.full(len(keys), int(born_default), np.int32)
        store.add(keys, tsdf, weight, born)
        store.total_evicted = 0
        return store
