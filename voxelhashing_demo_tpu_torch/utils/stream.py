"""Streaming frame pipeline: background decode + host-to-device prefetch
(port of utils/stream.py).

A producer thread decodes depth PNGs in batches through the native
multi-threaded codec (utils/io.py) and stages each frame on the device
ahead of consumption, keeping a bounded queue of staged frames for the
SLAM step.  On the card a frame goes through one of two pinned host
buffers: it is widened to int32 into the buffer, copied to a fresh device
tensor with ``copy_(non_blocking=True)`` on a side stream, and an event
recorded after the copy travels with the frame.  The consumer's stream
waits on that event, and ``record_stream`` marks the tensor as used there,
so the allocator does not hand its memory out while the consumer's work
may still read it.  A pinned buffer is rewritten only after its last copy
has completed (the producer waits on that copy's event).  Nothing blocks
the consumer but an empty queue; ``consumer_waits`` counts how often it
found no staged frame.  On the CPU a frame is a plain int32 tensor.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from . import io as depth_io

_SENTINEL = object()
_PINNED = 2          # staging buffers per pipeline


class FramePipeline:
    """Iterate device-ready depth frames from a list of PNG paths.

    Usage::

        pipe = FramePipeline(paths, width=640, height=480, prefetch=4)
        for depth in pipe:          # int32 (H, W) tensor on the device
            slam.process(depth)

    ``device=None`` means the CUDA card."""

    def __init__(
        self,
        paths: Sequence[str],
        width: int,
        height: int,
        prefetch: int = 4,
        decode_batch: int = 8,
        device=None,
    ):
        self.paths = list(paths)
        self.width = width
        self.height = height
        self.decode_batch = max(1, decode_batch)
        self.device = resolve(device)
        self.consumer_waits = 0
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._side = torch.cuda.Stream(self.device)
            self._pinned = [torch.empty((height, width), dtype=torch.int32,
                                        pin_memory=True)
                            for _ in range(_PINNED)]
            self._copied = [None] * _PINNED
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _stage(self, img: np.ndarray, n: int):
        """Frame ``n`` (uint16 (H, W)) on the device: (tensor, event after
        its copy) on the card, (tensor, None) on the CPU."""
        if not self._cuda:
            return torch.from_numpy(img.astype(np.int32)), None
        slot = n % _PINNED
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()   # the buffer's copy is done
        buf = self._pinned[slot]
        np.copyto(buf.numpy(), img, casting="safe")
        with torch.cuda.stream(self._side):
            dev = torch.empty((self.height, self.width), dtype=torch.int32,
                              device=self.device)
            dev.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        self._copied[slot] = done
        return dev, done

    def _put(self, item) -> bool:
        """Queue ``item``; polls the stop flag so an abandoned consumer
        does not leave this thread blocked on a full queue.  False when
        stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        n = 0
        try:
            for start in range(0, len(self.paths), self.decode_batch):
                if self._stop.is_set():
                    return
                chunk = self.paths[start: start + self.decode_batch]
                batch = depth_io.read_depth_batch(
                    chunk, self.width, self.height)
                for img in batch:
                    if not self._put(self._stage(img, n)):
                        return
                    n += 1
        except BaseException as e:  # surface in the consumer thread
            self._err = e
        finally:
            # deliver the sentinel unless the pipeline was closed (a
            # dropped sentinel would hang a live consumer forever)
            self._put(_SENTINEL)

    def close(self) -> None:
        """Stop the producer and release queued frames (safe to call on a
        partially consumed pipeline; iteration ends after this)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __del__(self):  # best-effort: don't leak a blocked producer
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()

    def __iter__(self) -> Iterator[torch.Tensor]:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                self.consumer_waits += 1
                item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            dev, done = item
            if done is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                dev.record_stream(cur)
            yield dev

    def __len__(self) -> int:
        return len(self.paths)


def stream_tum(root: str, width: int, height: int, max_frames=None,
               prefetch: int = 4, device=None):
    """(FramePipeline, ground-truth poses | None) for a TUM sequence dir."""
    from .tum import TUMSequence

    seq = TUMSequence(root, max_frames=max_frames)
    paths = [os.path.join(root, rel) for _, rel, _ in seq.entries]
    poses: Optional[List[np.ndarray]] = (
        [p for _, _, p in seq.entries] if seq.has_gt else None
    )
    return FramePipeline(paths, width, height, prefetch=prefetch,
                         device=device), poses
