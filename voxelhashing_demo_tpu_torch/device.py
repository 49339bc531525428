"""The device the port's entry points use when the caller names none.

Every entry point that creates state or data (``HashSLAM``, ``DenseSLAM``,
the ``create`` functions, the synthetic sequence makers, ``convert``) takes
``device=None`` and resolves it here: the CUDA card.  There is no test for
a card and no quiet CPU fallback; without a card the first allocation
fails with torch's own error, and a caller who wants the CPU says
``device="cpu"``.  Functions that take tensors follow their inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    """The CUDA card (whether or not one is present)."""
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def host_array(t: torch.Tensor) -> np.ndarray:
    """The tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()
