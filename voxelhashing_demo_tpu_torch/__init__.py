"""PyTorch port of the dense SLAM engine, for one NVIDIA H100.

Mirrors the layout of the JAX package ``voxelhashing_demo_tpu`` (the
reference, unchanged): ``geometry/``, ``ops/``, ``models/``, ``utils/``,
``parallel/`` (one rank per mesh position over ``torch.distributed``),
``cli.py`` (``python -m voxelhashing_demo_tpu_torch``), with the JAX
function names.  Importing this package does nothing global; the CUDA
kernels and the host PNG codec under ``csrc/`` are built at first use
(``kernels.py``).  The JAX package's ``release_compiled`` and its
persistent compile cache served XLA's compiled executables and have no
counterpart here: PyTorch runs eagerly and keeps no compiled programs.
"""

from . import config
from .config import PipelineConfig, tiny_config

__version__ = "0.1.0"
