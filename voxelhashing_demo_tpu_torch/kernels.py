"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each kernel file has a plain C interface.  It is compiled with nvcc into a
shared library at first use, into ``_build/`` beside this file (listed in
.gitignore), and loaded with ctypes.  The library's file name carries a
hash of its source and flags, so an edited source is rebuilt.  Nothing is
built or loaded when this module is imported.  ``build_all`` compiles
every source at once, one nvcc process each.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path.  Raises with nvcc's output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
# source name (= its exported C function, returning int) -> argument types
_GATHER_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
KERNELS = {
    "window_gather": _GATHER_ARGS,
    "window_gather_streamed": _GATHER_ARGS,
}


def build_all() -> dict[str, Path]:
    """Compile every kernel source that is not built yet, all nvcc
    processes started together; returns {name: library path}."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first call)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, name)
        fn.argtypes = KERNELS[name]
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
