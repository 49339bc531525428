"""Build and bind the native code under ``csrc/``.

Each source has a plain C interface.  It is compiled into a shared library
at first use, into ``_build/`` beside this file (listed in .gitignore), and
loaded with ctypes: the hand-written CUDA kernels (``*.cu``) with nvcc by
``build``, the host C++ PNG codec (``depthio.cpp``, utils/io.py) with the
host C++ compiler by ``build_host``.  A library's file name carries a hash
of its source and flags, so an edited source is rebuilt.  Nothing is built
or loaded when this module is imported.  ``build_all`` compiles every
source at once, one compiler process each.  ``function`` hands a wrapper
its kernel's C function, bound once; ``launch`` calls it on the current
stream and raises on a refused launch.
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
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")
HOST_LIBS = ("-lz",)
HOST_SOURCES = ("depthio",)      # csrc/<name>.cpp

_FUNCTIONS: dict = {}       # C function name -> the bound function


def nvcc() -> str:
    """Path of the CUDA compiler, or raise."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def host_compiler() -> str:
    """Path of the host C++ compiler, or raise."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ / g++) found")


def _library(src: Path, flags) -> Path:
    """Content-hashed library name of ``src`` built with ``flags``."""
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    return _library(SRC_DIR / f"{name}.cu", NVCC_FLAGS)


def host_library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cpp`` lives."""
    return _library(SRC_DIR / f"{name}.cpp", HOST_FLAGS + HOST_LIBS)


def _compile(out: Path, src: Path, cmd_for) -> Path:
    """Build ``out`` from ``src`` unless it exists: ``cmd_for(tmp)`` is the
    compiler command writing a temporary file, moved to ``out`` when it
    succeeds.  Raises with the compiler's output on failure."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = cmd_for(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed "
                               f"({proc.returncode}) for {src.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc unless its library is already
    built; returns the library path."""
    src = SRC_DIR / f"{name}.cu"
    return _compile(library_path(name), src,
                    lambda tmp: [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)])


def ptxas_report(name: str) -> dict:
    """What ptxas says of each kernel of ``csrc/<name>.cu`` when it is
    built as ``build`` builds it, plus ``-Xptxas -v`` (into a temporary
    file): {mangled kernel name: {"registers", "spill_stores",
    "spill_loads", "stack", "smem"}} (bytes but the registers)."""
    import re

    src = SRC_DIR / f"{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "report.so"), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed for {src.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    out, fn = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None:
            fn.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                      spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            fn["smem"] = int(s.group(1)) if s else 0
    return {k: v for k, v in out.items() if "registers" in v}


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` with the host C++ compiler unless its
    library is already built; returns the library path."""
    src = SRC_DIR / f"{name}.cpp"
    return _compile(host_library_path(name), src,
                    lambda tmp: [host_compiler(), *HOST_FLAGS, "-o", tmp,
                                 str(src), *HOST_LIBS])


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float
# exported C function (returning int; its source is csrc/<name>.cu unless
# SOURCES says otherwise) -> argument types (the stream is always last)
_GATHER_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
KERNELS = {
    "window_gather": _GATHER_ARGS,
    "window_gather_streamed": _GATHER_ARGS,
    # img, idx, col, out, image elements, outputs, cols
    "take_flat": [_P, _P, _P, _P, _L, _L, _I, _P],
    # src, idx, out, rows, cols, src rows, src cols, src row stride, axis
    "take_along": [_P, _P, _P, _I, _I, _I, _I, _L, _I, _P],
    # img, v0, u0, dv, du, out, H, W, blocks, rows a block, window, keep
    "window_gather_two_step": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _P],
    # depth, flatw, tsdf, weight, tsdf out, weight out, image elements,
    # voxels, trunc
    "integrate_chunk": [_P, _P, _P, _P, _P, _P, _L, _L, _F, _P],
    # an empty kernel (no arguments but the stream): the launch floor
    "launch_floor": [_P],
    # empty cooperative kernel (csrc/launch_floor.cu): CTAs, grid barriers
    "grid_sync_floor": [_I, _I, _P],
    # ICP (csrc/icp.cu): candidate table, candidates, race, pixels, W, H,
    # fx, fy, cx, cy, 1/fx, 1/fy, normal and distance gates, Huber delta,
    # damping, tol2, max_iters, CTAs a candidate, partials, score partials,
    # flags, out rows, iterations
    "icp_gn_level": [_P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                     _F, _F, _F, _I, _I, _P, _P, _P, _P, _P, _P],
    # candidate table, score mode, pixels, W, H, fx, fy, cx, cy, 1/fx,
    # 1/fy, normal and distance gates, Huber delta, CTAs, partials, out
    "icp_sums": [_P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _I,
                 _P, _P, _P],
    # K3a (csrc/preprocess.cu): raw, the output buffer, H, W, the host
    # tables of ints (outlier, min support, bilateral, radius) and floats
    # (1/depth_scale, depth_min, depth_max, cx, cy, 1/fx, 1/fy, band base,
    # band quad, 1/(2 sigma_depth^2), the spatial weights)
    "preprocess_frame": [_P, _P, _I, _I, _P, _P, _P],
    # K3b: the source depth, the target depth, the target Frame's depth
    # and normals, the output buffer, the host tables of ints (8 a job)
    # and floats (6 a job), jobs, edge band
    "pyramid_levels": [_P, _P, _P, _P, _P, _P, _P, _I, _F, _P],
    # K8 (csrc/splat.cu): z-buffer, blocks, ptrs, count, T_wc, rows, band
    # filter, the host tables of the map's row pointers (tsdf, weight,
    # band_min), ints (map rows, block size, H, W) and floats (voxel size,
    # fx, fy, cx, cy, near, far, band)
    "splat_zbuffer": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # K9: raw depth, the output buffer (depth, points, normals), hit, H,
    # W, fill rounds, the host table of floats (smooth sigma, cx, cy, 1/fx,
    # 1/fy)
    "splat_finalize": [_P, _P, _P, _I, _I, _I, _P, _P],
    # K9's instantiation for a fill-round count: registers, spilled bytes,
    # resident CTAs, threads and shared bytes into an int[5] (no stream)
    "splat_finalize_info": [_I, _P],
    # K6 (csrc/fuse.cu): keys, ptrs, T_wc, the output buffer (blocks,
    # ptrs, count), the persistent scratch and its status words, table size,
    # the host tables of ints (max_active, key bits, block size) and floats
    # (voxel size, half a block, fx, fy, cx, cy, width, height, margin,
    # radius * fx, radius * fy, near, far)
    "compact_visible": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    # K7: blocks, ptrs, count, the host table of the map's row pointers
    # (tsdf, weight, band_min, born, last_seen), depth, T_wc, the stamp on
    # the device (or None), rows, sign, born gate, max_born, stamp on,
    # stamp, the host tables of ints (map rows, block size, H, W, window h
    # and w, window, falloff) and floats (voxel size, fx, fy, cx, cy,
    # truncation, its depth scale, weight_sample, weight_sample * 1.5,
    # depth_min, 1 / (depth_max - depth_min), max_weight, the inverse
    # update's clamp)
    "integrate_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P],
    # K7's instantiation for a block size: registers, spilled bytes,
    # resident CTAs, threads and shared bytes into an int[5] (no stream)
    "integrate_rows_info": [_I, _P],
    # K5a (csrc/alloc.cu): vertices, depth, T_wc, keys out, H, W, the host
    # tables of ints (stride, band steps, key bits, block size) and floats
    # (truncation, its depth scale, recip(voxel size), linspace's step)
    "alloc_candidates": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    # K5b: candidate keys, their count, n_alloc out, the stamp on the
    # device (or None), the stamp, the persistent scratch, its capacity
    # and set bits, the host tables of the map's pointers (HashMap order)
    # and ints (buckets, slots a bucket, map rows, voxels a row, key bits,
    # the hash's buckets and divisor, max_new)
    "insert_blocks": [_P, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P],
}
# C function -> its source under csrc/, where the two names differ
SOURCES = {"icp_gn_level": "icp", "icp_sums": "icp",
           "grid_sync_floor": "launch_floor",
           "preprocess_frame": "preprocess", "pyramid_levels": "preprocess",
           "splat_zbuffer": "splat", "splat_finalize": "splat",
           "splat_finalize_info": "splat",
           "compact_visible": "fuse", "integrate_rows": "fuse",
           "integrate_rows_info": "fuse",
           "alloc_candidates": "alloc", "insert_blocks": "alloc"}


def source_of(name: str) -> str:
    """The csrc/<source>.cu that exports C function ``name``."""
    return SOURCES.get(name, name)


def build_all() -> dict[str, Path]:
    """Compile every source that is not built yet (the CUDA kernels and
    the host codec), all compiler processes started together; returns
    {name: library path}."""
    cuda = sorted({source_of(n) for n in KERNELS})
    jobs = [(build, n) for n in cuda] + [(build_host, n)
                                         for n in HOST_SOURCES]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(fn, n) for fn, n in jobs]
        return {n: f.result() for (_, n), f in zip(jobs, futures)}


def function(name: str):
    """The C function ``name`` of its source (``source_of``), argument
    types set: built, loaded and bound on the first call, the same object
    afterwards (it keeps its library alive)."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build(source_of(name)))), name)
        fn.argtypes = KERNELS[name]
        fn.restype = ctypes.c_int
        _FUNCTIONS[name] = fn
    return fn


def launch(name: str, device_index: int, *args) -> None:
    """Call kernel ``name`` with ``args`` on the current stream of CUDA
    device ``device_index`` (``tensor.get_device()``); raise if the launch
    is refused."""
    import torch

    # the current stream's handle without building a Stream object (the
    # object costs as much host time as the launch itself)
    stream = torch._C._cuda_getCurrentRawStream(device_index)
    err = function(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
