"""Depth image I/O: 16-bit grayscale PNG (TUM RGB-D format); port of
utils/io.py.

Two implementations behind one API:

- the native C++ codec (``csrc/depthio.cpp``, built at first use with the
  host C++ compiler by ``kernels.build_host`` into ``_build/``), including
  a multi-threaded batch decoder for dataset prefetch (utils/stream.py);
- a pure-Python codec (stdlib zlib + numpy), the tests' reference.

The native codec is the default.  When it is asked for (``native=None`` or
``True``) and cannot be built, the call raises with the compiler's output:
there is no quiet fallback.  The Python codec runs only with
``native=False``.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional, Sequence

import numpy as np

from .. import kernels

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

# png16_info / png16_decode return codes (csrc/depthio.cpp)
_DECODE_ERRORS = {
    -1: "not a PNG", -2: "truncated PNG: missing IHDR",
    -3: "grayscale PNG required", -4: "8/16-bit PNG required",
    -5: "interlaced PNG unsupported", -6: "truncated PNG: chunk past the end",
    -7: "truncated PNG: no image data", -8: "corrupt PNG data",
    -9: "truncated PNG: incomplete image data",
}


def _load_native() -> ctypes.CDLL:
    """The native codec, built and bound on the first call; raises if it
    cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(kernels.build_host("depthio")))
            lib.png16_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.png16_info.restype = ctypes.c_int
            lib.png16_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint16),
            ]
            lib.png16_decode.restype = ctypes.c_int
            lib.png16_encode.argtypes = [
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ]
            lib.png16_encode.restype = ctypes.c_long
            lib.png16_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
            ]
            lib.png16_decode_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


# --------------------------------------------------------------------------
# pure-Python codec (the tests' reference)
# --------------------------------------------------------------------------

def _py_decode(data: bytes) -> np.ndarray:
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG")
    pos = 8
    width = height = bit_depth = None
    idat = b""
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        ctype = data[pos + 4: pos + 8]
        chunk = data[pos + 8: pos + 8 + length]
        if ctype == b"IHDR":
            if len(chunk) < 13:
                raise ValueError("truncated PNG: short IHDR")
            width, height, bit_depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk[:13]
            )
            if color != 0:
                raise ValueError("grayscale PNG required")
            if bit_depth not in (8, 16):
                raise ValueError("8/16-bit PNG required")
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if width is None:
        raise ValueError("truncated PNG: missing IHDR")
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    bpp = bit_depth // 8
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError("truncated PNG: incomplete image data")
    out = np.zeros((height, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        row = np.frombuffer(
            raw[y * (stride + 1): (y + 1) * (stride + 1)], dtype=np.uint8
        )
        filt, row = row[0], row[1:].copy()
        if filt == 0:
            line = row
        elif filt == 2:
            line = row + prior
        else:
            line = row
            for x in range(stride):
                av = int(line[x - bpp]) if x >= bpp else 0
                bv = int(prior[x])
                cv = int(prior[x - bpp]) if x >= bpp else 0
                if filt == 1:
                    line[x] = (int(row[x]) + av) & 0xFF
                elif filt == 3:
                    line[x] = (int(row[x]) + (av + bv) // 2) & 0xFF
                elif filt == 4:
                    p = av + bv - cv
                    pa, pb, pc = abs(p - av), abs(p - bv), abs(p - cv)
                    pred = av if pa <= pb and pa <= pc else (
                        bv if pb <= pc else cv
                    )
                    line[x] = (int(row[x]) + pred) & 0xFF
                else:
                    raise ValueError(f"bad filter {filt}")
        out[y] = line
        prior = out[y]
    if bit_depth == 16:
        img = out.reshape(height, width, 2)
        return (
            img[..., 0].astype(np.uint16) << 8 | img[..., 1].astype(np.uint16)
        )
    img8 = out.reshape(height, width).astype(np.uint16)
    return img8 << 8 | img8


def _py_encode(img: np.ndarray) -> bytes:
    img = np.ascontiguousarray(img, dtype=np.uint16)
    height, width = img.shape
    be = img.astype(">u2")
    raw = b"".join(b"\x00" + be[y].tobytes() for y in range(height))
    idat = zlib.compress(raw, 6)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        c = ctype + payload
        return struct.pack(">I", len(payload)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 16, 0, 0, 0, 0)
    return _PNG_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat) + chunk(
        b"IEND", b""
    )


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def _native_decode(data: bytes, where: str) -> np.ndarray:
    lib = _load_native()
    w, h, bd = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.png16_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(bd))
    if rc == 0:
        out = np.empty((h.value, w.value), dtype=np.uint16)
        rc = lib.png16_decode(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )
        if rc == 0:
            return out
    raise ValueError(f"{where}: {_DECODE_ERRORS.get(rc, 'PNG decode failed')}"
                     f" (native codec, {rc})")


def read_depth_png(path: str, native: Optional[bool] = None) -> np.ndarray:
    """Load a 16-bit grayscale PNG as a (H, W) uint16 array (8-bit files
    are widened as v << 8 | v)."""
    with open(path, "rb") as f:
        data = f.read()
    if native is False:
        return _py_decode(data)
    return _native_decode(data, path)


def write_depth_png(path: str, img: np.ndarray,
                    native: Optional[bool] = None) -> None:
    """Write a (H, W) uint16 array as a 16-bit grayscale PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint16)
    if native is False:
        data = _py_encode(img)
    else:
        lib = _load_native()
        h, w = img.shape
        cap = 1024 + 2 * img.nbytes
        out = np.empty(cap, dtype=np.uint8)
        n = lib.png16_encode(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), w, h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        )
        if n <= 0:
            raise ValueError(f"native PNG encode failed ({n})")
        data = out[:n].tobytes()
    with open(path, "wb") as f:
        f.write(data)


def read_depth_batch(
    paths: Sequence[str], width: int, height: int, num_threads: int = 0
) -> np.ndarray:
    """Decode many uniform-size depth PNGs concurrently with the native
    codec's threads -> (N, H, W) uint16.  The dataset-streaming fast path.
    A file that does not decode, or whose size is not ``width`` x
    ``height``, raises (naming the first such file)."""
    lib = _load_native()
    out = np.empty((len(paths), height, width), dtype=np.uint16)
    if not paths:
        return out
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.png16_decode_batch(
        arr, len(paths), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), num_threads,
    )
    if rc == 0:
        return out
    # name the failing file: decode one by one until one fails
    for p in paths:
        img = read_depth_png(p)
        if img.shape != (height, width):
            raise ValueError(
                f"{p}: depth image is {img.shape[1]}x{img.shape[0]}, "
                f"expected {width}x{height}"
            )
    raise ValueError(f"batch decode failed for {-rc} of {len(paths)} files")
