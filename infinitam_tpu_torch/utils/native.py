"""ctypes bindings for the port's native host runtime
(infinitam_tpu_torch/native/itpu_io.cpp).

Counterpart of infinitam_tpu/utils/native.py: image IO, a threaded dataset
prefetcher, STL export and raw block persistence in C++ (the reference's
FileUtils, ImageSourceEngine cache, ITMMesh::WriteSTL and
MemoryBlockPersister). The source is the port's copy of the JAX package's
native/itpu_io.cpp, whose prefetcher keeps its out-of-order frames per
prefetcher rather than per thread. The library is built on first use with
g++ from that source into `build/native/` at the repository root (listed
in .gitignore), named by a hash of the source and the flags, so an edited
source rebuilds; the JAX package's `native/` is never touched. When
it cannot be built, `get_lib` returns None and the callers return None or
False, as the JAX module does; this is host file IO, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "itpu_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False

U16P = ctypes.POINTER(ctypes.c_uint16)
U8P = ctypes.POINTER(ctypes.c_uint8)
IP = ctypes.POINTER(ctypes.c_int)
FP = ctypes.POINTER(ctypes.c_float)

# argtypes (and restype, where not int) of every bound symbol
SIGNATURES = {
    "itpu_read_pgm": ([ctypes.c_char_p, U16P, IP, IP], ctypes.c_int),
    "itpu_read_ppm": ([ctypes.c_char_p, U8P, IP, IP], ctypes.c_int),
    "itpu_write_pgm": ([ctypes.c_char_p, U16P, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "itpu_write_ppm": ([ctypes.c_char_p, U8P, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "itpu_write_stl": ([ctypes.c_char_p, FP, ctypes.c_int], ctypes.c_int),
    "itpu_prefetcher_create": ([ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                               ctypes.c_void_p),
    "itpu_prefetcher_get": ([ctypes.c_void_p, ctypes.c_size_t, U16P, U8P], ctypes.c_int),
    "itpu_prefetcher_destroy": ([ctypes.c_void_p], None),
    "itpu_save_block": ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64], ctypes.c_int),
    "itpu_load_block": ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64], ctypes.c_int64),
}


def library_path() -> Path:
    """Where the library of this source and these flags lands."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libitpu_io_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the source unless a library of the same hash exists; None
    when there is no source or no compiler, or the compile fails."""
    if not SOURCE.exists():
        return None
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic: parallel builders never load a partial file
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return _lib


def read_pgm_native(path: str, height: int, width: int) -> Optional[np.ndarray]:
    """A 16-bit PGM as uint16 [height, width]; None without the library or
    when the file's size differs."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.uint16)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.itpu_read_pgm(path.encode(), out.ctypes.data_as(U16P), ctypes.byref(w), ctypes.byref(h))
    if rc != 0 or w.value != width or h.value != height:
        return None
    return out


def write_stl_native(path: str, triangles: np.ndarray) -> bool:
    """Binary STL of triangles [T, 3, 3] float32; False without the library."""
    lib = get_lib()
    if lib is None:
        return False
    tris = np.ascontiguousarray(triangles, dtype=np.float32)
    return lib.itpu_write_stl(path.encode(), tris.ctypes.data_as(FP), len(tris)) == 0


class NativePrefetcher:
    """Threaded frame loader over explicit path lists."""

    def __init__(self, depth_paths, rgb_paths, height: int, width: int, n_threads: int = 2):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.height = height
        self.width = width
        self.has_rgb = rgb_paths is not None and len(rgb_paths) > 0
        dl = "\n".join(depth_paths).encode()
        rl = "\n".join(rgb_paths or []).encode()
        self._h = lib.itpu_prefetcher_create(dl, rl, width, height, n_threads)

    def get(self, index: int):
        """(depth uint16 [H, W], rgb uint8 [H, W, 3] or None) of frame
        `index`, or None when it cannot be read."""
        depth = np.empty((self.height, self.width), dtype=np.uint16)
        rgb = np.empty((self.height, self.width, 3), dtype=np.uint8) if self.has_rgb else None
        ok = self._lib.itpu_prefetcher_get(self._h, index, depth.ctypes.data_as(U16P),
                                           rgb.ctypes.data_as(U8P) if rgb is not None else None)
        if not ok:
            return None
        return depth, rgb

    def close(self):
        if self._h:
            self._lib.itpu_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
