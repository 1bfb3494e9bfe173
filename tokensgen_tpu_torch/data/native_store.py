"""The native latent-store reader (port of `tokensgen_tpu/data/native_store.py`):
whole-file reads of many ``.npy`` files at once on a C++ thread pool
(``csrc/latent_store.cpp``), bound through ctypes, and a zero-copy ``.npy``
view of each buffer. `VAEMiraDataset` reads its latent files through it.

The library is built with ``g++`` at first use into the git-ignored build
directory of the CUDA kernels (``build/kernels``), cached by the hash of the
source and the flags. A failed build raises with the compiler's output; there
is no pure-Python fallback. `load_npy_plain` (``np.load``) is the reference
the tests hold the reader to.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from tokensgen_tpu_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "latent_store.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
ABI_VERSION = 1


class _Native:
    """The built and loaded library: one per process."""

    lib: Optional[ctypes.CDLL] = None
    path: Optional[Path] = None
    built_here = False  # whether this process ran the compiler
    _lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblatent_store_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compiles (cached by hash) and loads the library; returns its path.
    Raises RuntimeError with the compiler's output when it fails."""
    with _Native._lock:
        out = library_path()
        if force or not out.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError(f"no C++ compiler (g++) to build {SOURCE.name}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {SOURCE.name} ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
            _Native.built_here = True
        if _Native.lib is None or force:
            lib = ctypes.CDLL(str(out))
            lib.ls_file_size.argtypes = [ctypes.c_char_p]
            lib.ls_file_size.restype = ctypes.c_int64
            lib.ls_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
            lib.ls_read_batch.restype = ctypes.c_int
            lib.ls_version.argtypes = []
            lib.ls_version.restype = ctypes.c_int
            if lib.ls_version() != ABI_VERSION:
                raise RuntimeError(f"{out}: ABI version {lib.ls_version()}, want {ABI_VERSION}")
            _Native.lib, _Native.path = lib, out
        return out


def native_library() -> ctypes.CDLL:
    if _Native.lib is None:
        build()
    return _Native.lib


def read_files_batch(paths: List[str], n_threads: int = 8) -> List[np.ndarray]:
    """Each file of ``paths`` whole, as a uint8 array, read in parallel."""
    lib = native_library()
    n = len(paths)
    if n == 0:
        return []
    encoded = [os.fsencode(p) for p in paths]
    sizes = [lib.ls_file_size(p) for p in encoded]
    missing = [p for p, s in zip(paths, sizes) if s < 0]
    if missing:
        raise FileNotFoundError(missing[0])
    bufs = [np.empty(s, np.uint8) for s in sizes]
    c_paths = (ctypes.c_char_p * n)(*encoded)
    c_dests = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for b in bufs])
    c_sizes = (ctypes.c_int64 * n)(*sizes)
    failures = lib.ls_read_batch(c_paths, n, c_dests, c_sizes, n_threads)
    if failures:
        raise IOError(f"{failures} of {n} reads failed (first file {paths[0]})")
    return bufs


_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}


def npy_view(buf: np.ndarray) -> np.ndarray:
    """The array a ``.npy`` file's bytes hold, viewing ``buf`` (no copy)."""
    head = io.BytesIO(memoryview(buf)[:65546].tobytes())  # magic, version, length, header
    version = np.lib.format.read_magic(head)
    if version not in _HEADER_READERS:
        raise ValueError(f".npy format version {version} is not read here")
    shape, fortran, dtype = _HEADER_READERS[version](head)
    arr = np.frombuffer(buf.data, dtype=dtype, count=int(np.prod(shape)), offset=head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def load_npy_batch(paths: List[str], n_threads: int = 8) -> List[np.ndarray]:
    """``.npy`` files read in parallel by the native reader (views of its
    buffers)."""
    return [npy_view(buf) for buf in read_files_batch(paths, n_threads)]


def load_npy_plain(paths: List[str]) -> List[np.ndarray]:
    """The same files through ``np.load``: the reference of the tests."""
    return [np.load(p) for p in paths]
