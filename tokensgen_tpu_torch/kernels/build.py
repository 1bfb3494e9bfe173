"""nvcc at first use: compiles one CUDA C++ source of ``csrc/`` for sm_90a into
a shared library with a plain C interface, caches it by the hash of the
source, the headers it includes from ``csrc/`` and the flags under
``<repo>/build/kernels`` (which .gitignore lists), and loads it with ctypes.
Shared by the attention kernels (`attention.py`) and the probes
(`probes.py`); nothing here imports or builds at module import."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary:
    """One compiled source: its loaded handle and, once this process has
    compiled it, nvcc's output (registers, shared memory and spills per
    kernel, from -Xptxas -v)."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.bind = bind
        self.lib: Optional[ctypes.CDLL] = None
        self.build_log = ""
        # threads that reach a kernel's first use together build and load it once
        self._lock = threading.Lock()

    def _tag(self) -> str:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def build(self, force: bool = False) -> Path:
        """Compiles (cached by hash) and loads the library; returns its path.
        Raises with nvcc's output on failure."""
        with self._lock:
            out = BUILD_DIR / f"lib{self.source.stem}_{self._tag()}.so"
            if force or not out.exists():
                nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
                if not os.path.exists(nvcc):
                    raise RuntimeError(f"nvcc not found: {self.source.name} needs the CUDA toolkit")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, out)
                self.build_log = proc.stdout + proc.stderr
            if self.lib is None or force:
                lib = ctypes.CDLL(str(out))
                self.bind(lib)
                self.lib = lib
            return out

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self.build()
        return self.lib


def ptxas_report(build_log: str):
    """[(mangled kernel name, registers, spill bytes)] from -Xptxas -v output."""
    rows, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def bind(lib: ctypes.CDLL, name: str, *argtypes) -> None:
    """Declares C function ``name``'s arguments; every entry point returns
    a cudaError_t as int."""
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(x) -> ctypes.c_void_p:
    """PyTorch's current stream on ``x``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
