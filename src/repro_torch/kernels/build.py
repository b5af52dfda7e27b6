"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout, and bound with ``ctypes``.
The library's file name carries a hash of the source, the flags and the
library's own macros, so an edited source builds anew and a stale build is
never loaded.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Callable
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


class CudaLibrary:
    """One kernel source, its shared library, and its ``ctypes`` binding.

    ``bind`` sets the argument and result types of the library's functions;
    ``defines`` are the ``-D`` flags the source is compiled with.
    ``build_seconds`` and ``build_log`` hold this process's build (0 and ""
    when the library was already built)."""

    def __init__(self, source: str, stem: str,
                 bind: Callable[[ctypes.CDLL], None],
                 defines: tuple[str, ...] = ()):
        self.source = CSRC / source
        self.stem = stem
        self.bind = bind
        self.defines = defines
        self.lib: ctypes.CDLL | None = None
        self.build_seconds = 0.0
        self.build_log = ""

    def so_path(self) -> Path:
        flags = " ".join((*NVCC_FLAGS, *self.defines))
        tag = hashlib.sha256(self.source.read_bytes()
                             + flags.encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.stem}-{tag}.so"

    def _start(self) -> tuple[subprocess.Popen, Path, float] | None:
        """Start ``nvcc`` unless the library is built or loaded."""
        so = self.so_path()
        if self.lib is not None or so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, *self.defines, "-o",
                                 str(tmp), str(self.source)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish(self, started) -> None:
        if started is None:
            return
        proc, tmp, t0 = started
        self.build_log = proc.communicate()[0]
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source.name}:\n"
                               f"{self.build_log}")
        os.replace(tmp, self.so_path())

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, once per process."""
        if self.lib is None:
            self._finish(self._start())
            lib = ctypes.CDLL(str(self.so_path()))
            self.bind(lib)
            self.lib = lib
        return self.lib


def build_all(libraries: list[CudaLibrary]) -> None:
    """Build every library that is not built yet, one ``nvcc`` each, all
    started together; then load them all.  Waits for every build before
    raising the first failure, so no compiler is left running."""
    started = []
    try:
        for lib in libraries:
            started.append(lib._start())
    except Exception:
        for s in started:
            if s is not None:
                s[0].kill()
                s[0].wait()
        raise
    errors = []
    for lib, s in zip(libraries, started):
        try:
            lib._finish(s)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for lib in libraries:
        lib.load()
