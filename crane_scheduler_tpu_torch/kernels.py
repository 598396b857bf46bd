"""Build and launch the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` source compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes``. The build runs at first use
into ``_build/`` (listed in ``.gitignore``), keyed on a hash of the source
and the flags, so a fresh checkout builds everything from its own sources.
``build_all`` starts one ``nvcc`` per source, all at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``CudaKernel.launch`` raises when that is not 0
and counts the launch otherwise. Nothing here falls back to another path:
a missing compiler, a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contraction anywhere (the scorer's rounding
# is Go's, step by step); the sources also spell every float op as an
# explicitly rounded intrinsic.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "built from csrc/ at first use and need the CUDA toolkit"
    )


class CudaKernel:
    """One CUDA source and its C entry point.

    ``launches`` counts successful launches; callers that need to know
    whether a path went through the kernel reset it and read it back.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""  # nvcc/ptxas output of the build this process ran
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def start_build(self):
        """Start ``nvcc`` for this source unless its library exists.
        Returns ``(process, tmp_path)`` or None; ``finish_build`` waits."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} "
                f"(exit {proc.returncode}):\n{log}"
            )
        os.replace(tmp, self.library_path())

    def _function(self):
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib, self._fn = lib, fn
            return self._fn

    def function(self, symbol: str, argtypes: list, restype=ctypes.c_int):
        """Another C entry point of this kernel's library (a query the
        wrapper makes before it launches); builds the library if needed."""
        self._function()
        fn = getattr(self._lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise on a nonzero CUDA error code."""
        err = self._function()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: kernel launch failed with CUDA error {err}"
            )
        with self._lock:  # the serving front end launches from many threads
            self.launches += 1


def build_all(kernels) -> None:
    """Build every kernel's library in parallel (one ``nvcc`` each,
    started together), then load them."""
    started = [(k, k.start_build()) for k in kernels]
    errors = []
    for k, s in started:  # wait for every nvcc, even after a failure
        try:
            k.finish_build(s)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for k in kernels:
        k._function()
