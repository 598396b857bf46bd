"""Build and load the host library (``csrc/crane_native.cpp``,
``csrc/crane_pylist.cpp``).

Counterpart of ``crane_scheduler_tpu/native/lib.py``. The sources are the
port's own copies of the JAX package's ``native/`` library; they compile at
first use with the host C++ compiler (``$CXX``, else ``g++``, else ``c++``)
and the reference Makefile's flags into ``_build/`` (listed in
``.gitignore``). Each output is keyed on a sha256 of its sources, the
compiler's command and its ``--version`` output, and the flags (and, for
the CPython-API decoder, the Python include path and version), so a fresh
checkout builds from its own sources, and a changed source, flag or
compiler builds anew. A build writes a per-process
temporary file and renames it into place, so concurrent processes may race
for the first build.

- ``libcrane_native`` (binding heap, annotation codec, HTTP flush engines,
  the columnar LIST scanner) loads with ``ctypes.CDLL``: its calls release
  the GIL.
- ``libcrane_pylist`` (the LIST and watch decoders that build the mirror's
  Python objects) loads with ``ctypes.PyDLL``: its calls hold the GIL. It
  needs this interpreter's ``Python.h`` (``python_headers_present``).

Both load with ctypes' default ``RTLD_LOCAL``, so they live beside the JAX
package's libraries of the same symbol names in one process. Nothing here
falls back: a missing compiler, a failed build or a failed load raises
``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# the reference Makefile's CXXFLAGS plus -shared, verbatim
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
_BUILD_TIMEOUT_SECONDS = 300

# one lock per library, so the two can build at once on two threads
_locks = {"crane_native": threading.Lock(), "crane_pylist": threading.Lock()}
_loaded: dict[str, object] = {}  # name -> configured library, or the RuntimeError
build_seconds: dict[str, float] = {}  # builds this process ran, by library


def compiler_command() -> list[str]:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++`` on PATH."""
    cxx = os.environ.get("CXX")
    if cxx:
        return shlex.split(cxx)
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return [found]
    raise RuntimeError(
        "no host C++ compiler ($CXX, g++ or c++): the host library is "
        "built from crane_scheduler_tpu_torch/csrc at first use"
    )


@functools.cache
def compiler_version(cxx: tuple[str, ...]) -> str:
    """``<cxx> --version`` as printed (empty when it does not run: the
    build then reports the compiler's error)."""
    try:
        proc = subprocess.run([*cxx, "--version"], capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_SECONDS)
    except (OSError, subprocess.SubprocessError):
        return ""
    return proc.stdout if proc.returncode == 0 else ""


def python_include() -> str:
    return sysconfig.get_paths()["include"]


@functools.cache
def python_headers_present() -> bool:
    """Whether this interpreter's ``Python.h`` exists, which the object
    decoder (``libcrane_pylist``) is built against."""
    return os.path.isfile(os.path.join(python_include(), "Python.h"))


def _library_path(name: str, sources, extra) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    cxx = compiler_command()
    h.update(" ".join(cxx + list(CXXFLAGS) + list(extra)).encode())
    h.update(compiler_version(tuple(cxx)).encode())
    if name == "crane_pylist":
        h.update(sys.version.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, source: str, extra=()) -> Path:
    """Compile ``csrc/<source>`` unless its keyed library exists; returns
    the library's path."""
    sources = [CSRC / source, CSRC / "listscan.h"]
    out = _library_path(name, sources, extra)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [*compiler_command(), *CXXFLAGS, *extra, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_SECONDS)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {source} failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    lib.crane_bindings_new.argtypes = [i64, i64]
    lib.crane_bindings_new.restype = ctypes.c_void_p
    lib.crane_bindings_free.argtypes = [ctypes.c_void_p]
    lib.crane_bindings_len.argtypes = [ctypes.c_void_p]
    lib.crane_bindings_len.restype = i64
    lib.crane_bindings_add.argtypes = [ctypes.c_void_p, i32, i64]
    lib.crane_bindings_add_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), p_i64, i64,
    ]
    lib.crane_bindings_count.argtypes = [ctypes.c_void_p, i32, i64, i64]
    lib.crane_bindings_count.restype = i64
    lib.crane_bindings_counts_batch.argtypes = [
        ctypes.c_void_p, i64, p_i64, i64, i64, p_i64,
    ]
    lib.crane_bindings_gc.argtypes = [ctypes.c_void_p, i64]
    lib.crane_parse_annotations.argtypes = [
        ctypes.c_char_p, p_i64, i64, i64, p_f64, p_f64,
    ]
    lib.crane_parse_values.argtypes = [
        ctypes.c_char_p, p_i64, i64, p_f64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.crane_render_f5.argtypes = [p_f64, i64, ctypes.c_char_p, p_i64]
    lib.crane_http_flush.argtypes = [
        ctypes.c_char_p, i32, ctypes.c_char_p, p_i64, i64, i32, i32, i32,
        ctypes.POINTER(i32),
    ]
    lib.crane_http_flush.restype = i64
    lib.crane_http_flush_pipelined.argtypes = [
        ctypes.c_char_p, i32, ctypes.c_char_p, p_i64, i64, i32, i32,
        i32, i32, ctypes.POINTER(i32), p_i64,
    ]
    lib.crane_http_flush_pipelined.restype = i64
    lib.crane_list_decode.argtypes = [
        ctypes.c_char_p, i64, i32,
        ctypes.c_char_p, i64, p_i64, p_i64, i64,
        p_i64, p_i64, ctypes.POINTER(ctypes.c_uint8), p_i64, i64,
        p_i64,
    ]
    lib.crane_list_decode.restype = i64
    return lib


def _configure_pylist(lib: ctypes.PyDLL) -> ctypes.PyDLL:
    pyo = ctypes.py_object
    sig = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, pyo, pyo, pyo, pyo]
    lib.crane_pylist_decode.argtypes = sig + [pyo]  # + known_rvs
    lib.crane_pylist_decode.restype = pyo
    lib.crane_pylist_decode_watch.argtypes = sig
    lib.crane_pylist_decode_watch.restype = pyo
    return lib


def _load(name: str, make):
    with _locks[name]:
        got = _loaded.get(name)
        if got is None:
            try:
                got = make()
            except (OSError, AttributeError) as e:
                got = RuntimeError(f"loading lib{name} failed: {e}")
            except RuntimeError as e:
                got = e
            _loaded[name] = got
    if isinstance(got, RuntimeError):
        raise got
    return got


def load_native() -> ctypes.CDLL:
    """The configured ``libcrane_native`` (built at first use)."""
    return _load("crane_native", lambda: _configure(
        ctypes.CDLL(str(_build("crane_native", "crane_native.cpp")))))


def load_pylist() -> ctypes.PyDLL:
    """The CPython-API decoder ``libcrane_pylist`` (built at first use
    against this interpreter's headers)."""
    return _load("crane_pylist", lambda: _configure_pylist(
        ctypes.PyDLL(str(_build("crane_pylist", "crane_pylist.cpp",
                                ("-I" + python_include(),))))))


def library_paths() -> dict[str, str]:
    """The paths of the libraries this process loaded, by name."""
    return {name: lib._name for name, lib in list(_loaded.items())
            if not isinstance(lib, RuntimeError)}
