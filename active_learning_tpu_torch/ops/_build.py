"""Build the port's native sources and load them with ctypes.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``.  No PyTorch header is included, so a build takes
seconds, not minutes.  A ``csrc/<name>.cpp`` (the CPU route's JPEG
decoder) is built the same way by ``g++``; ``sources()`` and the default
``build_all`` take the ``.cu`` files only.

The library lands in ``active_learning_tpu_torch/build/`` (gitignored)
under a name that carries the hash of its source and flags: a changed
source builds anew, an unchanged one is loaded as it is.  Builds happen
at first use; ``build_all`` builds every source at once, one ``nvcc``
process each, all started together.  Without ``nvcc``, or when a build
fails, this raises with the compiler's output: a CUDA tensor never falls
back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
# Libraries a source links beyond the CUDA runtime (the toolkit's) or,
# for a .cpp, beyond the C++ runtime.
LINK_FLAGS = {"jpeg_decode": ("-lnvjpeg",), "decode": ("-ljpeg", "-lpthread")}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# The compiler's output per source (for nvcc, ptxas -v: registers,
# shared memory, spills).
build_logs: Dict[str, str] = {}


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            f"{CSRC_DIR} at first use and need the CUDA toolkit")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(f"g++ not found: the .cpp sources of {CSRC_DIR} "
                           "are built at first use")
    return path


def _source(name: str) -> str:
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR, f"{name}.cpp")


def _compiler(name: str) -> Tuple[str, tuple]:
    """``("g++" or "nvcc", flags)`` for the source of ``name``."""
    if _source(name).endswith(".cpp"):
        return "g++", GXX_FLAGS
    return "nvcc", NVCC_FLAGS


def library_path(name: str) -> str:
    with open(_source(name), "rb") as fh:
        digest = hashlib.sha256(fh.read())
    digest.update(" ".join(_compiler(name)[1]
                           + LINK_FLAGS.get(name, ())).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named source (default: every ``.cu`` of ``csrc/``)
    whose library is missing, all compiler processes at once.  Returns
    the seconds each build took (0.0 for one already built)."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: library_path(n) for n in names
            if not os.path.exists(library_path(n))}
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        # A process-unique name, then an atomic rename: a concurrent
        # first user never loads a half-written library.
        tmp = f"{out}.{os.getpid()}.tmp"
        compiler, flags = _compiler(name)
        cmd = [_gxx() if compiler == "g++" else _nvcc(), *flags, "-o", tmp,
               _source(name), *LINK_FLAGS.get(name, ())]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(_source(name))} "
                          f"({_compiler(name)[0]} exit {proc.returncode}):"
                          f"\n{log}")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built
    first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
