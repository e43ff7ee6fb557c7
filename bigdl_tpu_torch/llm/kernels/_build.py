"""Build and load the port's CUDA C++ kernels.

Each ``bigdl_tpu_torch/csrc/<name>.cu`` is compiled by plain ``nvcc``
for ``sm_90a`` into its own shared library with a C interface and loaded
with ``ctypes``. The build runs at first use — never at import, so the
package imports where there is no ``nvcc`` — into
``bigdl_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash
of the source, the headers and the flags, so an edited source rebuilds
and an unchanged one loads in milliseconds. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into a ``RuntimeError``. ``ptxas``
runs verbose: each build's log (registers, stack and spills of every
kernel, and any warning) is kept beside its library (:func:`build_log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            p = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(p):
                return p
    p = shutil.which("nvcc")
    if p is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build on a machine with the toolkit")
    return p


def _headers() -> Iterable[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in [f"{name}.cu", *_headers()]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for one source unless its library is built; the
    output goes to a temporary name, renamed into place when done."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    proc.tmp, proc.out, proc.t0 = tmp, out, time.perf_counter()
    return proc


def _finish(name: str, proc: subprocess.Popen):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{log.decode()}")
    with open(f"{proc.out}.log", "wb") as f:
        f.write(log)
    os.replace(proc.tmp, proc.out)
    build_seconds[name] = time.perf_counter() - proc.t0


def build_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Build every named source in parallel (one ``nvcc`` each) and load
    them. Returns ``{name: CDLL}``."""
    names = list(names)
    with _lock:
        procs = {n: _start(n) for n in names if n not in _libs}
        try:
            for n, p in procs.items():
                if p is not None:
                    _finish(n, p)
        finally:
            for p in procs.values():
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
        for n in procs:
            _libs[n] = ctypes.CDLL(_lib_path(n))
        return {n: _libs[n] for n in names}


def build_log(name: str) -> str:
    """nvcc's output of the build of ``csrc/<name>.cu`` that is loaded
    (built in this process or earlier), or "" if it is not built."""
    path = f"{_lib_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


P = ctypes.c_void_p      # a pointer or the stream
I = ctypes.c_longlong    # an integer argument (``long long`` in C)
F = ctypes.c_float


def bind(name: str, fn: str, argtypes):
    """``ctypes`` function ``fn`` of library ``name``, with every
    argument declared (``P`` for pointers and the stream, so no pointer
    is cut to 32 bits; ``I`` for integers; ``F`` for floats) and an
    ``int`` return: the ``cudaGetLastError()`` after the launch."""
    f = _fns.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[(name, fn)] = f
    return f


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
