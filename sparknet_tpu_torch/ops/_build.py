"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), compiled for ``sm_90a``
into ``build/sparknet_tpu_torch/`` at the root of the checkout, which
``.gitignore`` lists.  A library's file name carries a hash of its
source, the ``csrc`` files it includes (headers, and a ``.cu`` that
another includes, as ``lrn_pool_bf16.cu`` does) and the compiler flags,
so an edited kernel is rebuilt at its next use and an unchanged one is
loaded as it is.  The first use builds
every stale source at once, one ``nvcc`` each, all started together;
each build's compiler output (``-Xptxas -v``: registers, shared memory,
spills) is kept beside the library as ``<name>-<hash>.log``.

``kernel(name, symbol, argtypes)`` is a typed C entry of a library (each
returns the launch's ``cudaError_t``), ``raise_on`` turns that code into
an exception.  Nothing is compiled when the module is imported: the CPU
tests import it on machines that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path
from typing import Dict, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sparknet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(SRC_DIR.glob("*.cu"))}


def includes(src: Path) -> List[Path]:
    """The ``csrc`` files ``src`` includes (``#include "..."``), directly
    or through one another."""
    found, todo = set(), [src]
    while todo:
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', todo.pop().read_text(),
                              re.M):
            p = SRC_DIR / inc
            if p not in found:
                found.add(p)
                todo.append(p)
    return sorted(found)


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (keyed by
    the source, the ``csrc`` files it includes and the flags)."""
    src = sources()[name]
    headers = b"".join(p.read_bytes() for p in includes(src))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "sparknet_tpu_torch/ops/csrc with the CUDA toolkit's nvcc — put "
        "it on PATH or set CUDA_HOME"
    )


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing (in parallel) and
    return kernel name -> library path.  Raises with the compiler's
    output if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {name: library_path(name) for name in sources()}
        stale = [n for n, p in paths.items() if not p.exists()]
        if not stale:
            return paths
        nvcc = _nvcc()
        jobs = []
        for name in stale:
            out = paths[name]
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])],
                stdout=log, stderr=subprocess.STDOUT,
            )
            jobs.append((name, proc, log, tmp, out))
        failed = []
        for name, proc, log, tmp, out in jobs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out)  # atomic: a reader never sees half a file
            else:
                failed.append((name, out.with_suffix(".log").read_text()))
        if failed:
            raise RuntimeError(
                "nvcc failed:\n" + "\n".join(
                    f"--- {name} ---\n{text[-4000:]}" for name, text in failed
                )
            )
        return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


@lru_cache(maxsize=None)
def kernel(name: str, symbol: str, argtypes: tuple):
    """The C entry ``symbol`` of ``csrc/<name>.cu``, typed; it returns the
    launch's ``cudaError_t``."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def raise_on(rc: int, what: str) -> None:
    """Raise when a kernel entry returned a CUDA error (a refused launch
    never runs, and no later synchronise reports it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError {rc})")
