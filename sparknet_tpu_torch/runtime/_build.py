"""Build the port's native record reader with the host C++ compiler.

``csrc/runtime.cpp`` is one shared library with a plain C interface,
compiled with ``$CXX`` (default ``g++``) and the JAX package's native
flags (a portable ``-march=x86-64-v2`` baseline) into
``build/sparknet_tpu_torch/`` at the root of the checkout, beside the
CUDA kernels (``ops/_build.py``), at its first use.  The file name
carries a hash of the source, the compiler and the flags, so an edited
source is rebuilt at its next use.  A failed build or load raises with
the compiler's output: nothing falls back to the Python reader quietly.
Nothing is compiled when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from sparknet_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "csrc" / "runtime.cpp"
CXX_FLAGS = (
    "-O3", "-march=x86-64-v2", "-std=c++17", "-fPIC", "-Wall", "-pthread",
    "-shared",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(
            f"the host C++ compiler {cxx!r} was not found: the native record "
            "reader is built from sparknet_tpu_torch/runtime/csrc/runtime.cpp "
            "— install g++ or set CXX (DataPipeline(..., native=False) reads "
            "in Python)"
        )
    return found


def library_path() -> Path:
    """Where the library built from ``csrc/runtime.cpp`` lives (keyed by
    the source, the compiler's name and the flags)."""
    key = SRC.read_bytes() + " ".join(
        (os.environ.get("CXX", "g++"),) + CXX_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"libsparknet_runtime-{digest}.so"


def build() -> Path:
    """Compile the library unless it is there; raises with the
    compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native record reader failed:\n"
            f"{(proc.stdout + proc.stderr)[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: another process never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded library with its C entries typed, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.sn_last_error.restype = ctypes.c_char_p
        lib.snpipe_create.restype = ctypes.c_void_p
        lib.snpipe_create.argtypes = [
            ctypes.c_char_p,  # db_path
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B C H W
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # crop mirror train
            ctypes.c_float,  # scale
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,  # mean, its length
            ctypes.c_uint64,  # seed
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # prefetch workers u8
            ctypes.c_uint64,  # start
        ]
        lib.snpipe_next.restype = ctypes.c_int
        lib.snpipe_next.argtypes = [ctypes.c_void_p] * 6
        lib.snpipe_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib
