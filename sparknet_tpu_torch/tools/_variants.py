"""Build variants of a kernel source for the tile-sweep tools.

Each variant is a copy of a ``csrc/*.cu`` source with some constants
replaced, compiled with the port's nvcc flags (and the ``csrc`` include
path, for the shared headers), all variants at once, each into its own
shared library under ``out_dir``.  The ptxas lines (registers, spills)
of every variant are printed.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path
from typing import Dict, Sequence

from sparknet_tpu_torch.ops import _build


def substitute(src: str, pattern: str, replacement: str) -> str:
    """``re.sub`` that must match: a variant whose constant is not found
    would silently time the source's own shape."""
    out, n = re.subn(pattern, replacement, src)
    if n == 0:
        raise ValueError(f"variant pattern {pattern!r} matches nothing")
    return out


def build(out_dir: Path, sources: Sequence[str], labels: Sequence[str]
          ) -> Dict[int, ctypes.CDLL]:
    """Compile ``sources`` (variant texts) in parallel; return variant
    index -> loaded library for those that built."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, text in enumerate(sources):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        lib = out_dir / f"libv{i}.so"
        jobs.append((i, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for i, lib, proc in jobs:
        log = proc.communicate()[0]
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"variant {i} {labels[i]}: rc {proc.returncode}, registers "
              f"{regs}, spill stores {spills}")
        if proc.returncode == 0:
            libs[i] = ctypes.CDLL(str(lib))
        else:
            print(log[-3000:])
    return libs
