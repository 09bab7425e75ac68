"""Build variants of a kernel source for the tile-sweep tools.

Each variant is a copy of a ``csrc/*.cu`` source with some constants
replaced, compiled with the port's nvcc flags (and the ``csrc`` include
path, for the shared headers), all variants at once, each into its own
shared library under ``out_dir``.  The ptxas lines (registers, spills)
of every variant are printed.  ``bit_equal_then_time`` holds each
variant's output to the plain version bit for bit and times the variants
in turns.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from sparknet_tpu_torch.ops import _build


def substitute(src: str, pattern: str, replacement: str) -> str:
    """``re.sub`` that must match: a variant whose constant is not found
    would silently time the source's own shape."""
    out, n = re.subn(pattern, replacement, src)
    if n == 0:
        raise ValueError(f"variant pattern {pattern!r} matches nothing")
    return out


def build(out_dir: Path, sources: Sequence[str], labels: Sequence[str],
          include_dirs: Optional[Dict[int, Path]] = None
          ) -> Dict[int, ctypes.CDLL]:
    """Compile ``sources`` (variant texts) in parallel; return variant
    index -> loaded library for those that built.  A variant listed in
    ``include_dirs`` (a baseline from another tree) takes its headers from
    that directory first."""
    out_dir.mkdir(parents=True, exist_ok=True)
    include_dirs = include_dirs or {}
    jobs = []
    for i, text in enumerate(sources):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        lib = out_dir / f"libv{i}.so"
        incs = [str(include_dirs[i])] if i in include_dirs else []
        jobs.append((i, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             *[a for d in incs + [str(_build.SRC_DIR)] for a in ("-I", d)],
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


# a variant's run at one shape: (launch, its output tensor, the plain
# version's output)
Run = Tuple[Callable[[], None], object, object]


def bit_equal_then_time(runs: Dict[int, List[Run]], labels: Sequence[str],
                        shapes: Sequence, repeats: int) -> None:
    """Launch every variant once at every shape and report any output that
    is not the plain version's bits; then time each variant per shape and
    for all shapes together on the device (``chip_smoke.device_ms``: a CUDA
    graph of 20 launches), every variant in turn, ``repeats`` times."""
    import torch

    import chip_smoke as cs

    for i, variant_runs in list(runs.items()):
        for shape, (launch, got, want) in zip(shapes, variant_runs):
            try:
                launch()
            except RuntimeError as e:  # a refused launch: drop the variant
                print(f"variant {i} {labels[i]} {shape}: {e}")
                del runs[i]
                break
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"variant {i} {labels[i]} {shape}: NOT bit-equal to the "
                      f"plain version (max |diff| "
                      f"{float((got - want).abs().max()):.3e})")
    for rep in range(repeats):
        for i, variant_runs in runs.items():
            launches = [r[0] for r in variant_runs]
            each = [cs.device_ms(r) for r in launches]
            both = cs.device_ms(lambda: [r() for r in launches])
            print(f"pass {rep} variant {i} {labels[i]}: "
                  + ", ".join(f"{s} {ms:.4f}" for s, ms in zip(shapes, each))
                  + f", all {both:.4f} ms")
