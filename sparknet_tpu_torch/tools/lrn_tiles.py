"""Time the LRN backward kernel (K6) over launch shapes, on the card.

Each variant is ``ops/csrc/lrn.cu`` with K6's constants replaced (the
threads a block, the channels of x and dy a thread loads a group ahead,
the blocks an SM should hold) and the
channels a block takes (the chunk argument), built with the port's nvcc
flags into ``build/lrn_tiles/`` (all variants at once), held to the plain
version bit for bit at AlexNet's two LRN inputs at the training batch
(32 x 96 x 55 x 55 and 32 x 256 x 27 x 27), and timed on the device from
a CUDA graph of 20 launches, every variant in turn, twice, per input and
for both.  ``--baseline FILE`` adds another ``lrn.cu`` (an earlier
version, unpacked from git) as one more variant, at the chunk the parent
used (``cuda_lrn.CHUNK``), timed in the same turns.  Run from the root of
a checkout, on a machine with the card::

    python -m sparknet_tpu_torch.tools.lrn_tiles [--baseline FILE]

The package's kernel keeps the constants of the source; this script only
measures the alternatives.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_lrn as cl
from sparknet_tpu_torch.tools import _variants

# (threads, channels a group, blocks an SM, channels a block takes)
VARIANTS = (
    (384, 4, 2, 64),
    (384, 4, 2, 96),
    (288, 4, 3, 64),
    (256, 4, 4, 96),
    (320, 4, 3, 64),
    (384, 4, 2, 32),
    (384, 2, 2, 64),
    (384, 8, 2, 64),
    (256, 4, 4, 64),
)
SHAPES = ((32, 96, 55, 55), (32, 256, 27, 27))
LRN_HP = (5, 1e-4, 0.75, 1.0)
REPEATS = 2


def _variant_source(threads, group, blocks, chunk) -> str:
    src = (_build.SRC_DIR / "lrn.cu").read_text()
    for name, val in (("K6_THREADS", threads), ("K6_G", group),
                      ("K6_MB", blocks)):
        src = _variants.substitute(src, rf"\b{name} = \d+", f"{name} = {val}")
    return src


def _runs(lib, inputs, chunk):
    """One (launch, dx, the plain version's dx) per LRN input."""
    pre, post, kk, an, coef, q, nb = cl.hp_args("lrn_tiles", *LRN_HP)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.sparknet_lrn_bwd_f32
    fn.argtypes = [P, P, P, I, I, I, I, I, I, F, F, F, I, F, P]
    fn.restype = ctypes.c_int
    runs = []
    for x, dy, want in inputs:
        n, c, h, w = x.shape
        dx = torch.empty_like(x)

        def launch(x=x, dy=dy, dx=dx, n=n, c=c, hw=h * w):
            rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, hw, chunk,
                    pre, post, kk, an, coef, q, nb,
                    torch.cuda.current_stream().cuda_stream)
            _build.raise_on(rc, "lrn_tiles")

        runs.append((launch, dx, want))
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", default=None,
                        help="another lrn.cu, timed as one more variant")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lrn_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    sources = [_variant_source(*v) for v in VARIANTS]
    labels = [str(v) for v in VARIANTS]
    chunks = [v[3] for v in VARIANTS]
    if args.baseline:
        sources.append(Path(args.baseline).read_text())
        labels.append(f"baseline {args.baseline}")
        chunks.append(cl.CHUNK)
    libs = _variants.build(
        Path("build") / "lrn_tiles", sources, labels,
        {len(VARIANTS): Path(args.baseline).parent} if args.baseline else None)
    print(card_name_and_power_limit(0))
    gen = torch.Generator().manual_seed(7)
    inputs = []
    for s in SHAPES:
        x = torch.randn(*s, generator=gen).cuda()
        dy = torch.randn(*s, generator=gen).cuda()
        inputs.append((x, dy, cl.lrn_across_bwd_reference(x, dy, *LRN_HP)))
    runs = {i: _runs(lib, inputs, chunks[i]) for i, lib in libs.items()}
    _variants.bit_equal_then_time(runs, labels, SHAPES, REPEATS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
