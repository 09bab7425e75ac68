"""Time the LRN backward kernel (K6) over launch shapes, on the card; the
forward (K5) with ``--fwd``.

Each variant is ``ops/csrc/lrn.cu`` with the kernel's constants replaced
(the threads a block, the channels of x (K6: and dy) a thread loads a
group ahead, the blocks an SM should hold) and the channels a block
takes (the chunk argument), built with the port's nvcc flags into
``build/lrn_tiles/`` (``lrn_tiles_fwd/``; all variants at once), held to
the plain version bit for bit at AlexNet's two LRN inputs at the
training batch (32 x 96 x 55 x 55 and 32 x 256 x 27 x 27), and timed on
the device from a CUDA graph of 20 launches, every variant in turn,
twice, per input and for both.  ``--baseline FILE`` adds another
``lrn.cu`` (an earlier version, unpacked from git) as one more variant,
at the chunk the package passes that kernel (``cuda_lrn.FWD_CHUNK`` or
``BWD_CHUNK``; give ``--baseline_chunk`` where the earlier version took
another), timed in the same turns.  Run from the root of a checkout, on
a machine with the card::

    python -m sparknet_tpu_torch.tools.lrn_tiles [--fwd] [--baseline FILE]

The package's kernels keep the constants of the source; this script only
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
FWD_VARIANTS = (
    (256, 4, 4, 16),
    (256, 4, 4, 8),
    (256, 4, 4, 12),
    (256, 4, 4, 20),
    (256, 4, 4, 24),
    (256, 4, 4, 32),
    (128, 4, 8, 16),
    (384, 4, 2, 16),
    (512, 4, 2, 16),
    (256, 2, 4, 16),
    (256, 8, 4, 16),
    (384, 8, 2, 16),
    (256, 4, 3, 16),
    (384, 8, 2, 64),
)
BWD_VARIANTS = (
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


def _variant_source(kernel, threads, group, blocks, chunk) -> str:
    src = (_build.SRC_DIR / "lrn.cu").read_text()
    for name, val in ((f"{kernel}_THREADS", threads), (f"{kernel}_G", group),
                      (f"{kernel}_MB", blocks)):
        src = _variants.substitute(src, rf"\b{name} = \d+", f"{name} = {val}")
    return src


def _runs(lib, inputs, chunk, fwd: bool):
    """One (launch, output, the plain version's output) per LRN input."""
    pre, post, kk, an, coef, q, nb = cl.hp_args("lrn_tiles", *LRN_HP)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if fwd:
        fn = lib.sparknet_lrn_fwd_f32
        fn.argtypes = [P, P, I, I, I, I, I, I, F, F, I, F, P]
    else:
        fn = lib.sparknet_lrn_bwd_f32
        fn.argtypes = [P, P, P, I, I, I, I, I, I, F, F, F, I, F, P]
    fn.restype = ctypes.c_int
    runs = []
    for x, dy, want in inputs:
        n, c, h, w = x.shape
        out = torch.empty_like(x)
        ins = (x.data_ptr(),) if fwd else (x.data_ptr(), dy.data_ptr())
        hp = (kk, an, q, nb) if fwd else (kk, an, coef, q, nb)

        def launch(ins=ins, out=out, n=n, c=c, hw=h * w, hp=hp):
            rc = fn(*ins, out.data_ptr(), n, c, hw, chunk, pre, post, *hp,
                    torch.cuda.current_stream().cuda_stream)
            _build.raise_on(rc, "lrn_tiles")

        runs.append((launch, out, want))
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--fwd", action="store_true",
                        help="the forward (K5), not the backward (K6)")
    parser.add_argument("--baseline", default=None,
                        help="another lrn.cu, timed as one more variant")
    parser.add_argument("--baseline_chunk", type=int, default=None,
                        help="the channels a block of the baseline takes")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lrn_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    variants = FWD_VARIANTS if args.fwd else BWD_VARIANTS
    kernel = "K5" if args.fwd else "K6"
    sources = [_variant_source(kernel, *v) for v in variants]
    labels = [str(v) for v in variants]
    chunks = [v[3] for v in variants]
    if args.baseline:
        sources.append(Path(args.baseline).read_text())
        labels.append(f"baseline {args.baseline}")
        chunks.append(args.baseline_chunk or
                      (cl.FWD_CHUNK if args.fwd else cl.BWD_CHUNK))
    libs = _variants.build(
        Path("build") / ("lrn_tiles_fwd" if args.fwd else "lrn_tiles"),
        sources, labels,
        {len(variants): Path(args.baseline).parent} if args.baseline else None)
    print(card_name_and_power_limit(0))
    gen = torch.Generator().manual_seed(7)
    inputs = []
    for s in SHAPES:
        x = torch.randn(*s, generator=gen).cuda()
        dy = torch.randn(*s, generator=gen).cuda()
        want = (cl.lrn_across_reference(x, *LRN_HP) if args.fwd
                else cl.lrn_across_bwd_reference(x, dy, *LRN_HP))
        inputs.append((x, dy, want))
    runs = {i: _runs(lib, inputs, chunks[i], args.fwd)
            for i, lib in libs.items()}
    _variants.bit_equal_then_time(runs, labels, SHAPES, REPEATS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
