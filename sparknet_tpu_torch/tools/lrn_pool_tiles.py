"""Time the fused LRN + max-pool kernels over tile shapes, on the card:
the backward (K8) by default, the forward (K7) with ``--fwd``.

Each variant is ``ops/csrc/lrn_pool.cu`` with the kernel's constants
replaced, and the channels a block takes (the chunk argument):

- K8: the dx tile (rows, columns) and the blocks an SM should hold, of
  planes up to 32 wide and of wider planes, the channels per barrier
  group and the stage-2 items a thread may own;
- K7: of planes up to 32 wide and of wider planes, the channels per
  barrier group, the threads, the input positions and pool items a
  thread may own, and the blocks an SM should hold.

All variants are built at once with the port's nvcc flags into
``build/lrn_pool_tiles_fwd/`` (``_bwd/``), held to the plain version bit for bit at
AlexNet's two sandwiches at the training batch (32 x 96 x 55 x 55 and
32 x 256 x 27 x 27), and timed on the device from a CUDA graph of 20
launches, every variant in turn, twice, per sandwich and for both.
``--baseline FILE`` adds another ``lrn_pool.cu`` (an earlier version,
unpacked from git) as one more variant, timed in the same turns.  Run
from the root of a checkout, on a machine with the card::

    python -m sparknet_tpu_torch.tools.lrn_pool_tiles [--fwd] [--baseline FILE]

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
from sparknet_tpu_torch.ops import cuda_plp as cp
from sparknet_tpu_torch.tools import _variants

# K8: ((rows, cols, blocks an SM should hold) of planes up to 32 wide, the
#  same of wider planes, channels per barrier group, stage-2 items a
#  thread may own[, channels a block takes (the kernel's chunk argument)])
BWD_VARIANTS = (
    ((28, 28, 1), (14, 28, 1), 4, 2),
    ((28, 28, 1), (14, 28, 2), 4, 2),
    ((28, 28, 1), (12, 28, 2), 4, 2),
    ((28, 28, 1), (10, 28, 2), 4, 2),
    ((28, 28, 1), (12, 56, 1), 4, 2),
    ((28, 28, 1), (14, 14, 3), 4, 2),
    ((28, 28, 1), (8, 28, 3), 4, 2),
    ((28, 28, 1), (14, 28, 1), 8, 4),
    ((28, 28, 1), (14, 28, 2), 4, 2, 16),
    ((28, 28, 1), (14, 28, 2), 4, 2, 48),
    ((28, 28, 1), (14, 28, 2), 4, 2, 64),
)
# K7: ((channels a group, threads, positions a thread, pool items a
#  thread, blocks an SM) of planes up to 32 wide, the same of wider
#  planes[, channels a block takes])
FWD_VARIANTS = (
    ((8, 384, 2, 4, 1), (4, 288, 3, 3, 3)),
    ((8, 384, 2, 4, 1), (2, 288, 3, 2, 3)),
    ((8, 384, 2, 4, 1), (2, 256, 4, 2, 3)),
    ((8, 384, 2, 4, 1), (4, 256, 4, 3, 3)),
    ((4, 384, 2, 2, 2), (4, 288, 3, 3, 3)),
    ((8, 384, 2, 4, 1), (4, 320, 3, 3, 2)),
    ((8, 384, 2, 4, 1), (4, 288, 3, 3, 3), 48),
)
SHAPES = ((32, 96, 55, 55), (32, 256, 27, 27))
LRN_HP = (5, 1e-4, 0.75, 1.0)
REPEATS = 2


def _bwd_source(narrow, wide, group, ipt, chunk=None) -> str:
    src = (_build.SRC_DIR / "lrn_pool.cu").read_text()
    for name, val in (("K8_TH_NARROW", narrow[0]), ("K8_TW_NARROW", narrow[1]),
                      ("K8_MB_NARROW", narrow[2]), ("K8_TH_WIDE", wide[0]),
                      ("K8_TW_WIDE", wide[1]), ("K8_MB_WIDE", wide[2]),
                      ("K8_G", group), ("K8_IPT", ipt)):
        src = _variants.substitute(src, rf"\b{name} = \d+", f"{name} = {val}")
    return src


def _fwd_source(narrow, wide, chunk=None) -> str:
    src = (_build.SRC_DIR / "lrn_pool.cu").read_text()
    for plane, shape in (("NARROW", narrow), ("WIDE", wide)):
        for name, val in zip(("G", "NT", "PPT", "IPT", "MB"), shape):
            src = _variants.substitute(src, rf"\bK7_{name}_{plane} = \d+",
                                       f"K7_{name}_{plane} = {val}")
    return src


def _chunk(variant, fwd: bool) -> int:
    n = 2 if fwd else 4
    return variant[n] if len(variant) > n else cl.CHUNK


def _runs(lib, inputs, chunk, fwd: bool):
    """One (launch, output, plain output) per sandwich."""
    pre, post, kk, an, coef, q, nb = cl.hp_args("lrn_pool_tiles", *LRN_HP)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if fwd:
        fn = lib.sparknet_lrn_pool_fwd_f32
        fn.argtypes = [P, P, I, I, I, I, I, I, I, F, F, I, F, P]
    else:
        fn = lib.sparknet_lrn_pool_bwd_f32
        fn.argtypes = [P, P, P, I, I, I, I, I, I, I, F, F, F, I, F, P]
    fn.restype = ctypes.c_int
    runs = []
    for x, dy, want in inputs:
        n, c, h, w = x.shape
        out = torch.empty_like(dy if fwd else x)

        def launch(x=x, dy=dy, out=out, n=n, c=c, h=h, w=w):
            stream = torch.cuda.current_stream().cuda_stream
            if fwd:
                rc = fn(x.data_ptr(), out.data_ptr(), n, c, h, w, chunk, pre,
                        post, kk, an, q, nb, stream)
            else:
                rc = fn(x.data_ptr(), dy.data_ptr(), out.data_ptr(), n, c, h,
                        w, chunk, pre, post, kk, an, coef, q, nb, stream)
            _build.raise_on(rc, "lrn_pool_tiles")

        runs.append((launch, out, want))
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--fwd", action="store_true",
                        help="time the forward (K7) instead of K8")
    parser.add_argument("--baseline", default=None,
                        help="another lrn_pool.cu, timed as one more variant")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lrn_pool_tiles: no CUDA device", file=sys.stderr)
        return 2
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    variants = FWD_VARIANTS if args.fwd else BWD_VARIANTS
    source = _fwd_source if args.fwd else _bwd_source
    sources = [source(*v) for v in variants]
    labels = [str(v) for v in variants]
    chunks = [_chunk(v, args.fwd) for v in variants]
    if args.baseline:
        sources.append(Path(args.baseline).read_text())
        labels.append(f"baseline {args.baseline}")
        chunks.append(cl.CHUNK)
    kernel = "fwd" if args.fwd else "bwd"
    libs = _variants.build(
        Path("build") / f"lrn_pool_tiles_{kernel}", sources, labels,
        {len(variants): Path(args.baseline).parent} if args.baseline else None)
    print(card_name_and_power_limit(0))
    gen = torch.Generator().manual_seed(6)
    inputs = []
    for s in SHAPES:
        x = torch.randn(*s, generator=gen).cuda()
        dy = torch.randn(s[0], s[1], *cp.pooled_hw(*s[2:]), generator=gen).cuda()
        want = (cp.lrn_maxpool_reference(x, *LRN_HP) if args.fwd
                else cp.lrn_maxpool_bwd_reference(x, dy, *LRN_HP))
        inputs.append((x, dy, want))
    runs = {i: _runs(lib, inputs, chunks[i], args.fwd) for i, lib in libs.items()}
    _variants.bit_equal_then_time(runs, labels, SHAPES, REPEATS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
