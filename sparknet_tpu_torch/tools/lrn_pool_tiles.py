"""Time the fused LRN + max-pool backward kernel (K8) over tile shapes, on
the card.

Each variant is ``ops/csrc/lrn_pool.cu`` with K8's constants replaced —
the dx tile (rows, columns) and the blocks an SM should hold, of planes
up to 32 wide and of wider planes, the channels per barrier group and
the stage-2 items a thread may own — and the channels a block takes
(the chunk argument), built with the port's nvcc flags
into ``build/lrn_pool_tiles/`` (all variants at once), held to the plain
version bit for bit at AlexNet's two sandwiches at the training batch
(32 x 96 x 55 x 55 and 32 x 256 x 27 x 27), and timed on the device from
a CUDA graph of 20 launches, every variant in turn, twice, per sandwich
and for both.  ``--baseline FILE`` adds another ``lrn_pool.cu`` (an
earlier version, unpacked from git) as one more variant, timed in the
same turns.  Run from the root of a checkout, on a machine with the
card::

    python -m sparknet_tpu_torch.tools.lrn_pool_tiles [--baseline FILE]

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
from sparknet_tpu_torch.ops import cuda_plp as cp
from sparknet_tpu_torch.tools import _variants

# ((rows, cols, blocks an SM should hold) of planes up to 32 wide, the
#  same of wider planes, channels per barrier group, stage-2 items a
#  thread may own[, channels a block takes (the kernel's chunk argument)])
VARIANTS = (
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
SHAPES = ((32, 96, 55, 55), (32, 256, 27, 27))
LRN_HP = (5, 1e-4, 0.75, 1.0)
REPEATS = 2


def _variant_source(narrow, wide, group, ipt, chunk=None) -> str:
    src = (_build.SRC_DIR / "lrn_pool.cu").read_text()
    for name, val in (("K8_TH_NARROW", narrow[0]), ("K8_TW_NARROW", narrow[1]),
                      ("K8_MB_NARROW", narrow[2]), ("K8_TH_WIDE", wide[0]),
                      ("K8_TW_WIDE", wide[1]), ("K8_MB_WIDE", wide[2]),
                      ("K8_G", group), ("K8_IPT", ipt)):
        src = _variants.substitute(src, rf"\b{name} = \d+", f"{name} = {val}")
    return src


def _chunk(variant) -> int:
    return variant[4] if len(variant) > 4 else cl.CHUNK


def _launcher(lib, x, dy, chunk):
    pre, post, kk, an, coef, q, nb = cl.hp_args("lrn_pool_tiles", *LRN_HP)
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    fn = lib.sparknet_lrn_pool_bwd_f32
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, P, I, I, I, I, I, I, I, F, F, F, I, F, P]
    fn.restype = ctypes.c_int

    def launch():
        rc = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, h, w,
                chunk, pre, post, kk, an, coef, q, nb,
                torch.cuda.current_stream().cuda_stream)
        _build.raise_on(rc, "lrn_pool_tiles")

    return launch, dx


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", default=None,
                        help="another lrn_pool.cu, timed as one more variant")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lrn_pool_tiles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit
    sources = [_variant_source(*v) for v in VARIANTS]
    labels = [str(v) for v in VARIANTS]
    chunks = [_chunk(v) for v in VARIANTS]
    if args.baseline:
        sources.append(Path(args.baseline).read_text())
        labels.append(f"baseline {args.baseline}")
        chunks.append(cl.CHUNK)
    libs = _variants.build(Path("build") / "lrn_pool_tiles", sources, labels)
    print(card_name_and_power_limit(0))
    gen = torch.Generator().manual_seed(6)
    inputs = []
    for s in SHAPES:
        x = torch.randn(*s, generator=gen).cuda()
        dy = torch.randn(s[0], s[1], *cp.pooled_hw(*s[2:]), generator=gen).cuda()
        inputs.append((x, dy, cp.lrn_maxpool_bwd_reference(x, dy, *LRN_HP)))
    timed = {}
    for i, lib in libs.items():
        runs = []
        for x, dy, want in inputs:
            launch, dx = _launcher(lib, x, dy, chunks[i])
            launch()
            torch.cuda.synchronize()
            if not torch.equal(dx, want):
                print(f"variant {i} {labels[i]} {tuple(x.shape)}: NOT bit-equal "
                      f"to the plain version (max |diff| "
                      f"{float((dx - want).abs().max()):.3e})")
            runs.append(launch)
        timed[i] = runs
    for rep in range(REPEATS):  # every variant in turn, REPEATS times
        for i, runs in timed.items():
            each = [cs.device_ms(r) for r in runs]
            both = cs.device_ms(lambda: [r() for r in runs])
            print(f"pass {rep} variant {i} {labels[i]}: "
                  + ", ".join(f"{s} {ms:.4f}" for s, ms in zip(SHAPES, each))
                  + f", both {both:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
