"""Time the flash backward kernels (K3, K4) over tile shapes, on the card.

Each variant is ``ops/csrc/flash_bwd.cu`` with its tile constants
replaced (``GROUPS`` rows of 16 per block, ``SPLIT`` warps per group, a
``SLICE`` of keys or queries per warp and stage), built with the port's
nvcc flags into ``build/flash_bwd_tiles/`` (all variants at once), held
against the plain versions at the LM training shape (B=8, T=256, H=4,
D=64, causal, nonzero dlse) and timed on the device from a CUDA graph of
20 launches, every variant in turn, twice.  ``--wide`` takes the shape
of ``lm_app --dim 512 --heads 2`` instead (B=8, T=256, H=2, D=256, where
K1-K4 split the output's columns into halves) and varies only K4 there:
its warps a key tile (``WIDE_K_SPLIT``) and the steps its loop over the
full head dim unrolls (``K_WIDE_UNROLL``).  ``--baseline FILE`` adds
another ``flash_bwd.cu`` (an earlier version, unpacked from git) as one
more variant, timed in the same turns.  Run from the root of a checkout,
on a machine with the card::

    python -m sparknet_tpu_torch.tools.flash_bwd_tiles [--wide] [--baseline FILE]

The package's kernels keep the constants of the source; this script only
measures the alternatives.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import sys
from pathlib import Path

import torch

from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_attention as ca
from sparknet_tpu_torch.tools import _variants

# (K3 groups, splits, slice), (K4 groups, splits at D <= 64, slice), and
# the blocks per SM that K3's and K4's ``__launch_bounds__`` ask for (0:
# none, the compiler's own register choice)
VARIANTS = (
    ((2, 4, 16), (2, 4, 16), 1, 1),
    ((2, 4, 16), (2, 2, 16), 2, 1),
    ((2, 2, 32), (2, 2, 32), 1, 1),
    ((1, 4, 16), (1, 4, 16), 1, 1),
    ((1, 4, 16), (1, 2, 16), 2, 1),
    ((2, 4, 8), (2, 4, 16), 1, 1),
    ((2, 1, 32), (2, 1, 32), 1, 1),
    ((1, 4, 8), (2, 4, 16), 2, 1),
    ((2, 4, 8), (2, 4, 16), 2, 1),
    ((1, 4, 16), (2, 4, 16), 3, 1),
    ((1, 2, 16), (2, 4, 16), 3, 1),
    ((1, 4, 16), (1, 4, 16), 2, 2),
    ((2, 4, 16), (2, 4, 16), 0, 0),
    ((1, 4, 8), (2, 4, 16), 2, 0),
)
# (WIDE_K_SPLIT, K_WIDE_UNROLL): K4's shapes at D > 128 that --wide times
WIDE_VARIANTS = ((4, 2), (4, 1), (4, 4), (2, 2))
BWD_RTOL = 2e-5
REPEATS = 2


def _variant_source(q, k, q_blocks, k_blocks) -> str:
    src = (_build.SRC_DIR / "flash_bwd.cu").read_text()
    q_arg = f", {q_blocks}" if q_blocks else ""
    k_arg = f", {k_blocks}" if k_blocks else ""
    src = re.sub(r"__launch_bounds__\(Q_NT(, \d+)?\)",
                 f"__launch_bounds__(Q_NT{q_arg})", src)
    src = re.sub(r"__launch_bounds__\(k_nt<D>\(\)(, \d+)?\)",
                 f"__launch_bounds__(k_nt<D>(){k_arg})", src)
    for name, val in zip(("Q_GROUPS", "Q_SPLIT", "Q_SLICE"), q):
        src = re.sub(rf"constexpr int {name} = \d+;",
                     f"constexpr int {name} = {val};", src)
    for name, val in (("K_GROUPS", k[0]), ("K_SLICE", k[2])):
        src = re.sub(rf"constexpr int {name} = \d+;",
                     f"constexpr int {name} = {val};", src)
    return re.sub(r"return D > 64 \? 2 : 4;", f"return D > 64 ? 2 : {k[1]};",
                  src)


def _wide_source(split: int, unroll: int) -> str:
    src = (_build.SRC_DIR / "flash_bwd.cu").read_text()
    for name, val in (("WIDE_K_SPLIT", split), ("K_WIDE_UNROLL", unroll)):
        src = _variants.substitute(src, rf"constexpr int {name} = \d+;",
                                   f"constexpr int {name} = {val};")
    return src


def _launchers(lib, ptrs, strides, shape):
    """``(K3 launch, K4 launch, (dq, dk, dv))`` of one variant's library,
    causal, offsets 0, on the current stream."""
    b, t, h, d = shape
    outs = [torch.empty(shape, device="cuda") for _ in range(3)]
    scale = ctypes.c_float(1 / math.sqrt(d))
    inputs = [ctypes.c_void_p(p) for p in ptrs]
    fdq, fdkv = lib.sparknet_flash_bwd_dq_f32, lib.sparknet_flash_bwd_dkv_f32
    for fn in (fdq, fdkv):
        fn.restype = ctypes.c_int

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def k3():
        rc = fdq(*inputs, ctypes.c_void_p(outs[0].data_ptr()), b, h, t, t, d,
                 strides, 0, 0, 1, scale, stream())
        assert rc == 0, rc

    def k4():
        rc = fdkv(*inputs, ctypes.c_void_p(outs[1].data_ptr()),
                  ctypes.c_void_p(outs[2].data_ptr()), b, h, t, t, d,
                  strides, 0, 0, 1, scale, stream())
        assert rc == 0, rc

    return k3, k4, outs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wide", action="store_true",
                        help="B=8, T=256, H=2, D=256; vary K4's shape there")
    parser.add_argument("--baseline", default=None,
                        help="another flash_bwd.cu, timed as one more variant")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_tiles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit
    if opts.wide:
        sources = [_wide_source(*v) for v in WIDE_VARIANTS]
        labels = [f"WIDE_K_SPLIT, K_WIDE_UNROLL {v}" for v in WIDE_VARIANTS]
        h, d = 2, 256
    else:
        sources = [_variant_source(*v) for v in VARIANTS]
        labels = [str(v) for v in VARIANTS]
        h, d = 4, 64
    include_dirs = None
    if opts.baseline:
        include_dirs = {len(sources): Path(opts.baseline).parent}
        sources.append(Path(opts.baseline).read_text())
        labels.append(f"baseline {opts.baseline}")
    libs = _variants.build(Path("build") / "flash_bwd_tiles", sources, labels,
                           include_dirs)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(2)
    args = cs._bwd_case(dev, gen, 8, 256, 256, h, d, 0, 0, True)
    want = (ca._flash_bwd_dq_reference(*args),
            *ca._flash_bwd_dkv_reference(*args))
    q = args[0]
    strides, _ = ca._bwd_launch_args("flash_bwd_tiles", *args[:7], None)
    # the C entries take q, k, v, o, do, lse, dlse
    ptrs = [t.data_ptr() for t in (*args[:3], args[4], args[3], *args[5:7])]
    print(card_name_and_power_limit(0))
    timed = {}
    for i, lib in libs.items():
        k3, k4, (dq, dk, dv) = _launchers(lib, ptrs, strides, q.shape)
        k3()
        k4()
        torch.cuda.synchronize()
        errs = [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                for g, w in zip((dq, dk, dv), want)]
        print(f"variant {i} {labels[i]}: errors "
              f"{', '.join(f'{e:.2e}' for e in errs)} ("
              f"{'ok' if max(errs) <= BWD_RTOL else 'OVER BWD_RTOL'})")
        timed[i] = (k3, k4)
    for rep in range(REPEATS):  # every variant in turn, REPEATS times
        for i, (k3, k4) in timed.items():
            t3, t4 = cs.device_ms(k3), cs.device_ms(k4)
            print(f"pass {rep} variant {i} {labels[i]}: K3 {t3:.4f} ms, "
                  f"K4 {t4:.4f} ms, K3+K4 {t3 + t4:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
