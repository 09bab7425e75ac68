"""Time the flash forward kernel (K1) over tile shapes, on the card.

Each variant is ``ops/csrc/flash_fwd.cu`` with its tile constants
replaced (``F_GROUPS`` rows of 16 per block, ``F_SPLIT`` warps per
group, an ``F_SLICE`` of keys per warp and stage, and the blocks per SM
its ``__launch_bounds__`` asks for), built with the port's nvcc flags
into ``build/flash_fwd_tiles/`` (all variants at once), held against the
plain version at every timed shape, and timed on the device from a CUDA
graph of 20 launches, every variant in turn, twice, beside
``scaled_dot_product_attention`` on the same inputs.  The shapes are
serving's prefill buckets and the scorer's T (B=1, H=4, D=64, causal, T
in 16..256) and the LM training shape (B=8, T=256, H=4, D=64, causal).
Run from the root of a checkout, on a machine with the card::

    python -m sparknet_tpu_torch.tools.flash_fwd_tiles

The package's kernel keeps the constants of the source; this script only
measures the alternatives.
"""

from __future__ import annotations

import ctypes
import math
import sys
from pathlib import Path

import torch

from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_attention as ca
from sparknet_tpu_torch.tools import _variants

# (groups, splits, slice, blocks per SM of __launch_bounds__; 0: none)
VARIANTS = (
    (1, 4, 8, 2),
    (1, 4, 8, 0),
    (1, 4, 16, 2),
    (1, 4, 16, 0),
    (1, 4, 32, 2),
    (1, 2, 32, 2),
    (1, 8, 8, 1),
    (1, 8, 16, 1),
    (2, 4, 8, 1),
    (2, 4, 16, 1),
    (2, 2, 16, 2),
    (1, 2, 8, 4),
    (1, 1, 32, 4),
)
SHAPES = [(1, t) for t in (16, 32, 64, 128, 256)] + [(8, 256)]  # (B, T)
H, D = 4, 64
KERNEL_ATOL = 2e-5
REPEATS = 2


def _variant_source(groups, split, slice_, blocks) -> str:
    src = (_build.SRC_DIR / "flash_fwd.cu").read_text()
    for name, val in (("F_GROUPS", groups), ("F_SPLIT", split),
                      ("F_SLICE", slice_)):
        src = _variants.substitute(src, rf"constexpr int {name} = \d+;",
                                   f"constexpr int {name} = {val};")
    arg = f", {blocks}" if blocks else ""
    return _variants.substitute(src, r"__launch_bounds__\(F_NT(, \d+)?\)",
                                f"__launch_bounds__(F_NT{arg})")


def _launcher(lib, q, k, v):
    """``(launch, (o, lse))`` of one variant's K1, causal, the dense
    end-aligned offsets, on the current stream."""
    b, t, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=q.device)
    fn = lib.sparknet_flash_fwd_f32
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, L, L, L, L, L, L, L, L, L,
                   I, I, I, F, P]
    fn.restype = ctypes.c_int

    def launch():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, h, t, t, d, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], 0, 0, 1, 1 / math.sqrt(d),
                torch.cuda.current_stream().cuda_stream)
        _build.raise_on(rc, "flash_fwd_tiles")

    return launch, (o, lse)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_tiles: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as cs

    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit
    libs = _variants.build(Path("build") / "flash_fwd_tiles",
                           [_variant_source(*v) for v in VARIANTS],
                           [str(v) for v in VARIANTS])
    print(card_name_and_power_limit(0))
    gen = torch.Generator().manual_seed(3)
    inputs = {}
    for b, t in SHAPES:
        q, k, v = (torch.randn(b, t, H, D, generator=gen).cuda() for _ in range(3))
        want = ca._flash_core_reference(q, k, v, 0, 0, True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        inputs[b, t] = (q, k, v, want)
        print(f"B={b} T={t}: scaled_dot_product_attention {sdpa:.4f} ms")
    timed = {}
    for i, lib in libs.items():
        for (b, t), (q, k, v, want) in inputs.items():
            launch, (o, lse) = _launcher(lib, q, k, v)
            launch()
            torch.cuda.synchronize()
            err = max(cs.max_err(o, want[0]), cs.max_err(lse, want[1]))
            if err > KERNEL_ATOL:
                print(f"variant {i} {VARIANTS[i]} B={b} T={t}: max_abs_err "
                      f"{err:.2e} OVER KERNEL_ATOL")
            timed[i, b, t] = launch
    for rep in range(REPEATS):  # every variant in turn, REPEATS times
        for i in libs:
            times = {bt: cs.device_ms(timed[(i, *bt)]) for bt in inputs}
            print(f"pass {rep} variant {i} {VARIANTS[i]}: " + ", ".join(
                f"B={b} T={t} {ms:.4f}" for (b, t), ms in times.items()) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
