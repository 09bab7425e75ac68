"""Time the decode attention kernel (K2) over its tile shapes, on the card.

Each variant is ``ops/csrc/decode_attention.cu`` with its constants
replaced (``SPLIT`` positions a CTA, ``NT`` threads a CTA, and
``MERGE_IN_KERNEL``: the split partials merged by the CTA that draws the
last ticket, or by a second launch), built for head dims 64 and 256 with
the port's nvcc flags into ``build/decode_tiles/`` (all variants at
once), held within ``KERNEL_ATOL`` of the paged plain version at every
timed shape with two launches bit-identical, and timed on the device
from a CUDA graph of 20 launches, every variant in turn, twice, beside
``scaled_dot_product_attention`` on the context gathered from the arena
(a yardstick the port never calls).  The shapes are ``chip_smoke.py``'s
paged arena at the serving geometry (8 slots, 64 KV blocks of 16 and
the trash block, shuffled tables, lengths 1-256 summing to 1021) at
H=4, D=64 and at H=2, D=256.

Each shape also runs with every slot at length 1 (one split a slot, no
merge) and 0 (each CTA reads its length and leaves): what the first
loads, the launch and the merge take.  ``--baseline FILE`` (repeatable)
adds an earlier ``decode_attention.cu`` as one more variant, timed in
the same turns: a paged one, or one whose C entry is the gathered
``sparknet_decode_attention_f32`` (one block per (slot, head) over a
(B, S, H, D) context), which runs on the context gathered from the same
arena, printed beside the gather that fed it, for one layer's k and v
and for the serving model's 4 layers at once (a decode step's gather).
Run from the root of a checkout, on a machine with the card::

    python -m sparknet_tpu_torch.tools.decode_tiles [--baseline FILE ...]

The package's kernel keeps the constants of the source; this script only
measures the alternatives.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import sys
from pathlib import Path

import torch

from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.ops import cuda_attention as ca
from sparknet_tpu_torch.tools import _variants

# (positions a CTA, threads a CTA, 1: the last ticket merges / 0: a
# second launch)
VARIANTS = (
    (16, 64, 1), (16, 128, 1), (32, 32, 1), (32, 64, 1), (32, 128, 1),
    (64, 32, 1), (64, 64, 1), (64, 128, 1), (64, 256, 1),
    (128, 64, 1), (128, 128, 1), (128, 256, 1),
    (16, 128, 0), (32, 64, 0), (32, 128, 0), (64, 64, 0), (64, 128, 0),
    (64, 256, 0),
)
SHAPES = ((4, 64), (2, 256))  # (H, D)
DEPTH = 4  # the serving model's layers: a decode step's gather covers all
KERNEL_ATOL = 2e-5
REPEATS = 2
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _variant_source(split, threads, merge) -> str:
    src = (_build.SRC_DIR / "decode_attention.cu").read_text()
    for name, val in (("SPLIT", split), ("NT", threads),
                      ("MERGE_IN_KERNEL", merge)):
        src = _variants.substitute(src, rf"constexpr int {name} = \d+;",
                                   f"constexpr int {name} = {val};")
    return _variants.substitute(src, r"FLASH_HEAD_DIMS\(LAUNCH\)",
                                " ".join(f"LAUNCH({d})" for _, d in SHAPES))


def _paged_launcher(lib, q, ak, av, table, lengths, bs):
    """``(launch, o)`` of one variant's K2 on the paged arena."""
    b, _, h, d = q.shape
    work = torch.empty((lib.sparknet_paged_decode_workspace(
        b, h, d, table.shape[1] * bs),), device=q.device)
    tickets = torch.zeros((b * h,), dtype=torch.int32, device=q.device)
    o = torch.empty_like(q)
    fn = lib.sparknet_paged_decode_f32
    fn.argtypes = [P] * 8 + [I] * 6 + [L] * 9 + [F, P]
    fn.restype = ctypes.c_int
    strides = [(bs * t.stride(0), t.stride(0), t.stride(1)) for t in (ak, av)]

    def launch():
        rc = fn(q.data_ptr(), ak.data_ptr(), av.data_ptr(), table.data_ptr(),
                lengths.data_ptr(), o.data_ptr(), work.data_ptr(),
                tickets.data_ptr(), b, h, d, d, table.shape[1], bs,
                q.stride(0), q.stride(2), *strides[0], *strides[1],
                table.stride(0), 1 / math.sqrt(d),
                torch.cuda.current_stream().cuda_stream)
        _build.raise_on(rc, "decode_tiles")

    return launch, o


def _gathered_launcher(lib, q, k, v, lengths):
    """``(launch, o)`` of the baseline's gathered entry on (B, S, H, D)."""
    b, s, h, d = k.shape
    o = torch.empty_like(q)
    fn = lib.sparknet_decode_attention_f32
    fn.argtypes = [P] * 5 + [I] * 4 + [L] * 8 + [F, P]
    fn.restype = ctypes.c_int

    def launch():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), b, s, h, d, q.stride(0), q.stride(2),
                *k.stride()[:3], *v.stride()[:3], 1 / math.sqrt(d),
                torch.cuda.current_stream().cuda_stream)
        _build.raise_on(rc, "decode_tiles baseline")

    return launch, o


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="an earlier decode_attention.cu, paged or gathered "
                    "(repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_tiles: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F_

    import chip_smoke as cs
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    sources = [_variant_source(*v) for v in VARIANTS]
    labels = [str(v) for v in VARIANTS]
    include = {}
    for path in args.baseline:
        include[len(sources)] = path.resolve().parent
        sources.append(path.read_text())
        labels.append(f"baseline {path}")
    libs = _variants.build(Path("build") / "decode_tiles", sources, labels,
                           include)
    gathered = {i for i, lib in libs.items()
                if not hasattr(lib, "sparknet_paged_decode_f32")}
    print(card_name_and_power_limit(0))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    bs = cs.CLI_SERVE["kv_block_size"]
    s = cs.CLI_MODEL["seq_len"]
    b = cs.CLI_SERVE["max_streams"]
    length_sets = {"serving": cs.DECODE_LENGTHS, "all 1": [1] * b,
                   "all 0": [0] * b}
    timed = {}
    for h, d in SHAPES:
        q, ak, av, table = cs.paged_decode_case(dev, gen, h, d)
        j = torch.arange(s, device=dev)
        index_map = table.long()[:, j // bs] * bs + j % bs  # (B, S) rows
        kg, vg = ak[index_map], av[index_map]
        if gathered:
            # the decode step's gather: k and v of every layer at once
            ak4, av4 = (t.expand(DEPTH, *t.shape).contiguous()
                        for t in (ak, av))
            one = cs.device_ms(lambda: (ak[index_map], av[index_map]))
            step = cs.device_ms(lambda: (ak4[:, index_map], av4[:, index_map]))
            print(f"H={h} D={d}: the gather feeding the gathered baseline, k "
                  f"and v of one layer {one:.4f} ms, of {DEPTH} layers (a "
                  f"decode step's) {step:.4f} ms")
        for name, lens in length_sets.items():
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            want = ca.paged_decode_attention_reference(q, ak, av, table,
                                                       lengths, bs)
            if name == "serving":
                mask = (j[None, :] < lengths[:, None])[:, None, None, :]
                qt, kt, vt = (x.transpose(1, 2) for x in (q, kg, vg))
                sdpa = cs.device_ms(lambda: F_.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask))
                print(f"H={h} D={d}: scaled_dot_product_attention (masked, "
                      f"gathered context) {sdpa:.4f} ms")
            for i, lib in libs.items():
                if i in gathered:
                    launch, o = _gathered_launcher(lib, q, kg, vg, lengths)
                else:
                    launch, o = _paged_launcher(lib, q, ak, av, table, lengths,
                                                bs)
                launch()
                first = o.clone()
                launch()
                torch.cuda.synchronize()
                err = cs.max_err(o, want)
                same = torch.equal(o, first)
                if err > KERNEL_ATOL or not same:
                    print(f"variant {i} {labels[i]} H={h} D={d} {name}: "
                          f"max_abs_err {err:.2e}, two launches "
                          f"{'equal' if same else 'DIFFER'} — FAILS")
                timed[i, h, d, name] = launch
    for rep in range(REPEATS):  # every variant in turn, REPEATS times
        for i in libs:
            times = {key[1:]: cs.device_ms(fn) for key, fn in timed.items()
                     if key[0] == i}
            print(f"pass {rep} variant {i} {labels[i]}: " + ", ".join(
                f"H={h} D={d} {name} {ms:.4f}"
                for (h, d, name), ms in times.items()) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
