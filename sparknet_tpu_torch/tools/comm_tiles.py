"""Time the comm epilogue's encode (K9), barriered apply (K10) and overlap
correction (K11) over tile shapes, on the card.

Each variant is ``ops/csrc/comm_epilogue.cu`` with the tile map's
constants replaced (the elements of a worker's slice a block takes, the
threads a block, the 16-byte loads of each array a thread has in flight),
built with the port's nvcc flags into ``build/comm_tiles/`` (all variants
at once), held to the plain versions bit for bit (the readout's sums
within 1e-5) at two leaf sets — AlexNet's 16 parameter leaves at W=2 and
cifar10_full's 8 at W=4, each in the three chunks ``parallel/comm.py``
cuts them into — and timed on the device per round (every chunk) from a
CUDA graph of 20 rounds, every variant in turn, twice: K9 int8 with the
readout, K10 with every worker live, K11 bf16 and int8 (its payload and
scales the plain encode's).  ``--baseline FILE`` (repeatable)
adds another ``comm_epilogue.cu`` (an earlier version, unpacked from
git: on the tile map, or one block per leaf and worker, whose leaf table
lacks the tile map's fields) as one more variant, timed in the same
turns.  Run from the root of a
checkout, on a machine with the card::

    python -m sparknet_tpu_torch.tools.comm_tiles [--baseline FILE ...]

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
from sparknet_tpu_torch.ops import cuda_comm as cc
from sparknet_tpu_torch.tools import _variants

# (elements a tile, threads a block, 16-byte loads in flight)
VARIANTS = (
    (4096, 256, 4),
    (8192, 256, 4),
    (16384, 256, 4),
    (2048, 256, 4),
    (8192, 128, 4),
    (8192, 512, 4),
    (16384, 512, 4),
    (8192, 256, 2),
    (8192, 256, 8),
    (4096, 128, 2),
)
# per leaf set: W and the chunks of (per-worker) leaf shapes
LEAF_SETS = {
    "AlexNet": (2, (
        ((96, 3, 11, 11), (96,), (256, 48, 5, 5), (256,), (384, 256, 3, 3),
         (384,), (384, 192, 3, 3), (384,), (256, 192, 3, 3), (256,),
         (4096, 9216)),
        ((4096,), (4096, 4096)),
        ((4096,), (1000, 4096), (1000,)))),
    "cifar10_full": (4, (
        ((32, 3, 5, 5), (32,), (32, 32, 5, 5)),
        ((32,), (64, 32, 5, 5)),
        ((64,), (10, 1024), (10,)))),
}
CORR_MODES = ("bf16", "int8")
REPEATS = 2
P, I = ctypes.c_void_p, ctypes.c_int


class _ParentLeaf(ctypes.Structure):
    """The leaf record of the one-block-per-leaf version (no tile map)."""

    _fields_ = [
        ("x", P), ("a", P), ("r", P), ("mean", P), ("q", P),
        ("scale", P), ("out0", P), ("out1", P),
        ("n", ctypes.c_longlong), ("mode", ctypes.c_int),
    ]


def _variant_source(tile, threads, unroll) -> str:
    src = (_build.SRC_DIR / "comm_epilogue.cu").read_text()
    for name, val in (("TILE", tile), ("THREADS", threads), ("UNROLL", unroll)):
        src = _variants.substitute(src, rf"\bconstexpr int {name} = \d+;",
                                   f"constexpr int {name} = {val};")
    return src


def _chunk_inputs(w, shapes, gen):
    """x, a, r near a random init and the chunk means, on the card."""
    def leaves(scale):
        return [torch.randn((w,) + s, generator=gen, device="cuda") * scale
                for s in shapes]

    a = leaves(1e-2)
    x = [t + d for t, d in zip(a, leaves(1e-3))]
    return x, a, leaves(1e-6), [t[0].contiguous() for t in leaves(1e-2)]


class _Chunk:
    """One chunk's inputs, the plain versions' outputs, and a variant's
    preallocated outputs and launch tables."""

    def __init__(self, w, shapes, gen):
        self.w = w
        self.x, self.a, self.r, self.m = _chunk_inputs(w, shapes, gen)
        self.modes = ("int8",) * len(shapes)
        self.alive = torch.ones(w, device="cuda")
        self.d0 = self.alive.sum()
        self.want_enc = cc.encode_reference(self.x, self.a, self.r, self.modes,
                                            True)
        self.want_app = cc.apply_barriered_reference(
            self.x, self.a, self.m, self.r, self.alive, self.d0)
        # K11 per mode: payload, scales, the plain version's params and
        # anchors, and outputs every variant writes (each is checked
        # before the next variant runs)
        self.corr = {}
        for mode in CORR_MODES:
            modes = (mode,) * len(shapes)
            q, s = cc.encode_reference(self.x, self.a, self.r, modes, False)[:2]
            want = cc.apply_correction_reference(self.x, self.a, q, s, self.m,
                                                 modes)
            self.corr[mode] = (q, s, want, [torch.empty_like(t) for t in self.x],
                               [torch.empty_like(t) for t in self.x])

    def _correction(self, lib, parent: bool, mode: str):
        """The K11 launch of one mode for one variant."""
        n, w = len(self.x), self.w
        q, s, _, nx, na = self.corr[mode]
        leaf = _ParentLeaf if parent else cc._Leaf
        extra = () if parent else (0,)  # the tile map's `first`
        table = (leaf * n)(*(
            leaf(x.data_ptr(), a.data_ptr(), None, m.data_ptr(), qq.data_ptr(),
                 ss.data_ptr(), o.data_ptr(), o2.data_ptr(), x[0].numel(),
                 *extra, cc.MODES[mode])
            for x, a, m, qq, ss, o, o2 in zip(self.x, self.a, self.m, q, s,
                                              nx, na)))
        fn = lib.sparknet_comm_apply_correction
        fn.argtypes = [P, I, I, P]

        def correct():
            rc = fn(table, n, w, torch.cuda.current_stream().cuda_stream)
            _build.raise_on(rc, "comm_tiles correction")

        return correct

    def launches(self, lib, parent: bool):
        """(encode launch, apply launch, one K11 launch per CORR_MODES,
        check) for one variant."""
        n, w = len(self.x), self.w
        q = [torch.empty_like(t, dtype=torch.int8) for t in self.x]
        scale = [torch.empty(w, device="cuda") for _ in self.x]
        nr = [torch.empty_like(t) for t in self.x]
        parts = torch.empty((w, n, 3), device="cuda")
        nx = [torch.empty_like(t) for t in self.x]
        nr2 = [torch.empty_like(t) for t in self.x]
        mode = cc.MODES["int8"]
        if parent:
            enc_t = (_ParentLeaf * n)(*(
                _ParentLeaf(x.data_ptr(), a.data_ptr(), r.data_ptr(), None,
                            qq.data_ptr(), s.data_ptr(), o.data_ptr(), None,
                            x[0].numel(), mode)
                for x, a, r, qq, s, o in zip(self.x, self.a, self.r, q, scale, nr)))
            app_t = (_ParentLeaf * n)(*(
                _ParentLeaf(x.data_ptr(), a.data_ptr(), r.data_ptr(),
                            m.data_ptr(), None, None, o.data_ptr(),
                            o2.data_ptr(), x[0].numel(), 0)
                for x, a, r, m, o, o2 in zip(self.x, self.a, self.r, self.m,
                                             nx, nr2)))
            enc = lib.sparknet_comm_encode
            enc.argtypes = [P, I, I, P, P]
            enc_args = (enc_t, n, w, parts.data_ptr())
        else:
            enc_t = (cc._Leaf * n)(*(
                cc._Leaf(x.data_ptr(), a.data_ptr(), r.data_ptr(), None,
                         qq.data_ptr(), s.data_ptr(), o.data_ptr(), None,
                         x[0].numel(), 0, mode)
                for x, a, r, qq, s, o in zip(self.x, self.a, self.r, q, scale, nr)))
            app_t = (cc._Leaf * n)(*(
                cc._Leaf(x.data_ptr(), a.data_ptr(), r.data_ptr(), m.data_ptr(),
                         None, None, o.data_ptr(), o2.data_ptr(),
                         x[0].numel(), 0, 0)
                for x, a, r, m, o, o2 in zip(self.x, self.a, self.r, self.m,
                                             nx, nr2)))
            blocks_fn = lib.sparknet_comm_blocks
            blocks_fn.argtypes = [P, I, I]
            blocks = blocks_fn(enc_t, n, w)
            scratch = torch.empty(3 * blocks, device="cuda")
            counters = torch.zeros(2 * n * w, dtype=torch.int32,
                                   device="cuda")
            enc = lib.sparknet_comm_encode
            enc.argtypes = [P, I, I, P, P, P, P]
            enc_args = (enc_t, n, w, parts.data_ptr(), scratch.data_ptr(),
                        counters.data_ptr())
        app = lib.sparknet_comm_apply_barriered
        app.argtypes = [P, I, I, P, P, P]

        # the scratch and counters the encode reads live as long as it does
        keep = () if parent else (scratch, counters)

        def encode(keep=keep):
            if not parent:  # zeros for each call, as the wrapper makes them
                counters.zero_()
            rc = enc(*enc_args, torch.cuda.current_stream().cuda_stream)
            _build.raise_on(rc, "comm_tiles encode")

        def apply():
            rc = app(app_t, n, w, self.alive.data_ptr(), self.d0.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            _build.raise_on(rc, "comm_tiles apply")

        def check() -> str:
            wq, ws, wr, werr = self.want_enc
            pairs = [("q", q, wq), ("scale", scale, ws), ("resid", nr, wr),
                     ("params", nx, self.want_app[0]),
                     ("apply resid", nr2, self.want_app[1])]
            for m, (_, _, (wx, wa), cx, ca) in self.corr.items():
                pairs += [(f"K11 {m} params", cx, wx),
                          (f"K11 {m} anchor", ca, wa)]
            bad = [name for name, got, want in pairs
                   if not all(torch.equal(g, x) for g, x in zip(got, want))]
            got_err = cc._combine_parts(parts)
            if not torch.equal(got_err[:, 0], werr[:, 0]):
                bad.append("readout max")
            rel = float(((got_err[:, 1:] - werr[:, 1:]).abs()
                         / werr[:, 1:].abs().clamp_min(1e-30)).max())
            if rel > 1e-5:
                bad.append(f"readout sums ({rel:.2e})")
            return ", ".join(bad)

        corrections = tuple(self._correction(lib, parent, m) for m in CORR_MODES)
        return (encode, apply, *corrections, check)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", action="append", default=[],
                        help="another comm_epilogue.cu, timed as one more "
                        "variant (repeatable)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("comm_tiles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    sources = [_variant_source(*v) for v in VARIANTS]
    labels = [str(v) for v in VARIANTS]
    parents = set()  # baselines without the tile map
    for path in args.baseline:
        src = Path(path).read_text()
        if "tiles;" not in src:
            parents.add(len(sources))
        sources.append(src)
        labels.append(f"baseline {path}")
    libs = _variants.build(Path("build") / "comm_tiles", sources, labels)
    print(card_name_and_power_limit(0))
    gen = torch.Generator(device="cuda").manual_seed(7)
    sets = {name: [_Chunk(w, shapes, gen) for shapes in chunks]
            for name, (w, chunks) in LEAF_SETS.items()}
    runs = {}
    for i, lib in libs.items():
        per_set = {name: [c.launches(lib, i in parents) for c in chunks]
                   for name, chunks in sets.items()}
        for name, calls in per_set.items():
            for *run, _ in calls:
                for launch in run:
                    launch()
            torch.cuda.synchronize()
            bad = [c[-1]() for c in calls]
            if any(bad):
                print(f"variant {i} {labels[i]} {name}: NOT equal to the plain "
                      f"versions: {bad}")
        runs[i] = per_set
    for rep in range(REPEATS):
        for i, per_set in runs.items():
            times = []
            for name, calls in per_set.items():
                for k, tag in ((0, "K9"), (1, "K10"),
                               *((2 + j, f"K11 {m}")
                                 for j, m in enumerate(CORR_MODES))):
                    ms = cs.device_ms(lambda c=calls, k=k: [f[k]() for f in c])
                    times.append(f"{name} {tag} {ms:.4f}")
            print(f"pass {rep} variant {i} {labels[i]}: " + ", ".join(times)
                  + " ms a round")
    return 0


if __name__ == "__main__":
    sys.exit(main())
