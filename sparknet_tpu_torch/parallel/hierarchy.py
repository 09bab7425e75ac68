"""Two-tier averaging topology: the ``HierarchySpec``.

The port's own copy of ``sparknet_tpu/parallel/hierarchy.py``: the
slice grouping (which dp workers share a slice) and K =
``cross_slice_every`` (within-slice averaging every round, the
cross-slice average every K-th round).  ``ParameterAveragingTrainer(
hierarchy=spec)`` consumes it: rounds where ``(r + 1) % K != 0`` average
each slice's live workers only, every K-th round is the ordinary global
round, so compression and overlap apply on that tier only.  A flat spec
(one slice, or K == 1) runs the global round every round and is
bit-identical to no spec.  With the workers stacked on one card the
intra-slice tier is a masked mean per slice group; the tier byte
counters (``sparknet_hierarchy_bytes_total{tier}``) model what the two
fabrics would carry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """A partition of the dp workers into slices plus the cross-slice
    cadence K.  Immutable and validated at construction."""

    num_workers: int
    slices: Tuple[Tuple[int, ...], ...]
    cross_slice_every: int = 1

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers={self.num_workers} < 1")
        if self.cross_slice_every < 1:
            raise ValueError(f"cross_slice_every={self.cross_slice_every} < 1")
        seen = [w for s in self.slices for w in s]
        if sorted(seen) != list(range(self.num_workers)):
            raise ValueError("slices must partition workers 0..%d exactly "
                             "(got %r)" % (self.num_workers - 1, self.slices))
        if any(len(s) == 0 for s in self.slices):
            raise ValueError("empty slice in %r" % (self.slices,))

    @classmethod
    def flat(cls, num_workers: int) -> "HierarchySpec":
        """One slice holding every worker (bit-identical to no spec)."""
        return cls(num_workers, (tuple(range(num_workers)),), 1)

    @classmethod
    def grouped(cls, num_workers: int, num_slices: int,
                cross_slice_every: int = 1) -> "HierarchySpec":
        """Contiguous near-equal grouping: workers [0..n) split into
        ``num_slices`` blocks."""
        num_slices = max(1, min(int(num_slices), num_workers))
        bounds = [round(i * num_workers / num_slices)
                  for i in range(num_slices + 1)]
        slices = tuple(tuple(range(bounds[i], bounds[i + 1]))
                       for i in range(num_slices))
        return cls(num_workers, slices, cross_slice_every)

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    def is_flat(self) -> bool:
        """One slice, or a cross-slice average every round."""
        return self.num_slices <= 1 or self.cross_slice_every <= 1

    def is_cross_round(self, r: int) -> bool:
        """Whether absolute round ``r`` runs the global average."""
        return self.is_flat() or ((r + 1) % self.cross_slice_every) == 0

    def slice_of(self, worker: int) -> int:
        for i, s in enumerate(self.slices):
            if worker in s:
                return i
        raise ValueError(f"worker {worker} not in any slice")

    def slice_ids(self) -> Tuple[int, ...]:
        """Per-worker slice index, worker-ordered."""
        out = [0] * self.num_workers
        for i, s in enumerate(self.slices):
            for w in s:
                out[w] = i
        return tuple(out)


def add_cli_args(parser) -> None:
    """``--slices`` / ``--cross_slice_every`` / ``--rejoin_after`` /
    ``--stale_bound`` / ``--stale_discount`` / ``--elastic``, the JAX
    parser's flags."""
    parser.add_argument(
        "--slices", type=int, default=1,
        help="group the dp workers into N contiguous slices for two-tier "
        "averaging: within-slice averaging every round, cross-slice every "
        "--cross_slice_every rounds.  1 = flat (bit-identical)",
    )
    parser.add_argument(
        "--cross_slice_every", type=int, default=1,
        help="K: run the cross-slice (global) average every K-th round; "
        "intra-slice rounds in between.  1 = every round global",
    )
    parser.add_argument(
        "--rejoin_after", type=int, default=2,
        help="--elastic: request a departed slice's rejoin N round "
        "boundaries after its leave completes (0 = rejoin only on "
        "external events)",
    )
    parser.add_argument(
        "--stale_bound", type=int, default=0,
        help="bounded-staleness averaging (parallel/stale.py): workers "
        "run ahead up to B rounds and each boundary averages whoever "
        "arrived, weighted by --stale_discount ** lag; a live worker at "
        "lag B is forced in.  0 = the synchronous round (bit-identical)",
    )
    parser.add_argument(
        "--stale_discount", type=float, default=0.5,
        help="per-round staleness weight decay for --stale_bound > 0",
    )
    parser.add_argument(
        "--elastic", action="store_true",
        help="arm the elastic membership controller (runtime/membership.py): "
        "epoch-numbered roster views drive the round's live mask, a SIGTERM "
        "marks this process's slice leaving at the next round boundary, and "
        "a departed slice rejoins at a later view epoch",
    )


def spec_from_args(args, num_workers: int) -> Optional[HierarchySpec]:
    """The spec the CLI flags describe, or None for the flat default."""
    slices = int(getattr(args, "slices", 1) or 1)
    every = int(getattr(args, "cross_slice_every", 1) or 1)
    if slices <= 1 and every <= 1 and not getattr(args, "elastic", False):
        return None
    return HierarchySpec.grouped(num_workers, max(1, slices), max(1, every))


def stale_kwargs_from_args(args) -> dict:
    """``BoundedStalenessTrainer`` kwargs from the CLI flags, or an empty
    dict when ``--stale_bound`` stays at the synchronous 0."""
    bound = int(getattr(args, "stale_bound", 0) or 0)
    if bound <= 0:
        return {}
    return {"stale_bound": bound,
            "discount": float(getattr(args, "stale_discount", 0.5) or 0.5)}


def averaging_trainer_from_args(args, solver, num_workers: int, **extra):
    """The round-averaging trainer the CLI flags describe: the
    ``ParameterAveragingTrainer``, or with ``--stale_bound > 0`` the
    ``BoundedStalenessTrainer`` around it (the same round surface; it
    refuses compress/overlap).  The comm flags and the hierarchy are
    folded in from ``args``; ``extra`` overrides (pass ``hierarchy=spec``
    when the app built the spec already, and ``metrics``)."""
    from sparknet_tpu_torch.parallel.trainers import ParameterAveragingTrainer

    kw = {"compress": getattr(args, "compress", "none"),
          "overlap_avg": bool(getattr(args, "overlap_avg", False))}
    kw.update(extra)
    kw.setdefault("hierarchy", spec_from_args(args, num_workers))
    stale = stale_kwargs_from_args(args)
    if stale:
        from sparknet_tpu_torch.parallel.stale import BoundedStalenessTrainer

        return BoundedStalenessTrainer(solver, num_workers, **kw, **stale)
    return ParameterAveragingTrainer(solver, num_workers, **kw)
