"""The data-parallel context: this rank's rows of one global batch.

The JAX package's ``AllReduceTrainer`` jits one step over a mesh with
the batch sharded on its dp axis, so GSPMD computes the step of the
*global* batch: BatchNorm's moments come from every row, a dropout mask
or a crop is drawn for every row, and a loss divides by the global
count.  A rank-local forward followed by a sum of gradients computes
something else.  Here each rank runs the forward on its own rows, and
the layers that reduce over the batch (or draw for it) read the active
``BatchShard`` and make the global quantity:

- ``BatchNorm`` (train): the per-channel ``sum(x)``, ``sum(x*x)`` and
  the row count cross the group, and its backward's ``sum(dy)`` and
  ``sum(dy * x_hat)`` too (``ops/common.py``);
- ``Dropout`` and the train transform's crop and mirror: the draw is
  made for the global batch from the same key on every rank, and this
  rank keeps its rows (a CPU generator cannot skip ahead);
- the loss layers: each normalizer counts the global batch (``VALID``'s
  count crosses the group), so each rank's loss is its own rows' share
  of the global loss; ``Accuracy`` in TRAIN reports the global value;
- ``Reshape``/``DummyData``: a declared batch is the global one.

The Solver activates its ``batch_shard`` around each micro-batch's
transform and forward (``solver.py``); outside it ``current()`` is
None and every layer computes as in one process.  The rows of rank
``index`` are the ``index``-th of ``size`` equal blocks, in rank order,
as the JAX mesh shards the batch over its devices.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "sparknet_batch_shard", default=None)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rank ``index`` of ``size`` holds the ``index``-th equal block of
    the global batch's rows; ``group`` is the ``torch.distributed``
    group the batch spans."""

    group: object
    size: int
    index: int

    def global_rows(self, n: int) -> int:
        """The global batch of a rank holding ``n`` rows."""
        return int(n) * self.size

    def rows(self, n: int) -> slice:
        """This rank's rows of the global batch, ``n`` a rank."""
        return slice(self.index * int(n), (self.index + 1) * int(n))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group (a new tensor; the same bits on
        every rank)."""
        from sparknet_tpu_torch.parallel import mesh

        return mesh.all_reduce_sum(t.clone(), self.group)

    def draw(self, local_shape, draw) -> torch.Tensor:
        """``draw(global shape)`` cut to this rank's rows: a draw made for
        the whole batch from the same key on every rank."""
        n = int(local_shape[0])
        full = draw((self.global_rows(n),) + tuple(local_shape[1:]))
        return full[self.rows(n)]


def current() -> Optional[BatchShard]:
    """The active shard, None outside a data-parallel step."""
    return _CURRENT.get()


@contextlib.contextmanager
def active(shard: Optional[BatchShard]):
    """Make ``shard`` (None: no shard) the active one for the block."""
    token = _CURRENT.set(shard)
    try:
        yield shard
    finally:
        _CURRENT.reset(token)
