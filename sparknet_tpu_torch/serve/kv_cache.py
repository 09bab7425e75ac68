"""Paged KV cache: fixed-size blocks in a preallocated device arena.

The port of ``sparknet_tpu/serve/kv_cache.py``.  The K and V arenas are
allocated ONCE at engine build as device tensors of shape
``(layers, (num_blocks+1) * block_size, heads, head_dim)`` float32 —
flat over positions, so a per-sequence block table maps logical
position j to arena row ``table[j // block_size] * block_size + j %
block_size`` — and every sequence borrows whole blocks from a
host-side free list.

Admission control: a stream reserves its WORST-CASE block count at
submit time, so "out of KV memory" is a synchronous
``KVBudgetExceeded`` — a ``QueueFull``, i.e. HTTP 429 — never a
mid-stream failure, and ``allocated_total == freed_total`` whenever the
engine is drained.

Block 0 is the TRASH block: it is never handed to a sequence, and every
inactive decode slot's index row points at it, so the fixed-shape decode
step's scatter lands somewhere harmless.  The
``sparknet_kv_blocks_{used,total}`` gauges count allocatable blocks only.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np
import torch

from sparknet_tpu_torch.obs.metrics import MetricsRegistry
from sparknet_tpu_torch.serve.batcher import QueueFull
from sparknet_tpu_torch.utils.devices import resolve_device


class KVBudgetExceeded(QueueFull):
    """No free KV blocks for this stream's worst case — shed (429)."""


class KVBlockPool:
    """The device arena + host-side block allocator for one engine.

    ``layers``, ``heads``, ``head_dim``: the serving model's KV geometry.
    ``num_blocks``: ALLOCATABLE blocks (the trash block is extra).
    ``block_size``: positions per block.  ``device``: where the arena
    lives (``None`` is ``cuda``; the CPU must be asked for).  The
    ``sparknet_kv_*`` series register on the pool's own ``metrics``.
    """

    def __init__(
        self,
        layers: int,
        heads: int,
        head_dim: int,
        num_blocks: int = 64,
        block_size: int = 16,
        device=None,
    ):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need >= 1 block of >= 1 positions, got "
                f"{num_blocks} x {block_size}"
            )
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # +1: block 0 is the trash block (inactive-slot scatter target)
        self.arena_rows = (self.num_blocks + 1) * self.block_size
        shape = (self.layers, self.arena_rows, self.heads, self.head_dim)
        device = resolve_device(device)
        self.k = torch.zeros(shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(shape, dtype=torch.float32, device=device)

        self._lock = threading.Lock()
        self._free: List[int] = list(range(1, self.num_blocks + 1))
        self.allocated_total = 0
        self.freed_total = 0

        # the server shares this registry, so one /metrics payload
        # carries the stream series and the arena gauges
        self.metrics = MetricsRegistry()
        m = self.metrics
        m.gauge(
            "sparknet_kv_blocks_total",
            "allocatable KV-cache blocks in the device arena",
            fn=lambda: self.num_blocks,
        )
        m.gauge(
            "sparknet_kv_blocks_used",
            "KV-cache blocks currently reserved by live streams",
            fn=lambda: self.used(),
        )
        self.m_alloc = m.counter(
            "sparknet_kv_alloc_total",
            "KV-cache blocks reserved over the pool's lifetime",
        )
        self.m_free = m.counter(
            "sparknet_kv_free_total",
            "KV-cache blocks released over the pool's lifetime",
        )

    # ------------------------------------------------------------------
    def blocks_for(self, positions: int) -> int:
        """Blocks covering ``positions`` cached positions (ceil)."""
        return max(1, -(-int(positions) // self.block_size))

    def used(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Reserve ``n`` blocks or raise ``KVBudgetExceeded`` — all or
        nothing, so a partially-admitted stream never strands blocks."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                raise KVBudgetExceeded(
                    f"KV arena out of blocks: need {n}, "
                    f"{len(self._free)}/{self.num_blocks} free"
                )
            taken, self._free = self._free[:n], self._free[n:]
            self.allocated_total += n
        self.m_alloc.inc(n)
        return taken

    def free(self, blocks: List[int]) -> None:
        if not blocks:
            return
        with self._lock:
            for b in blocks:
                if b == 0 or b in self._free:
                    raise ValueError(f"double free / trash free: block {b}")
                self._free.append(b)
            self.freed_total += len(blocks)
        self.m_free.inc(len(blocks))

    # ------------------------------------------------------------------
    def index_row(self, blocks: List[int], row_len: int) -> np.ndarray:
        """Logical position -> arena row for one sequence: position j
        lives at ``blocks[j // bs] * bs + j % bs``; positions past the
        reservation point at the trash block (never read — lengths mask
        them — and never written — reservation is worst-case)."""
        bs = self.block_size
        row = np.zeros((row_len,), np.int64)
        cover = min(row_len, len(blocks) * bs)
        j = np.arange(cover)
        row[:cover] = np.asarray(blocks, np.int64)[j // bs] * bs + j % bs
        return row

    @property
    def oob_row(self) -> int:
        """An out-of-bounds arena row: prefill marks pad positions with
        it, and the engine drops those rows before the scatter."""
        return self.arena_rows
