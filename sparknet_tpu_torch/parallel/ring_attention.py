"""Ring attention: sequence parallelism over the shards of a sequence.

The port of ``sparknet_tpu/parallel/ring_attention.py``.  A sequence of
T positions is cut into ``n`` equal shards; query shard ``i`` meets KV
shard ``(i - s) mod n`` at ring step ``s`` and accumulates its
attention with the online-softmax recurrence, so attention over the
whole sequence costs ``n`` ring steps of (T/n)-long partials.  Two
transports share one merge code:

- **stacked** (``ring`` an int): the ``n`` shards of one worker live on
  one device, and step ``s`` reads the KV shard by index — a view, no
  copy.  This is what ``TransformerLM(sp_size=n)`` trains with.
- **process group** (``ring`` a ``torch.distributed`` group): each rank
  holds a block of consecutive shards (one, or the several its mesh
  coordinates on the axis cover) and KV rotates one block a step with
  ``batch_isend_irecv``, inside an autograd function whose backward
  shifts the cotangent the other way (the transpose of JAX's
  ``ppermute``).  Under gloo a CUDA shard crosses through host copies
  (``parallel/mesh.py``).

With ``use_flash`` (the default) each step's partial attention is
``cuda_attention.flash_attention_step`` at absolute offsets ``q_offset =
i * T_q``, ``k_offset = src * T_k`` — K1 forward, K3/K4 backward on
CUDA tensors, their plain versions on CPU tensors — and the partials
merge through ``_merge_partials``, whose backward hands K3 and K4 a
nonzero ``dlse``.  ``use_flash=False`` runs the JAX package's dense
``accumulate`` recurrence.  Fully masked ``(shard, step)`` pairs (a
causal ring's KV shards after the query shard: ``n (n - 1) / 2`` of
them) are computed, not skipped, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple, Union

import torch
import torch.distributed as dist


def _merge_partials(o1, lse1, o2, lse2):
    """Online-softmax combine of two partial attentions over disjoint
    key sets: ``(o (B, H, T, D), lse (B, H, T))`` each normalized within
    its own keys, lse the row logsumexp (``-inf``: no visible keys).
    Every ``-inf``/0 leg is guarded, so no NaN reaches the value or the
    cotangent."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    w1 = torch.exp(lse1 - m_safe)  # exp(-inf) = 0: an absent side drops out
    w2 = torch.exp(lse2 - m_safe)
    den = w1 + w2
    den_safe = torch.clamp_min(den, 1e-30)
    o = (w1[..., None] * o1 + w2[..., None] * o2) / den_safe[..., None]
    lse = torch.where(den > 0, m_safe + torch.log(den_safe),
                      torch.full_like(den, float("-inf")))
    return o, lse


def masked_pairs(n: int, causal: bool) -> List[Tuple[int, int]]:
    """The ``(query shard, ring step)`` pairs whose KV shard lies wholly
    after the query shard: every key masked under ``causal``."""
    if not causal:
        return []
    return [(i, s) for i in range(n) for s in range(n) if (i - s) % n > i]


class _Accumulator:
    """One query shard's running attention over the ring's steps: the
    flash partials merged by ``_merge_partials``, or the dense
    recurrence's ``(acc, m, l)``."""

    def __init__(self, q, idx: int, causal: bool, use_flash: bool):
        b, tq, h, d = q.shape
        self.q, self.idx, self.causal, self.flash = q, idx, causal, use_flash
        self.tq = tq
        self.scale = 1.0 / math.sqrt(d)
        if use_flash:
            self.o = q.new_zeros((b, h, tq, d), dtype=torch.float32)
            self.lse = q.new_full((b, h, tq), float("-inf"),
                                  dtype=torch.float32)
        else:
            self.acc = q.new_zeros((b, h, tq, d))
            self.m = q.new_full((b, h, tq), float("-inf"))
            self.l = q.new_zeros((b, h, tq))
            self.q_pos = idx * tq + torch.arange(tq, device=q.device)

    def add(self, k, v, src: int) -> None:
        tk = k.shape[1]
        if self.flash:
            from sparknet_tpu_torch.ops import cuda_attention

            o_s, lse_s = cuda_attention.flash_attention_step(
                self.q, k, v, q_offset=self.idx * self.tq,
                k_offset=src * tk, causal=self.causal)
            self.o, self.lse = _merge_partials(
                self.o, self.lse, o_s.to(torch.float32), lse_s)
            return
        s = torch.einsum("bqhd,bkhd->bhqk", self.q, k) * self.scale
        if self.causal:
            k_pos = src * tk + torch.arange(tk, device=k.device)
            s = s.masked_fill(k_pos[None, :] > self.q_pos[:, None],
                              float("-inf"))
        m_new = torch.maximum(self.m, s.amax(dim=-1))
        alpha = torch.exp(torch.where(self.m == float("-inf"),
                                      torch.zeros_like(self.m),
                                      self.m - m_new))
        # a fully masked row so far: subtract 0, so exp(-inf) = 0 with
        # no NaN in the value or the cotangent
        m_sub = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                            m_new)
        p = torch.exp(s - m_sub[..., None])
        self.l = self.l * alpha + p.sum(dim=-1)
        self.acc = self.acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v)
        self.m = m_new

    def result(self):
        """The shard's output, (B, T_q, H, D)."""
        if self.flash:
            return self.o.permute(0, 2, 1, 3).to(self.q.dtype)
        out = self.acc / torch.clamp_min(self.l[..., None], 1e-30)
        return out.permute(0, 2, 1, 3)


def _stacked_ring(q, k, v, n: int, causal: bool, use_flash: bool):
    """The ``n`` shards of (B, T, H, D) tensors on one device."""
    t = q.shape[1]
    tq = t // n
    qs = [q[:, i * tq:(i + 1) * tq] for i in range(n)]
    ks = [k[:, i * tq:(i + 1) * tq] for i in range(n)]
    vs = [v[:, i * tq:(i + 1) * tq] for i in range(n)]
    outs = []
    for i in range(n):
        acc = _Accumulator(qs[i], i, causal, use_flash)
        for s in range(n):
            src = (i - s) % n
            acc.add(ks[src], vs[src], src)
        outs.append(acc.result())
    return torch.cat(outs, dim=1)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead in ``group`` and return
    what the rank ``step`` behind sent; host-staged under gloo when
    ``x`` is on a card."""
    from sparknet_tpu_torch.parallel import mesh as _mesh

    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    staged = x.is_cuda and _mesh.group_backend(group) == "gloo"
    src = _mesh._to_host(x) if staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [
        dist.P2POp(dist.isend, src,
                   dist.get_global_rank(group, (me + step) % n), group),
        dist.P2POp(dist.irecv, out,
                   dist.get_global_rank(group, (me - step) % n), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _mesh._to_device(out, x.device) if staged else out


class _RingShift(torch.autograd.Function):
    """One hop of the ring: the forward passes a shard one rank ahead,
    the backward passes its cotangent one rank back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


def _process_ring(q, k, v, group, causal: bool, use_flash: bool,
                  local_shards: int = 1):
    """This rank's block of ``local_shards`` consecutive shards (B,
    local_shards * T_s, H, D), the ``idx``-th block of the group; KV
    rotates around ``group`` a block at a time, and each local query
    shard meets every shard of the block it holds."""
    p = dist.get_world_size(group)
    idx = dist.get_rank(group)
    m = local_shards
    ts = q.shape[1] // m
    accs = [_Accumulator(q[:, j * ts:(j + 1) * ts], idx * m + j, causal,
                         use_flash) for j in range(m)]
    k_cur, v_cur = k, v
    for s in range(p):
        src = (idx - s) % p
        for acc in accs:
            for j in range(m):
                acc.add(k_cur[:, j * ts:(j + 1) * ts],
                        v_cur[:, j * ts:(j + 1) * ts], src * m + j)
        if s < p - 1:  # the last exchange would be discarded
            k_cur = _RingShift.apply(k_cur, group)
            v_cur = _RingShift.apply(v_cur, group)
    outs = [acc.result() for acc in accs]
    return outs[0] if m == 1 else torch.cat(outs, dim=1)


def ring_attention(q, k, v, ring: Union[int, object], causal: bool = False,
                   use_flash=None, local_shards: int = 1):
    """Attention over a ring of sequence shards.

    ``ring`` an int ``n``: q/k/v are the whole (B, T, H, D) tensors of
    one worker, cut into ``n`` shards on their device (T divisible by
    ``n``); returns (B, T, H, D).  ``ring`` a process group: q/k/v are
    this rank's shards (B, T/n, H, D), the rank's place in the group
    being its shard index; returns its output shard.  ``use_flash``
    None or True runs each step through ``flash_attention_step``;
    False runs the dense recurrence."""
    use_flash = True if use_flash is None else bool(use_flash)
    if isinstance(ring, int):
        if ring < 1 or q.shape[1] % ring:
            raise ValueError(
                f"ring_attention: T={q.shape[1]} does not cut into {ring} "
                "equal shards"
            )
        return _stacked_ring(q, k, v, ring, causal, use_flash)
    if local_shards < 1 or q.shape[1] % local_shards:
        raise ValueError(
            f"ring_attention: a block of T={q.shape[1]} does not cut into "
            f"{local_shards} equal shards"
        )
    return _process_ring(q, k, v, ring, causal, use_flash, local_shards)


def ring_self_attention(mesh, axis: str = "sp", causal: bool = False,
                        use_flash=None) -> Callable:
    """``fn(q, k, v)`` over (B, T, H, D) tensors with T cut over the
    mesh axis ``axis``; the mesh-level entry point.  When the axis stays
    inside this process the ring is stacked and ``fn`` returns the whole
    (B, T, H, D) output.  When it crosses processes every rank passes
    the same whole tensors, takes the shards of its coordinates on the
    axis (``mesh.coords[axis]``, one or more consecutive ones) and gets
    back their output rows (B, T * m / n, H, D) for its ``m``
    coordinates; gradients reach only those rows of q and, through the
    ring, k and v.  A T that does not divide over the axis is refused
    up front, and so is a layout whose processes hold unequal or
    out-of-order blocks of the axis."""
    n = mesh.shape[axis]
    group = mesh.group(axis) if mesh.process_count > 1 else None
    mine = mesh.coords[axis]
    m = mine.stop - mine.start  # the consecutive shards this rank holds
    if group is not None and (
            dist.get_world_size(group) * m != n
            or mine.start != dist.get_rank(group) * m):
        raise ValueError(
            f"ring_self_attention: process {mesh.process_index} holds "
            f"coordinates {mine.start}..{mine.stop - 1} of the {n}-way "
            f"{axis!r} axis, which do not lay out as equal consecutive "
            f"blocks over its {dist.get_world_size(group)}-process group"
        )

    def fn(q, k, v):
        for name, arr in (("q", q), ("k", k), ("v", v)):
            if arr.dim() != 4:
                raise ValueError(
                    f"ring_self_attention: {name} must be (B, T, H, D), "
                    f"got shape {tuple(arr.shape)}"
                )
            if arr.shape[1] % n:
                raise ValueError(
                    f"ring_self_attention: {name} has T={arr.shape[1]} "
                    f"which does not divide over the {n}-way {axis!r} "
                    "ring — pad the sequence or pick T a multiple of "
                    f"{n}"
                )
        if group is None:
            return ring_attention(q, k, v, n, causal=causal,
                                  use_flash=use_flash)
        ts = q.shape[1] // n
        sl = slice(mine.start * ts, mine.stop * ts)
        return ring_attention(q[:, sl], k[:, sl], v[:, sl], group,
                              causal=causal, use_flash=use_flash,
                              local_shards=m)

    return fn


def ring_hop_bytes(batch: int, local_seq: int, dim: int, sp: int,
                   depth: int) -> int:
    """Modeled ring-exchange bytes of ONE forward+backward iteration
    (the JAX package's ``ring_hop_bytes_per_iter``): each of ``sp``
    shards passes its K and V (B x T_local x E float32) ``sp - 1``
    times a layer, and the backward mirrors the forward.  0 at sp=1."""
    if sp <= 1:
        return 0
    shard_bytes = batch * local_seq * dim * 4
    hops = (sp - 1) * sp
    return 2 * 2 * shard_bytes * hops * depth
