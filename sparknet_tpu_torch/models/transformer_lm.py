"""Decoder-only transformer LM: the serving module and the training net.

The port of ``sparknet_tpu/models/transformer_lm.py``: a byte-level,
pre-norm, decoder-only transformer with the JAX package's layout —
(B, T, H, D) activations, ``x @ w`` weights of shape (in, out),
LayerNorm with eps 1e-5 and biased variance, the tanh-approximated
GELU (``jax.nn.gelu``'s default), and ``tok[tokens] + pos[:T]``
embeddings.  ``blob_plan`` keeps the JAX package's group order and
shapes; ``interop.py`` maps one layout onto the other.

Two views of one model, sharing the plan, the seeded init and the
causal forward body (``causal_forward``):

- ``TransformerLM``, an ``nn.Module`` for serving: ``init(seed)``
  returns the module, ``prefill_with_kv`` / ``decode_step_paged``
  serve ``cli serve --generate`` (``decode_step_with_kv``, over a
  gathered context, is the JAX model's counterpart);
- ``TransformerLMNet``, the Solver "net protocol" of the JAX LM
  (``init(seed, device) -> (params, stats)``, ``loss_fn``,
  ``param_multipliers``, ``feed_blobs``) over a ``{group: [blob]}``
  params dict, which the solver and the averaging trainer train.

Attention runs through ``ops.cuda_attention``: the flash kernels (K1
forward, K3/K4 backward) for prefill and every training step, the
decode kernel (K2) for one new position, over the paged arena or a
gathered context — on CUDA tensors; on CPU tensors
their plain versions.  ``attention="dense"`` trains with
``ops.attention.mha_reference`` instead.  ``TransformerLMNet(sp_size=n)``
trains through the sequence ring (``parallel/ring_attention.py``) stacked
on the worker's device: each layer's attention cuts the sequence into
``n`` shards and runs ``n^2`` partial steps at absolute offsets (K1
forward, K3/K4 backward with a nonzero ``dlse``; the dense recurrence
under ``attention="dense"``), the same function as sp=1 up to float
associativity.  ``sp_group`` puts the ring over a process group
instead: each rank holds one sequence shard (``local_seq`` positions,
offset by its rank in the group, as JAX's ``axis_index``), KV rotates
between the ranks, and the loss has a global value and a local
gradient (JAX ``transformer_lm.py:282-313``: the shard sums cross the
group detached, so each rank's grads are its share and the Solver's
``grad_groups`` sum them).  The serving module stays sp=1, as the JAX
model's generation seams do.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparknet_tpu_torch.ops import cuda_attention
from sparknet_tpu_torch.ops.attention import mha_reference
from sparknet_tpu_torch.utils import jax_prng

VOCAB = 256  # byte-level: the tokenizer IS the identity over bytes

Plan = List[Tuple[str, List[Tuple[int, ...]]]]
Params = Dict[str, List[torch.Tensor]]


def _layer_norm(x, g, b, eps: float = 1e-5):
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _check_geometry(dim: int, heads: int, sp_size: int, seq_len: int) -> None:
    if dim % heads:
        raise ValueError(f"dim={dim} not divisible by heads={heads}")
    if sp_size < 1:
        raise ValueError(f"sp_size must be >= 1, got {sp_size}")
    if seq_len % sp_size:
        raise ValueError(
            f"seq_len={seq_len} not divisible by sp={sp_size} — the "
            "ring shards the sequence evenly (pad or pick a multiple)"
        )


def blob_plan(vocab: int, dim: int, depth: int, seq_len: int,
              mlp_ratio: int) -> Plan:
    """(group_name, [blob shapes]) in the JAX package's init order."""
    V, E, T = vocab, dim, seq_len
    M = E * mlp_ratio
    plan: Plan = [("embed", [(V, E), (T, E)])]
    for i in range(depth):
        plan.append((f"block{i}_ln1", [(E,), (E,)]))
        plan.append((f"block{i}_attn", [(E, E), (E, E), (E, E), (E, E)]))
        plan.append((f"block{i}_ln2", [(E,), (E,)]))
        plan.append((f"block{i}_mlp", [(E, M), (M,), (M, E), (E,)]))
    plan.append(("ln_f", [(E,), (E,)]))
    plan.append(("head", [(E, V)]))
    return plan


class _Ref:
    """Checkpoint blob reference (``io/caffemodel.py`` protocol): every
    blob of the LM is a learnable param owned by its own group."""

    __slots__ = ("collection", "owner", "index")

    def __init__(self, owner: str, index: int):
        self.collection = "params"
        self.owner = owner
        self.index = index


class _Group:
    """Layer stand-in for the checkpoint walkers (they read ``.name``)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def checkpoint_protocol(plan: Plan):
    """``(layers, _blob_refs)`` of the JAX LM's checkpoint interface: one
    group per param-dict key, blobs in plan order — what
    ``io/caffemodel.net_blobs`` / ``apply_blobs`` walk, so an LM
    ``.caffemodel`` holds one layer per group, as the JAX LM's does."""
    return ([_Group(g) for g, _ in plan],
            {g: [_Ref(g, i) for i in range(len(shapes))] for g, shapes in plan})


def init_params(plan: Plan, depth: int, seed: int = 0) -> Params:
    """Seeded weights with the JAX package's recipe and key tree
    (``TransformerLM.init``): normal(0, 0.02) matrices drawn from
    ``fold_in(fold_in(PRNGKey(seed), group), blob)``, the residual-branch
    output projections (``wo``, ``w2``) scaled by ``1/sqrt(2*depth)``
    (the GPT-2 init), LayerNorm gains 1 and every bias 0.  The draws run
    on the host (``utils/jax_prng.py``), so the weights are the same on
    every device and the JAX package's within a few ulp."""
    std = 0.02
    res_std = std / math.sqrt(max(1, 2 * depth))
    key = jax_prng.prng_key(seed)
    params: Params = {}
    for gi, (group, shapes) in enumerate(plan):
        gkey = jax_prng.fold_in(key, gi)
        is_ln = group.endswith(("ln1", "ln2")) or group == "ln_f"
        blobs = []
        for bi, shape in enumerate(shapes):
            if len(shape) == 1:
                blobs.append(torch.full(shape, 1.0 if is_ln and bi == 0 else 0.0))
                continue
            s = std
            if (group.endswith("_attn") and bi == 3) or (
                group.endswith("_mlp") and bi == 2
            ):
                s = res_std
            drawn = jax_prng.normal(jax_prng.fold_in(gkey, bi), shape)
            blobs.append(torch.from_numpy(np.float32(s) * drawn))
        params[group] = blobs
    return params


def _count(plan: Plan) -> int:
    return int(sum(int(np.prod(s)) for _, shapes in plan for s in shapes))


def multipliers(plan: Plan):
    """All groups learn at lr_mult 1; weight decay applies to the 2-D
    matrices only (LayerNorm gains/biases and biases are decay-free)."""
    lr: Dict[str, List[float]] = {}
    decay: Dict[str, List[float]] = {}
    for group, shapes in plan:
        lr[group] = [1.0] * len(shapes)
        decay[group] = [1.0 if len(s) > 1 else 0.0 for s in shapes]
    return lr, decay


def causal_forward(params: Params, tokens, heads: int, attend,
                   keep_kv: bool = False, pos_offset: int = 0):
    """The causal forward over a ``{group: [blob]}`` params dict — the
    one body of both views.  ``tokens`` (B, T) int64 at positions
    ``pos_offset .. pos_offset + T - 1`` of the position table;
    ``attend(q, k, v)`` is one layer's causal attention on (B, T, H, D).
    Returns ``(logits (B, T, V), [k], [v])``, the per-layer K/V lists
    filled only with ``keep_kv``."""
    B, T = tokens.shape
    tok, pos = params["embed"]
    E = tok.shape[1]
    D = E // heads
    x = (tok[tokens] + pos[pos_offset + torch.arange(
        T, device=tokens.device)]).float()
    ks, vs = [], []
    i = 0
    while f"block{i}_attn" in params:
        g1, b1 = params[f"block{i}_ln1"]
        wq, wk, wv, wo = params[f"block{i}_attn"]
        h = _layer_norm(x, g1, b1)
        q, k, v = ((h @ w).reshape(B, T, heads, D) for w in (wq, wk, wv))
        if keep_kv:
            ks.append(k)
            vs.append(v)
        x = x + attend(q, k, v).reshape(B, T, E) @ wo
        g2, b2 = params[f"block{i}_ln2"]
        w1, c1, w2, c2 = params[f"block{i}_mlp"]
        x = x + (_gelu(_layer_norm(x, g2, b2) @ w1 + c1) @ w2 + c2)
        i += 1
    gf, bf = params["ln_f"]
    (wh,) = params["head"]
    return _layer_norm(x, gf, bf) @ wh, ks, vs


def _flash_causal(q, k, v):
    return cuda_attention.flash_attention(q, k, v, causal=True)


def _dense_causal(q, k, v):
    return mha_reference(q, k, v, causal=True)


def _ring_causal(ring, use_flash: bool):
    """One layer's causal attention through the sequence ring: stacked
    (``ring`` the shard count) or over a process group (``ring`` the
    group, this rank holding one shard)."""
    from sparknet_tpu_torch.parallel.ring_attention import ring_attention

    def attend(q, k, v):
        return ring_attention(q, k, v, ring, causal=True, use_flash=use_flash)

    return attend


class _LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return _layer_norm(x, self.weight, self.bias)


class _Attention(nn.Module):
    """The four projections of one block, each (E, E)."""

    def __init__(self, dim: int):
        super().__init__()
        self.wq = nn.Parameter(torch.zeros(dim, dim))
        self.wk = nn.Parameter(torch.zeros(dim, dim))
        self.wv = nn.Parameter(torch.zeros(dim, dim))
        self.wo = nn.Parameter(torch.zeros(dim, dim))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(torch.zeros(hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return _gelu(x @ self.w1 + self.b1) @ self.w2 + self.b2


class _Block(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.ln1 = _LayerNorm(dim)
        self.attn = _Attention(dim)
        self.ln2 = _LayerNorm(dim)
        self.mlp = _MLP(dim, hidden)


class TransformerLM(nn.Module):
    """Small decoder-only LM: embedding + N pre-norm blocks + an untied
    head, held as named submodules for serving.  ``init(seed)`` draws
    the seeded weights (``init_params``); the module is built on the CPU
    and moved with ``.to(device)``."""

    def __init__(
        self,
        vocab: int = VOCAB,
        dim: int = 64,
        depth: int = 2,
        heads: int = 2,
        seq_len: int = 128,
        mlp_ratio: int = 4,
        sp_size: int = 1,
    ):
        super().__init__()
        _check_geometry(dim, heads, sp_size, seq_len)
        if sp_size != 1:
            raise ValueError("generation serves the sp=1 dense model only "
                             "(the ring is a training-time construct)")
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.depth = int(depth)
        self.heads = int(heads)
        self.head_dim = self.dim // self.heads
        self.seq_len = int(seq_len)
        self.mlp_ratio = int(mlp_ratio)
        self.sp_size = 1
        E, M = self.dim, self.dim * self.mlp_ratio
        self.tok_embed = nn.Parameter(torch.zeros(self.vocab, E))
        self.pos_embed = nn.Parameter(torch.zeros(self.seq_len, E))
        self.blocks = nn.ModuleList(
            [_Block(E, M) for _ in range(self.depth)]
        )
        self.ln_f = _LayerNorm(E)
        self.head = nn.Parameter(torch.zeros(E, self.vocab))
        self._group_blobs = self._blob_plan()
        self.layers, self._blob_refs = checkpoint_protocol(self._group_blobs)

    # ------------------------------------------------------------------
    def _blob_plan(self) -> Plan:
        """(group_name, [blob shapes]) in the JAX package's init order."""
        return blob_plan(self.vocab, self.dim, self.depth, self.seq_len,
                         self.mlp_ratio)

    def group_params(self) -> Dict[str, List[nn.Parameter]]:
        """The parameters of each ``_blob_plan`` group, in plan order."""
        groups: Dict[str, List[nn.Parameter]] = {
            "embed": [self.tok_embed, self.pos_embed],
        }
        for i, blk in enumerate(self.blocks):
            groups[f"block{i}_ln1"] = [blk.ln1.weight, blk.ln1.bias]
            a = blk.attn
            groups[f"block{i}_attn"] = [a.wq, a.wk, a.wv, a.wo]
            groups[f"block{i}_ln2"] = [blk.ln2.weight, blk.ln2.bias]
            m = blk.mlp
            groups[f"block{i}_mlp"] = [m.w1, m.b1, m.w2, m.b2]
        groups["ln_f"] = [self.ln_f.weight, self.ln_f.bias]
        groups["head"] = [self.head]
        return groups

    @torch.no_grad()
    def init(self, seed: int = 0) -> "TransformerLM":
        """Fill the parameters with ``init_params(seed)``; returns the
        module (the training net's ``init`` draws the same weights)."""
        drawn = init_params(self._group_blobs, self.depth, seed)
        for group, params in self.group_params().items():
            for p, w in zip(params, drawn[group]):
                p.copy_(w)
        return self

    def param_multipliers(self):
        """lr_mult 1 everywhere; decay on the 2-D matrices only."""
        return multipliers(self._group_blobs)

    def num_params(self) -> int:
        return _count(self._group_blobs)

    # ------------------------------------------------------------------
    def _qkv(self, blk: _Block, h):
        B, T = h.shape[0], h.shape[1]
        H, D = self.heads, self.head_dim
        a = blk.attn
        return (
            (h @ a.wq).reshape(B, T, H, D),
            (h @ a.wk).reshape(B, T, H, D),
            (h @ a.wv).reshape(B, T, H, D),
        )

    def _embed(self, tokens, positions):
        return (self.tok_embed[tokens] + self.pos_embed[positions]).float()

    def _causal_forward(self, tokens, keep_kv: bool):
        return causal_forward(self.group_params(), tokens.long(), self.heads,
                              _flash_causal, keep_kv)

    @torch.no_grad()
    def forward_logits(self, tokens):
        """(B, seq_len) int tokens -> (B, seq_len, vocab) f32 logits."""
        if tokens.shape[1] != self.seq_len:
            raise ValueError(
                f"tokens have T={tokens.shape[1]}, model expects "
                f"T={self.seq_len}"
            )
        return self._causal_forward(tokens, keep_kv=False)[0]

    def forward(self, tokens):
        return self.forward_logits(tokens)

    @torch.no_grad()
    def prefill_with_kv(self, tokens):
        """Causal prefill that also returns every layer's K/V.

        ``tokens`` is (B, T) with T <= seq_len (a prefill length
        bucket, pad rows at the END — causality keeps the valid prefix
        exact).  Returns ``(logits (B,T,V), k (depth,B,T,H,D), v)``."""
        if tokens.shape[1] > self.seq_len:
            raise ValueError(
                f"prefill T={tokens.shape[1]} exceeds seq_len={self.seq_len}"
            )
        logits, ks, vs = self._causal_forward(tokens, keep_kv=True)
        return logits, torch.stack(ks), torch.stack(vs)

    def _decode_layers(self, tokens, positions, attend):
        """The layer loop of one decode position per sequence, shared by
        both decode steps.  ``tokens`` and ``positions`` (B,) int64;
        ``attend(i, q, k1, v1)`` stores layer i's new k1/v1 (B, H, D)
        where its attention reads them and returns the attention of q
        (B, 1, H, D).  Returns the logits (B, V)."""
        B = tokens.shape[0]
        x = self._embed(tokens, positions)[:, None, :]
        for i, blk in enumerate(self.blocks):
            q, k1, v1 = self._qkv(blk, blk.ln1(x))
            out = attend(i, q, k1[:, 0], v1[:, 0])
            x = x + out.reshape(B, 1, self.dim) @ blk.attn.wo
            x = x + blk.mlp(blk.ln2(x))
        return (self.ln_f(x) @ self.head)[:, 0]

    @torch.no_grad()
    def decode_step_with_kv(self, tokens, positions, k_ctx, v_ctx):
        """One decode position per sequence against gathered KV context
        (the JAX model's ``decode_step_with_kv``).

        ``tokens`` (B,) — the token to embed at ``positions`` (B,) (the
        number of already-cached positions per sequence); ``k_ctx``/
        ``v_ctx`` (depth, B, S, H, D) — a gathered context, rows at
        index >= positions[b] are garbage and masked off.  This step's
        own K/V are written into ``k_ctx``/``v_ctx`` IN PLACE so
        attention sees them, and returned as ``new_k``/``new_v`` (depth,
        B, H, D).  Returns ``(logits (B,V), new_k, new_v)``."""
        tokens = tokens.long()
        positions = positions.long()
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        lengths = (positions + 1).to(torch.int32)
        new_ks, new_vs = [], []

        def attend(i, q, k1, v1):
            new_ks.append(k1)
            new_vs.append(v1)
            k_ctx[i, rows, positions] = k1
            v_ctx[i, rows, positions] = v1
            return cuda_attention.decode_attention(
                q, k_ctx[i], v_ctx[i], lengths=lengths
            )

        logits = self._decode_layers(tokens, positions, attend)
        return logits, torch.stack(new_ks), torch.stack(new_vs)

    @torch.no_grad()
    def decode_step_paged(self, tokens, positions, arena_k, arena_v,
                          block_table, write_rows, lengths,
                          block_size: int):
        """One decode position per sequence against the paged KV arena,
        read where it lives (the serving engine's decode step).

        ``tokens``/``positions`` (B,) as ``decode_step_with_kv``'s;
        ``arena_k``/``arena_v`` the pool's (depth, rows, H, Dp) arenas,
        Dp >= D; ``block_table`` (B, max_blocks) int32 and ``lengths``
        (B,) int32 (positions + 1) as ``paged_decode_attention`` takes
        them; ``write_rows`` (B,) the arena row of each sequence's
        position.  Each layer writes this step's K/V into the first D
        columns of its arena at ``write_rows`` IN PLACE, then attends
        through the table.  Returns the logits (B, V)."""
        d = self.head_dim

        def attend(i, q, k1, v1):
            arena_k[i, :, :, :d].index_put_((write_rows,), k1)
            arena_v[i, :, :, :d].index_put_((write_rows,), v1)
            return cuda_attention.paged_decode_attention(
                q, arena_k[i], arena_v[i], block_table, lengths, block_size
            )

        return self._decode_layers(tokens, positions, attend)


class TransformerLMNet:
    """The LM as a Solver "net" (JAX ``TransformerLM``'s protocol):
    ``init(seed, device) -> (params, stats)``, ``loss_fn``,
    ``param_multipliers``, ``feed_blobs``, over a ``{group: [blob]}``
    params dict in ``blob_plan`` order.

    ``attention``: ``"auto"`` and ``"flash"`` run the kernel wrappers
    (K1 forward, K3/K4 backward on CUDA tensors, their plain versions on
    CPU tensors), ``"dense"`` (``--dense_attention``) runs
    ``mha_reference`` under autograd.  ``sp_group`` (a
    ``torch.distributed`` group of ``sp_size`` ranks) runs the ring over
    processes: the net then takes this rank's (B, seq_len / sp_size)
    shard of every batch."""

    def __init__(
        self,
        vocab: int = VOCAB,
        dim: int = 64,
        depth: int = 2,
        heads: int = 2,
        seq_len: int = 128,
        mlp_ratio: int = 4,
        sp_size: int = 1,
        attention: str = "auto",
        name: str = "TransformerLM",
        sp_group=None,
    ):
        _check_geometry(dim, heads, sp_size, seq_len)
        self.sp_group = sp_group
        self.sp_index = 0
        if sp_group is not None:
            import torch.distributed as dist

            if dist.get_world_size(sp_group) != sp_size:
                raise ValueError(
                    f"sp_group has {dist.get_world_size(sp_group)} ranks, "
                    f"the ring {sp_size} shards (one shard a rank)")
            self.sp_index = dist.get_rank(sp_group)
        if attention not in ("auto", "flash", "dense"):
            raise ValueError(
                f"attention={attention!r}: expected 'auto' or 'flash' (the "
                "flash kernels) or 'dense' (--dense_attention: "
                "mha_reference)"
            )
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.depth = int(depth)
        self.heads = int(heads)
        self.head_dim = self.dim // self.heads
        self.seq_len = int(seq_len)
        self.mlp_ratio = int(mlp_ratio)
        self.sp_size = int(sp_size)
        self.local_seq = self.seq_len // self.sp_size
        self.attention = attention
        self.name = name
        self.feed_blobs = ("tokens", "targets")
        self._group_blobs = blob_plan(self.vocab, self.dim, self.depth,
                                      self.seq_len, self.mlp_ratio)
        self.layers, self._blob_refs = checkpoint_protocol(self._group_blobs)

    @property
    def on_kernel(self) -> bool:
        """Whether attention runs the flash kernels (the
        ``kernel_path{kernel="attention"}`` gauge)."""
        return self.attention != "dense"

    def _blob_plan(self) -> Plan:
        return self._group_blobs

    def init(self, seed: int = 0, device=None) -> Tuple[Params, Params]:
        """``(params, stats)``: the weights ``TransformerLM.init(seed)``
        draws, on ``device``; the LM has no running stats."""
        drawn = init_params(self._group_blobs, self.depth, seed)
        return {g: [b.to(device) for b in blobs]
                for g, blobs in drawn.items()}, {}

    def param_multipliers(self):
        return multipliers(self._group_blobs)

    def num_params(self) -> int:
        return _count(self._group_blobs)

    def with_sp(self, sp_size: int, sp_group=None) -> "TransformerLMNet":
        """The same architecture at another ring width (over ``sp_group``
        when given): the same seed gives the same params, which is how
        the sp=1 and sp=n legs share a start point."""
        return TransformerLMNet(
            vocab=self.vocab, dim=self.dim, depth=self.depth,
            heads=self.heads, seq_len=self.seq_len, mlp_ratio=self.mlp_ratio,
            sp_size=sp_size, attention=self.attention, name=self.name,
            sp_group=sp_group)

    def ring_hop_bytes_per_iter(self, batch: int) -> int:
        """Modeled ring-exchange bytes of one forward+backward iteration
        of one worker (the JAX model's): K and V shards pass ``sp - 1``
        hops a shard a layer, the backward mirroring the forward; 0 at
        sp=1.  The stacked ring reads them in place on the device, so
        this is what a ring over devices would carry."""
        from sparknet_tpu_torch.parallel.ring_attention import ring_hop_bytes

        return ring_hop_bytes(batch, self.local_seq, self.dim, self.sp_size,
                              self.depth)

    def forward_logits(self, params: Params, tokens):
        """(B, T) int tokens -> (B, T, vocab) f32 logits, T the sequence
        (``seq_len``), or this rank's shard of it (``local_seq``) over an
        sp group."""
        want = self.local_seq if self.sp_group is not None else self.seq_len
        if tokens.shape[1] != want:
            raise ValueError(
                f"tokens have T={tokens.shape[1]}, model expects "
                f"T={want} (seq_len={self.seq_len}, sp={self.sp_size}"
                + (", one shard a rank)" if self.sp_group is not None
                   else ")"))
        if self.sp_group is not None:
            attend = _ring_causal(self.sp_group, self.attention != "dense")
        elif self.sp_size > 1:
            attend = _ring_causal(self.sp_size, self.attention != "dense")
        elif self.attention == "dense":
            attend = _dense_causal
        else:
            attend = _flash_causal
        return causal_forward(params, tokens.long(), self.heads, attend,
                              pos_offset=self.sp_index * want)[0]

    def loss_fn(self, params: Params, stats: Params, batch, train: bool = True,
                rng=None):
        """Next-token cross-entropy averaged over the global B*T; ``(loss,
        ({"logits": logits}, stats))`` — the Solver's grad contract (the
        LM draws nothing: ``rng`` is ignored).  Over an sp group the
        shards' sums cross the group detached: every rank reports the
        same global loss, bit for bit, while its gradient is its own
        shard's share."""
        logits = self.forward_logits(params, batch["tokens"])
        tgt = batch["targets"].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        local = nll.sum()
        count = tgt.shape[0] * tgt.shape[1]
        if self.sp_group is not None:
            from sparknet_tpu_torch.parallel import mesh

            count *= self.sp_size
            total = mesh.all_reduce_sum(local.detach().clone(), self.sp_group)
            local = total + (local - local.detach())
        loss = local / float(count)
        return loss, ({"logits": logits}, stats)

    def forward(self, params: Params, stats: Params, batch):
        """Inference logits."""
        return {"logits": self.forward_logits(params, batch["tokens"])}
