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
  returns the module, ``prefill_with_kv`` / ``decode_step_with_kv``
  serve ``cli serve --generate``;
- ``TransformerLMNet``, the Solver "net protocol" of the JAX LM
  (``init(seed, device) -> (params, stats)``, ``loss_fn``,
  ``param_multipliers``, ``feed_blobs``) over a ``{group: [blob]}``
  params dict, which the solver and the averaging trainer train.

Attention runs through ``ops.cuda_attention``: the flash kernels (K1
forward, K3/K4 backward) for prefill and every training step, the
decode kernel for one new position — on CUDA tensors; on CPU tensors
their plain versions.  ``attention="dense"`` trains with
``ops.attention.mha_reference`` instead.  The sequence-parallel ring is
not yet ported: both views refuse ``sp_size > 1``.
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


def _check_geometry(dim: int, heads: int, sp_size: int) -> None:
    if dim % heads:
        raise ValueError(f"dim={dim} not divisible by heads={heads}")
    if sp_size != 1:
        raise ValueError(
            "the port serves and trains the sp=1 model only; the "
            "sequence-parallel ring (parallel/ring_attention.py) is not "
            "yet ported"
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


def init_params(plan: Plan, depth: int, seed: int = 0) -> Params:
    """Seeded weights with the JAX package's recipe: normal(0, 0.02)
    matrices, the residual-branch output projections (``wo``, ``w2``)
    scaled by ``1/sqrt(2*depth)`` (the GPT-2 init), LayerNorm gains 1
    and every bias 0.  The draws come from one CPU ``torch.Generator``
    per group, so the weights are the same on every device (they differ
    from the JAX package's, whose generator is another; tests carry
    those across with ``interop``)."""
    std = 0.02
    res_std = std / math.sqrt(max(1, 2 * depth))
    params: Params = {}
    for gi, (group, shapes) in enumerate(plan):
        gen = torch.Generator().manual_seed(int(seed) * 1_000_003 + gi)
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
            blobs.append(torch.randn(shape, generator=gen,
                                     dtype=torch.float32) * s)
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
                   keep_kv: bool = False):
    """The causal forward over a ``{group: [blob]}`` params dict — the
    one body of both views.  ``tokens`` (B, T) int64, T <= the position
    table; ``attend(q, k, v)`` is one layer's causal attention on
    (B, T, H, D).  Returns ``(logits (B, T, V), [k], [v])``, the per-layer
    K/V lists filled only with ``keep_kv``."""
    B, T = tokens.shape
    tok, pos = params["embed"]
    E = tok.shape[1]
    D = E // heads
    x = (tok[tokens] + pos[torch.arange(T, device=tokens.device)]).float()
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
        _check_geometry(dim, heads, sp_size)
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

    @torch.no_grad()
    def decode_step_with_kv(self, tokens, positions, k_ctx, v_ctx):
        """One decode position per sequence against gathered KV context.

        ``tokens`` (B,) — the token to embed at ``positions`` (B,) (the
        number of already-cached positions per sequence); ``k_ctx``/
        ``v_ctx`` (depth, B, S, H, D) — the paged-cache gather, rows at
        index >= positions[b] are garbage and masked off.  This step's
        own K/V are written into ``k_ctx``/``v_ctx`` IN PLACE (the
        caller's gather is a fresh copy, so this saves a second one) so
        attention sees them, and returned as ``new_k``/``new_v`` (depth,
        B, H, D) for the engine to scatter into the arena.  Returns
        ``(logits (B,V), new_k, new_v)``."""
        tokens = tokens.long()
        positions = positions.long()
        B = tokens.shape[0]
        H, D = self.heads, self.head_dim
        x = self._embed(tokens, positions)[:, None, :]
        rows = torch.arange(B, device=tokens.device)
        lengths = (positions + 1).to(torch.int32)
        new_ks, new_vs = [], []
        for i, blk in enumerate(self.blocks):
            q, k1, v1 = self._qkv(blk, blk.ln1(x))
            k1, v1 = k1[:, 0], v1[:, 0]
            new_ks.append(k1)
            new_vs.append(v1)
            k_ctx[i, rows, positions] = k1
            v_ctx[i, rows, positions] = v1
            out = cuda_attention.decode_attention(
                q, k_ctx[i], v_ctx[i], lengths=lengths
            )
            x = x + out.reshape(B, 1, self.dim) @ blk.attn.wo
            x = x + blk.mlp(blk.ln2(x))
        logits = (self.ln_f(x) @ self.head)[:, 0]
        return logits, torch.stack(new_ks), torch.stack(new_vs)


class TransformerLMNet:
    """The LM as a Solver "net" (JAX ``TransformerLM``'s protocol):
    ``init(seed, device) -> (params, stats)``, ``loss_fn``,
    ``param_multipliers``, ``feed_blobs``, over a ``{group: [blob]}``
    params dict in ``blob_plan`` order.

    ``attention``: ``"auto"`` and ``"flash"`` run the kernel wrappers
    (K1 forward, K3/K4 backward on CUDA tensors, their plain versions on
    CPU tensors), ``"dense"`` (``--dense_attention``) runs
    ``mha_reference`` under autograd."""

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
    ):
        _check_geometry(dim, heads, sp_size)
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
        self.sp_size = 1
        self.attention = attention
        self.name = name
        self.feed_blobs = ("tokens", "targets")
        self._group_blobs = blob_plan(self.vocab, self.dim, self.depth,
                                      self.seq_len, self.mlp_ratio)

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

    def forward_logits(self, params: Params, tokens):
        """(B, seq_len) int tokens -> (B, seq_len, vocab) f32 logits."""
        if tokens.shape[1] != self.seq_len:
            raise ValueError(
                f"tokens have T={tokens.shape[1]}, model expects "
                f"T={self.seq_len}"
            )
        attend = _dense_causal if self.attention == "dense" else _flash_causal
        return causal_forward(params, tokens.long(), self.heads, attend)[0]

    def loss_fn(self, params: Params, stats: Params, batch, train: bool = True):
        """Next-token cross-entropy averaged over B*T; ``(loss,
        ({"logits": logits}, stats))`` — the Solver's grad contract."""
        logits = self.forward_logits(params, batch["tokens"])
        tgt = batch["targets"].long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        loss = nll.sum() / float(tgt.shape[0] * tgt.shape[1])
        return loss, ({"logits": logits}, stats)

    def forward(self, params: Params, stats: Params, batch):
        """Inference logits."""
        return {"logits": self.forward_logits(params, batch["tokens"])}
