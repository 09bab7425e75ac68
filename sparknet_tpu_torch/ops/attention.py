"""Multi-head attention: the dense ground truth, the blockwise form and
the ``Attention`` layer.

The port of ``sparknet_tpu/ops/attention.py``.  ``mha_reference`` is
the semantic ground truth; ``blockwise_attention`` is the
online-softmax form over KV blocks that the sequence ring
(``parallel/ring_attention.py``) distributes; the ``Attention`` layer
runs the flash kernels on CUDA tensors (K1 forward, K3/K4 backward,
through ``cuda_attention.flash_attention_step`` with the end-aligned
offsets of ``mha_reference``) and ``blockwise_attention`` on CPU
tensors.  All compute the same function.

Blob layout (Caffe-style ordered list): [w_qkv (E, 3E), b_qkv (3E),
w_out (E, E), b_out (E)] with E = num_heads * head_dim.  Input/output
(B, T, E).
"""

from __future__ import annotations

import math

import torch

from sparknet_tpu_torch.config.schema import AttentionParameter, FillerParameter
from sparknet_tpu_torch.ops.base import BlobDef, Layer, register


def mha_reference(q, k, v, causal: bool = False):
    """Plain attention on (B, T, H, D) tensors, with the end-aligned
    causal mask ``tril(k=tk-tq)``: the last query attends to the last
    key."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device)
        scores = scores.masked_fill(~mask.tril(tk - tq), float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def blockwise_attention(q, k, v, block_size: int, causal: bool = False):
    """Online-softmax attention over KV blocks of ``block_size`` on
    (B, T, H, D) tensors, with ``mha_reference``'s end-aligned causal
    convention; equal to it up to float associativity.  A fully masked
    block leaves the running max and sum as they were."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    nblocks = max(1, -(-tk // block_size))
    scale = 1.0 / math.sqrt(d)
    q_pos = (tk - tq) + torch.arange(tq, device=q.device)
    acc = q.new_zeros((b, h, tq, d))
    m = q.new_full((b, h, tq), float("-inf"))
    l = q.new_zeros((b, h, tq))
    for i in range(nblocks):
        lo, hi = i * block_size, min(tk, (i + 1) * block_size)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, lo:hi]) * scale
        if causal:
            k_pos = torch.arange(lo, hi, device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # exp(-inf - -inf) guard: a row with every key so far masked
        alpha = torch.exp(torch.where(m == float("-inf"),
                                      torch.zeros_like(m), m - m_new))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    v[:, lo:hi])
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3)  # -> (B, T, H, D)


def _layer_attention(q, k, v, block_size: int, causal: bool):
    """The layer's attention: the flash kernels on CUDA tensors (the
    absolute offsets ``(tk - tq, 0)`` are ``mha_reference``'s end
    alignment), ``blockwise_attention`` on CPU tensors."""
    if q.is_cuda:
        from sparknet_tpu_torch.ops import cuda_attention

        tq, tk = q.shape[1], k.shape[1]
        o, _ = cuda_attention.flash_attention_step(q, k, v, tk - tq, 0, causal)
        return o.permute(0, 2, 1, 3)
    return blockwise_attention(q, k, v, block_size, causal)


@register
class Attention(Layer):
    """Self-attention over (B, T, E) bottoms."""

    TYPE = "Attention"

    def _p(self) -> AttentionParameter:
        return self.lp.attention_param or AttentionParameter()

    def _dims(self, bshape):
        p = self._p()
        e = bshape[-1]
        head_dim = p.head_dim or e // max(1, p.num_heads)
        if p.num_heads * head_dim != e:
            raise ValueError(
                f"layer {self.name!r}: num_heads*head_dim "
                f"{p.num_heads}x{head_dim} != embed dim {e}"
            )
        return p.num_heads, head_dim, e

    def blob_defs(self, bottom_shapes):
        p = self._p()
        _, _, e = self._dims(bottom_shapes[0])
        wf = p.weight_filler or FillerParameter(type="xavier")
        defs = [BlobDef((e, 3 * e), wf)]
        if p.bias_term:
            defs.append(BlobDef((3 * e,), FillerParameter(type="constant")))
        defs.append(BlobDef((e, e), wf))
        if p.bias_term:
            defs.append(BlobDef((e,), FillerParameter(type="constant")))
        return defs

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def apply(self, blobs, bottoms, rng, train):
        from sparknet_tpu_torch.ops.common import inverted_dropout

        p = self._p()
        x = bottoms[0]
        h, d, e = self._dims(x.shape)
        b, t, _ = x.shape
        qkv = x @ blobs[0]
        if p.bias_term:
            qkv = qkv + blobs[1]
        qkv = qkv.reshape(b, t, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = _layer_attention(q, k, v, min(p.block_size, t), p.causal)
        out = inverted_dropout(out, rng, p.dropout_ratio, train, self.name)
        y = out.reshape(b, t, e) @ blobs[2 if p.bias_term else 1]
        if p.bias_term:
            y = y + blobs[3]
        return [y], None
