"""Dense multi-head attention — the semantic ground truth.

The port of ``mha_reference`` from ``sparknet_tpu/ops/attention.py``;
the ``Attention`` layer class of that module comes with the layer-zoo
slice.
"""

from __future__ import annotations

import math

import torch


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
