"""Loss and evaluation layers: SoftmaxWithLoss and Accuracy.

The port of those two layers of ``sparknet_tpu/ops/losses.py``, with
the reference's normalization semantics (``loss_layer.cpp``,
``softmax_loss_layer.cpp``): default VALID (divide by the non-ignored
count), legacy ``normalize: false`` means BATCH_SIZE, FULL divides by
outer*inner, NONE by 1.
"""

from __future__ import annotations

import torch

from sparknet_tpu_torch.config.schema import AccuracyParameter, LossParameter
from sparknet_tpu_torch.ops.base import Layer, register


def _normalization(p: LossParameter) -> str:
    if p.normalize is not None and p.normalization == "VALID":
        return "VALID" if p.normalize else "BATCH_SIZE"
    return p.normalization.upper()


def _normalizer(norm: str, outer: int, inner: int, valid_count, device):
    if norm == "FULL":
        return torch.tensor(float(outer * inner), device=device)
    if norm == "VALID":
        return torch.clamp_min(valid_count.to(torch.float32), 1.0)
    if norm == "BATCH_SIZE":
        return torch.tensor(float(outer), device=device)
    if norm == "NONE":
        return torch.tensor(1.0, device=device)
    raise ValueError(f"unknown loss normalization {norm!r}")


@register
class SoftmaxWithLoss(Layer):
    """Softmax + multinomial NLL with ignore_label.  Softmax axis default
    1; labels index that axis; outer = dims before it, inner = after."""

    TYPE = "SoftmaxWithLoss"
    IS_LOSS = True

    def out_shapes(self, bottom_shapes):
        outs = [()]
        if len(self.lp.top) > 1:
            outs.append(bottom_shapes[0])  # optional softmax top
        return outs

    def apply(self, blobs, bottoms, rng, train):
        logits, labels = bottoms[0], bottoms[1]
        p = self.lp.loss_param or LossParameter()
        axis = self.lp.softmax_param.axis if self.lp.softmax_param else 1
        axis = axis % logits.dim()
        logp = torch.log_softmax(logits, dim=axis)
        moved = torch.movedim(logp, axis, -1)
        lab = labels.to(torch.int64).reshape(moved.shape[:-1])
        picked = torch.gather(
            moved, -1, lab.clamp(0, moved.shape[-1] - 1)[..., None]
        )[..., 0]
        if p.ignore_label is not None:
            valid = lab != p.ignore_label
            picked = torch.where(valid, picked, torch.zeros_like(picked))
            valid_count = valid.sum()
        else:
            valid_count = torch.tensor(picked.numel(), device=logits.device)
        outer = 1
        for d in logits.shape[:axis]:
            outer *= d
        inner = picked.numel() // max(1, outer)
        norm = _normalizer(_normalization(p), outer, inner, valid_count,
                           logits.device)
        tops = [-picked.sum() / norm]
        if len(self.lp.top) > 1:
            tops.append(torch.exp(logp))
        return tops, None


@register
class Accuracy(Layer):
    """Top-k accuracy with ignore_label (reference: ``accuracy_layer.cpp``);
    ties go to the lower class index, as ``lax.top_k`` orders them."""

    TYPE = "Accuracy"

    def out_shapes(self, bottom_shapes):
        return [()]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.accuracy_param or AccuracyParameter()
        x = bottoms[0]
        axis = p.axis % x.dim()
        moved = torch.movedim(x, axis, -1)
        lab = bottoms[1].to(torch.int64).reshape(moved.shape[:-1])
        k = min(p.top_k, moved.shape[-1])
        if k == 1:
            topk = torch.argmax(moved, dim=-1, keepdim=True)
        else:
            topk = torch.topk(moved, k, dim=-1, sorted=True).indices
        hit = (topk == lab[..., None]).any(dim=-1).to(torch.float32)
        if p.ignore_label is not None:
            valid = (lab != p.ignore_label).to(torch.float32)
            return [(hit * valid).sum() / valid.sum().clamp_min(1.0)], None
        return [hit.mean()], None
