"""Loss and evaluation layers.

The port of ``sparknet_tpu/ops/losses.py``, with the reference's
normalization semantics (``loss_layer.cpp``, ``softmax_loss_layer.cpp``):
default VALID (divide by the non-ignored count), legacy ``normalize:
false`` means BATCH_SIZE, FULL divides by outer*inner, NONE by 1.  The
other losses normalize by the batch size, as the reference does.

Under a data-parallel step (``utils/dp.py``) every normalizer counts the
global batch — ``VALID``'s non-ignored count crosses the group, since
ignored rows can fall unevenly over the ranks — so each rank's loss is
its own rows' sum over the global normalizer: the ranks' losses and
gradients add up to the global batch's.  ``Accuracy`` there reports the
global value on every rank.
"""

from __future__ import annotations

import torch

from sparknet_tpu_torch.config.schema import (
    AccuracyParameter,
    ContrastiveLossParameter,
    LossParameter,
)
from sparknet_tpu_torch.ops.base import Layer, register
from sparknet_tpu_torch.utils import dp


def _normalization(p: LossParameter) -> str:
    if p.normalize is not None and p.normalization == "VALID":
        return "VALID" if p.normalize else "BATCH_SIZE"
    return p.normalization.upper()


def _global_batch(n: int) -> int:
    """The batch a normalizer counts: ``n``, or the global batch under a
    data-parallel step."""
    shard = dp.current()
    return n if shard is None else shard.global_rows(n)


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
        outer = 1
        for d in logits.shape[:axis]:
            outer *= d
        inner = picked.numel() // max(1, outer)
        norm_kind = _normalization(p)
        shard = dp.current()
        if p.ignore_label is not None:
            valid = lab != p.ignore_label
            picked = torch.where(valid, picked, torch.zeros_like(picked))
            valid_count = valid.sum()
            if shard is not None and norm_kind == "VALID":
                valid_count = shard.sum(valid_count.to(torch.float32))
        else:
            valid_count = torch.tensor(_global_batch(outer) * inner,
                                       device=logits.device)
        norm = _normalizer(norm_kind, _global_batch(outer), inner,
                           valid_count, logits.device)
        tops = [-picked.sum() / norm]
        if len(self.lp.top) > 1:
            tops.append(torch.exp(logp))
        return tops, None


class _Loss(Layer):
    IS_LOSS = True

    def out_shapes(self, bottom_shapes):
        return [()]


@register
class SigmoidCrossEntropyLoss(_Loss):
    """Stable sigmoid cross-entropy summed over every element / the batch
    size (``sigmoid_cross_entropy_loss_layer.cpp``)."""

    TYPE = "SigmoidCrossEntropyLoss"

    def apply(self, blobs, bottoms, rng, train):
        x, t = bottoms[0], bottoms[1]
        per = torch.relu(x) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
        return [per.sum() / _global_batch(x.shape[0])], None


@register
class EuclideanLoss(_Loss):
    """0.5 * ||a - b||^2 / N (``euclidean_loss_layer.cpp``)."""

    TYPE = "EuclideanLoss"

    def apply(self, blobs, bottoms, rng, train):
        d = bottoms[0] - bottoms[1]
        return [0.5 * (d * d).sum() / _global_batch(d.shape[0])], None


def _labels(label: torch.Tensor, n: int) -> torch.Tensor:
    return label.to(torch.int64).reshape(n)


@register
class HingeLoss(_Loss):
    """One-vs-all hinge loss, L1 or L2 (``hinge_loss_layer.cpp``)."""

    TYPE = "HingeLoss"

    def apply(self, blobs, bottoms, rng, train):
        x = bottoms[0]
        n = x.shape[0]
        flat = x.reshape(n, -1)
        hot = torch.zeros_like(flat, dtype=torch.bool)
        hot.scatter_(1, _labels(bottoms[1], n)[:, None], True)
        sign = torch.where(hot, -1.0, 1.0).to(flat.dtype)
        margins = torch.relu(1.0 + sign * flat)
        p = self.lp.hinge_loss_param
        if p and p.norm.upper() == "L2":
            return [(margins * margins).sum() / _global_batch(n)], None
        return [margins.sum() / _global_batch(n)], None


@register
class MultinomialLogisticLoss(_Loss):
    """NLL of already-normalized probabilities
    (``multinomial_logistic_loss_layer.cpp``)."""

    TYPE = "MultinomialLogisticLoss"

    def apply(self, blobs, bottoms, rng, train):
        prob = bottoms[0]
        n = prob.shape[0]
        picked = torch.gather(prob.reshape(n, -1), 1,
                              _labels(bottoms[1], n)[:, None])
        return [-torch.log(torch.clamp_min(picked, 1e-20)).sum()
                / _global_batch(n)], None


@register
class InfogainLoss(_Loss):
    """NLL weighted by an infogain matrix H, fed as a third bottom
    (``infogain_loss_layer.cpp``; the file-sourced H is loaded into a
    bottom by whoever builds the batch)."""

    TYPE = "InfogainLoss"

    def apply(self, blobs, bottoms, rng, train):
        if len(bottoms) < 3:
            raise ValueError(
                f"InfogainLoss {self.name!r}: infogain matrix must be a bottom"
            )
        prob = bottoms[0]
        n = prob.shape[0]
        h = bottoms[2].reshape(tuple(bottoms[2].shape[-2:]))
        rows = h[_labels(bottoms[1], n)]  # (n, K)
        logp = torch.log(torch.clamp_min(prob.reshape(n, -1), 1e-20))
        return [-(rows * logp).sum() / _global_batch(n)], None


@register
class ContrastiveLoss(_Loss):
    """Siamese contrastive loss (``contrastive_loss_layer.cpp``), with the
    ``legacy_version`` switch between margin - d^2 and (margin - d)^2."""

    TYPE = "ContrastiveLoss"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.contrastive_loss_param or ContrastiveLossParameter()
        a, b, y = bottoms[0], bottoms[1], bottoms[2].reshape(-1)
        diff = a - b
        d2 = (diff * diff).sum(dim=1)
        if p.legacy_version:
            mismatch = torch.relu(p.margin - d2)
        else:
            d = torch.sqrt(torch.clamp_min(d2, 1e-12))
            mismatch = torch.relu(p.margin - d) ** 2
        per = y * d2 + (1.0 - y) * mismatch
        return [per.sum() / (2.0 * _global_batch(a.shape[0]))], None


@register
class Accuracy(Layer):
    """Top-k accuracy with ignore_label (reference: ``accuracy_layer.cpp``);
    ties go to the lower class index, as ``lax.top_k`` orders them.
    Exempt from a net's compute dtype: its label bottom is an index, and
    bf16 holds integers exactly only up to 256 (the JAX net casts it, so
    a bf16 TEST view there scores class 999 as 1000)."""

    TYPE = "Accuracy"
    MIXED_PRECISION_EXEMPT = True

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
        shard = dp.current()
        if shard is not None:
            # the global accuracy: hits and the count cross the group
            valid = (torch.ones_like(hit) if p.ignore_label is None
                     else (lab != p.ignore_label).to(torch.float32))
            sums = shard.sum(torch.stack([(hit * valid).sum(), valid.sum()]))
            return [sums[0] / sums[1].clamp_min(1.0)], None
        if p.ignore_label is not None:
            valid = (lab != p.ignore_label).to(torch.float32)
            return [(hit * valid).sum() / valid.sum().clamp_min(1.0)], None
        return [hit.mean()], None
