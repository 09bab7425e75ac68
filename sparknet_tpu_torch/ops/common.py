"""Common layers: inner product, ReLU and dropout.

The port of ``InnerProduct``, ``ReLU``, ``inverted_dropout`` and
``Dropout`` of ``sparknet_tpu/ops/common.py`` (reference:
``inner_product_layer.cpp``, ``relu_layer.cpp``,
``dropout_layer.cpp``); the other layers of that module come with later
slices.
"""

from __future__ import annotations

import torch

from sparknet_tpu_torch.config.schema import FillerParameter, ReLUParameter
from sparknet_tpu_torch.ops.base import BlobDef, Layer, register
from sparknet_tpu_torch.utils import rngs


def _mults(lp, i, default_lr=1.0, default_decay=1.0):
    """``(lr_mult, decay_mult)`` of blob ``i`` from the layer's ParamSpecs."""
    if i < len(lp.param):
        return lp.param[i].lr_mult, lp.param[i].decay_mult
    return default_lr, default_decay


@register
class InnerProduct(Layer):
    """Fully connected layer.  Flattens the bottom from ``axis`` (C-order,
    so NCHW weight import parity holds); weight blob ``(num_output,
    dim)`` unless ``transpose``."""

    TYPE = "InnerProduct"

    def _dims(self, bshape):
        p = self.lp.inner_product_param
        axis = p.axis % len(bshape)
        dim = 1
        for s in bshape[axis:]:
            dim *= int(s)
        return axis, dim

    def blob_defs(self, bottom_shapes):
        p = self.lp.inner_product_param
        _, dim = self._dims(bottom_shapes[0])
        wshape = (dim, p.num_output) if p.transpose else (p.num_output, dim)
        wl, wd = _mults(self.lp, 0)
        bl, bd = _mults(self.lp, 1)
        defs = [BlobDef(wshape, p.weight_filler, wl, wd)]
        if p.bias_term:
            defs.append(
                BlobDef(
                    (p.num_output,),
                    p.bias_filler or FillerParameter(type="constant"),
                    bl,
                    bd,
                )
            )
        return defs

    def out_shapes(self, bottom_shapes):
        p = self.lp.inner_product_param
        axis, _ = self._dims(bottom_shapes[0])
        return [tuple(bottom_shapes[0][:axis]) + (p.num_output,)]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.inner_product_param
        axis, dim = self._dims(tuple(bottoms[0].shape))
        x = bottoms[0].reshape(tuple(bottoms[0].shape[:axis]) + (dim,))
        w = blobs[0] if p.transpose else blobs[0].t()
        y = x @ w
        if p.bias_term:
            y = y + blobs[1]
        return [y], None


@register
class ReLU(Layer):
    """ReLU with optional leaky slope."""

    TYPE = "ReLU"

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.relu_param or ReLUParameter()
        x = bottoms[0]
        if p.negative_slope:
            return [torch.where(x > 0, x, p.negative_slope * x)], None
        return [torch.relu(x)], None


def inverted_dropout(x, rng, ratio: float, train: bool, where: str):
    """Inverted dropout (reference: ``dropout_layer.cpp``): in train, kept
    units are scaled by ``1/(1-ratio)``; test, or ``ratio == 0``, is the
    identity.  The mask is drawn on the CPU from ``rngs.generator(rng)``
    and copied to ``x``'s device, so one key gives one mask on any
    device."""
    if not train or ratio == 0.0:
        return x
    if rng is None:
        raise ValueError(f"dropout in {where!r} needs an rng in train")
    keep = 1.0 - ratio
    mask = torch.rand(tuple(x.shape), generator=rngs.generator(rng)) < keep
    return torch.where(mask.to(x.device, non_blocking=True), x / keep,
                       torch.zeros_like(x))


@register
class Dropout(Layer):
    TYPE = "Dropout"

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.dropout_param
        ratio = p.dropout_ratio if p else 0.5
        return [inverted_dropout(bottoms[0], rng, ratio, train, self.name)], None
