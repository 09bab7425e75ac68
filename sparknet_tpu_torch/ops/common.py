"""Common layers: inner product, neuron/elementwise ops, shape ops,
normalization, embedding.

The port of ``sparknet_tpu/ops/common.py`` (reference semantics, cited
per class: ``caffe/src/caffe/layers/``).  Every layer here is plain
PyTorch, as every one there is plain XLA: none reaches a Pallas kernel.
BatchNorm keeps the JAX layer's formula to the op: the biased variance
``E[x^2] - mean^2``, the three stat blobs ``[mean_sum, var_sum,
factor]`` decayed by ``moving_average_fraction``, the ``m / (m - 1)``
correction and ``1 / factor`` (0 -> 1) under global stats.

Under a data-parallel step (``utils/dp.py``: a ``BatchShard`` active)
the layers that reduce over the batch or draw for it compute the
global batch's quantity from this rank's rows: BatchNorm's moments and
their backward cross the group (``_ShardedBatchNorm``), a dropout mask
is drawn for the global batch and cut to the rank's rows, a Reshape or
Reduction that names the batch axis reads the global batch, and the
layers that move rows between batch positions (``BatchReindex``, and
``Concat``/``Slice``/``Tile`` on axis 0) refuse.
"""

from __future__ import annotations

import importlib

import torch

from sparknet_tpu_torch.config.schema import (
    ArgMaxParameter,
    BatchNormParameter,
    BiasParameter,
    EltwiseParameter,
    ELUParameter,
    FillerParameter,
    FlattenParameter,
    MVNParameter,
    PowerParameter,
    ReductionParameter,
    ReLUParameter,
    ScaleParameter,
)
from sparknet_tpu_torch.ops.base import BlobDef, Layer, register
from sparknet_tpu_torch.utils import dp, rngs


def _refuse_batch_axis(layer, axis: int) -> None:
    """A layer that moves rows between batch positions (axis 0) has no
    rank-local form under a data-parallel step: refuse it there."""
    if axis == 0 and dp.current() is not None:
        raise NotImplementedError(
            f"{layer.TYPE} {layer.name!r} along the batch axis under "
            "data-parallel ranks is not yet ported to sparknet_tpu_torch")


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


# ---------------------------------------------------------------------------
# Neuron layers (elementwise, one bottom -> one top)
# ---------------------------------------------------------------------------


class _Neuron(Layer):
    """One bottom, one top of its shape."""

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]


@register
class ReLU(_Neuron):
    """ReLU with optional leaky slope."""

    TYPE = "ReLU"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.relu_param or ReLUParameter()
        x = bottoms[0]
        if p.negative_slope:
            return [torch.where(x > 0, x, p.negative_slope * x)], None
        return [torch.relu(x)], None


@register
class Sigmoid(_Neuron):
    TYPE = "Sigmoid"

    def apply(self, blobs, bottoms, rng, train):
        return [torch.sigmoid(bottoms[0])], None


@register
class TanH(_Neuron):
    TYPE = "TanH"

    def apply(self, blobs, bottoms, rng, train):
        return [torch.tanh(bottoms[0])], None


@register
class AbsVal(_Neuron):
    TYPE = "AbsVal"

    def apply(self, blobs, bottoms, rng, train):
        return [torch.abs(bottoms[0])], None


@register
class BNLL(_Neuron):
    """out = log(1 + exp(x)), numerically stable (``bnll_layer.cpp``)."""

    TYPE = "BNLL"

    def apply(self, blobs, bottoms, rng, train):
        x = bottoms[0]
        return [torch.relu(x) + torch.log1p(torch.exp(-torch.abs(x)))], None


@register
class Power(_Neuron):
    """out = (shift + scale*x)^power (``power_layer.cpp``)."""

    TYPE = "Power"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.power_param or PowerParameter()
        y = p.shift + p.scale * bottoms[0]
        if p.power != 1.0:
            y = torch.pow(y, p.power)
        return [y], None


@register
class Exp(_Neuron):
    """out = base^(shift + scale*x); base -1 means e (``exp_layer.cpp``)."""

    TYPE = "Exp"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.exp_param
        inner = p.shift + p.scale * bottoms[0] if p else bottoms[0]
        if p and p.base > 0:
            return [torch.pow(torch.tensor(p.base, dtype=inner.dtype,
                                           device=inner.device), inner)], None
        return [torch.exp(inner)], None


@register
class Log(_Neuron):
    """out = log_base(shift + scale*x) (``log_layer.cpp``)."""

    TYPE = "Log"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.log_param
        inner = p.shift + p.scale * bottoms[0] if p else bottoms[0]
        y = torch.log(inner)
        if p and p.base > 0:
            y = y / torch.log(torch.tensor(p.base, dtype=y.dtype,
                                           device=y.device))
        return [y], None


@register
class Threshold(_Neuron):
    TYPE = "Threshold"

    def apply(self, blobs, bottoms, rng, train):
        t = self.lp.threshold_param.threshold if self.lp.threshold_param else 0.0
        return [(bottoms[0] > t).to(bottoms[0].dtype)], None


def inverted_dropout(x, rng, ratio: float, train: bool, where: str):
    """Inverted dropout (reference: ``dropout_layer.cpp``): in train, kept
    units are scaled by ``1/(1-ratio)``; test, or ``ratio == 0``, is the
    identity.  The mask is drawn on the CPU from ``rngs.generator(rng)``
    and copied to ``x``'s device, so one key gives one mask on any
    device.  Under a data-parallel step the mask is drawn for the
    global batch and cut to this rank's rows."""
    if not train or ratio == 0.0:
        return x
    if rng is None:
        raise ValueError(f"dropout in {where!r} needs an rng in train")
    keep = 1.0 - ratio
    gen = rngs.generator(rng)
    shard = dp.current()
    if shard is None:
        mask = torch.rand(tuple(x.shape), generator=gen) < keep
    else:
        mask = shard.draw(tuple(x.shape), lambda shape: torch.rand(
            shape, generator=gen)) < keep
    return torch.where(mask.to(x.device, non_blocking=True), x / keep,
                       torch.zeros_like(x))


@register
class Dropout(_Neuron):
    TYPE = "Dropout"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.dropout_param
        ratio = p.dropout_ratio if p else 0.5
        return [inverted_dropout(bottoms[0], rng, ratio, train, self.name)], None


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over an (N, C, ...) tensor."""
    return t.reshape((1, -1) + (1,) * (ndim - 2))


@register
class PReLU(_Neuron):
    """Parametric ReLU; slope blob per channel or shared
    (``prelu_layer.cpp``, default filler constant 0.25, decay 0)."""

    TYPE = "PReLU"

    def blob_defs(self, bottom_shapes):
        p = self.lp.prelu_param
        shared = bool(p and p.channel_shared)
        c = 1 if shared else bottom_shapes[0][1]
        filler = (p.filler if p else None) or FillerParameter(
            type="constant", value=0.25
        )
        lr, dc = _mults(self.lp, 0, 1.0, 0.0)
        return [BlobDef((c,), filler, lr, dc)]

    def apply(self, blobs, bottoms, rng, train):
        x = bottoms[0]
        return [torch.where(x > 0, x, _channel_view(blobs[0], x.dim()) * x)], None


@register
class ELU(_Neuron):
    """x > 0 ? x : alpha * (exp(x) - 1) (``elu_layer.cpp``)."""

    TYPE = "ELU"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.elu_param or ELUParameter()
        x = bottoms[0]
        return [torch.where(x > 0, x, p.alpha * torch.expm1(x))], None


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


class _ShardedBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch, this rank holding
    its rows: the per-channel ``sum(x)``, ``sum(x*x)`` and the row count
    cross the group in one buffer, and the backward's ``sum(dy)`` and
    ``sum(dy * x_hat)`` in another, so ``dx`` is the global batch's
    gradient at this rank's rows.  The sums run in float32 (float64 for
    a float64 input).  Returns ``(y, mean, var, m)``, ``m`` the global
    count (a 0-dim tensor)."""

    @staticmethod
    def forward(ctx, x, eps, shard):
        axes = (0,) + tuple(range(2, x.dim()))
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        xa = x.to(acc)
        local = x.numel() // x.shape[1]
        sums = shard.sum(torch.cat([xa.sum(dim=axes), (xa * xa).sum(dim=axes),
                                    xa.new_tensor([float(local)])]))
        c = x.shape[1]
        m = sums[-1]
        mean = sums[:c] / m
        var = sums[c:2 * c] / m - mean * mean  # biased
        std = torch.sqrt(_channel_view(var, x.dim()) + eps)
        x_hat = (xa - _channel_view(mean, x.dim())) / std
        ctx.save_for_backward(x_hat, std, m)
        ctx.shard, ctx.axes = shard, axes
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        ctx.mark_non_differentiable(mean, var, m)
        return x_hat.to(x.dtype), mean, var, m

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dm):
        x_hat, std, m = ctx.saved_tensors
        dya = dy.to(x_hat.dtype)
        c = x_hat.shape[1]
        sums = ctx.shard.sum(torch.cat([dya.sum(dim=ctx.axes),
                                        (dya * x_hat).sum(dim=ctx.axes)]))
        nd = x_hat.dim()
        dx = (dya - _channel_view(sums[:c] / m, nd)
              - x_hat * _channel_view(sums[c:] / m, nd)) / std
        return dx.to(dy.dtype), None, None


@register
class BatchNorm(_Neuron):
    """Caffe batch norm: normalizes only (a Scale layer carries the
    affine).  Blobs ``[mean_sum, var_sum, factor]``, lr 0 — the
    reference's stat layout (``batch_norm_layer.cpp``), so .caffemodel
    files carry them; in train the stats update functionally."""

    TYPE = "BatchNorm"

    def blob_defs(self, bottom_shapes):
        c = bottom_shapes[0][1]
        zero = FillerParameter(type="constant", value=0.0)
        return [
            BlobDef((c,), zero, 0.0, 0.0, learnable=False),
            BlobDef((c,), zero, 0.0, 0.0, learnable=False),
            BlobDef((1,), zero, 0.0, 0.0, learnable=False),
        ]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.batch_norm_param or BatchNormParameter()
        x = bottoms[0]
        use_global = (
            p.use_global_stats if p.use_global_stats is not None else not train
        )
        axes = (0,) + tuple(range(2, x.dim()))
        if use_global:
            # the stored sums are scaled by the accumulated factor
            f = blobs[2][0]
            factor = torch.where(f == 0, torch.ones_like(f), 1.0 / f)
            mean = blobs[0] * factor
            var = blobs[1] * factor
            y = (x - _channel_view(mean, x.dim())) / torch.sqrt(
                _channel_view(var, x.dim()) + p.eps)
            return [y], None
        m = 1
        for a in axes:
            m *= x.shape[a]
        shard = dp.current()
        if shard is not None:
            y, mean, var, m = _ShardedBatchNorm.apply(x, p.eps, shard)
        else:
            mean = x.mean(dim=axes)
            var = (x * x).mean(dim=axes) - mean * mean  # biased
            y = (x - _channel_view(mean, x.dim())) / torch.sqrt(
                _channel_view(var, x.dim()) + p.eps)
        lam = p.moving_average_fraction
        if shard is not None:  # m: the global count, a tensor
            bias_corr = m / torch.clamp_min(m - 1.0, 1.0)
        else:
            bias_corr = m / max(1.0, m - 1.0)
        new_blobs = [
            lam * blobs[0] + mean,
            lam * blobs[1] + bias_corr * var,
            lam * blobs[2] + 1.0,
        ]
        return [y], new_blobs


def _axis_window(bshape, axis: int, num_axes: int):
    """The blob shape of Scale/Bias: ``bshape[axis:axis + num_axes]``
    (-1: to the end)."""
    axis = axis % len(bshape)
    if num_axes == -1:
        return tuple(bshape[axis:])
    return tuple(bshape[axis : axis + num_axes])


def _broadcast_from(t: torch.Tensor, x: torch.Tensor, axis: int):
    """``t`` shaped to broadcast over ``x`` from ``axis``."""
    axis = axis % x.dim()
    return t.reshape((1,) * axis + tuple(t.shape)
                     + (1,) * (x.dim() - axis - t.dim()))


@register
class Scale(_Neuron):
    """Per-channel learned scale (optionally + bias), the affine half of
    Caffe batch norm (``scale_layer.cpp``).  The two-bottom form
    multiplies bottom[0] by bottom[1] broadcast from ``axis``."""

    TYPE = "Scale"

    def _p(self):
        return self.lp.scale_param or ScaleParameter()

    def blob_defs(self, bottom_shapes):
        p = self._p()
        shape = _axis_window(bottom_shapes[0], p.axis, p.num_axes)
        defs = []
        if len(bottom_shapes) == 1:
            filler = p.filler or FillerParameter(type="constant", value=1.0)
            defs.append(BlobDef(shape, filler, *_mults(self.lp, 0)))
        if p.bias_term:
            defs.append(BlobDef(
                shape, p.bias_filler or FillerParameter(type="constant"),
                *_mults(self.lp, len(defs))))
        return defs

    def apply(self, blobs, bottoms, rng, train):
        p = self._p()
        x = bottoms[0]
        scale = bottoms[1] if len(bottoms) > 1 else blobs[0]
        y = x * _broadcast_from(scale, x, p.axis)
        if p.bias_term:
            y = y + _broadcast_from(blobs[-1], x, p.axis)
        return [y], None


@register
class Bias(_Neuron):
    """Additive counterpart of Scale (``bias_layer.cpp``)."""

    TYPE = "Bias"

    def _p(self):
        return self.lp.bias_param or BiasParameter()

    def blob_defs(self, bottom_shapes):
        if len(bottom_shapes) > 1:
            return []
        p = self._p()
        return [BlobDef(_axis_window(bottom_shapes[0], p.axis, p.num_axes),
                        p.filler or FillerParameter(type="constant"),
                        *_mults(self.lp, 0))]

    def apply(self, blobs, bottoms, rng, train):
        x = bottoms[0]
        bias = bottoms[1] if len(bottoms) > 1 else blobs[0]
        return [x + _broadcast_from(bias, x, self._p().axis)], None


@register
class MVN(_Neuron):
    """Mean-variance normalization per sample (``mvn_layer.cpp``)."""

    TYPE = "MVN"

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.mvn_param or MVNParameter()
        x = bottoms[0]
        first = 1 if p.across_channels else 2
        axes = tuple(range(first, x.dim()))
        y = x - x.mean(dim=axes, keepdim=True)
        if p.normalize_variance:
            std = torch.sqrt((y * y).mean(dim=axes, keepdim=True))
            y = y / (std + p.eps)
        return [y], None


@register
class Softmax(_Neuron):
    TYPE = "Softmax"

    def apply(self, blobs, bottoms, rng, train):
        axis = self.lp.softmax_param.axis if self.lp.softmax_param else 1
        return [torch.softmax(bottoms[0], dim=axis)], None


# ---------------------------------------------------------------------------
# Shape / combination layers
# ---------------------------------------------------------------------------


@register
class Concat(Layer):
    TYPE = "Concat"

    def _axis(self, ndim):
        p = self.lp.concat_param
        if p and p.concat_dim is not None:
            return p.concat_dim % ndim
        return (p.axis if p else 1) % ndim

    def out_shapes(self, bottom_shapes):
        axis = self._axis(len(bottom_shapes[0]))
        out = list(bottom_shapes[0])
        out[axis] = sum(s[axis] for s in bottom_shapes)
        return [tuple(out)]

    def apply(self, blobs, bottoms, rng, train):
        axis = self._axis(bottoms[0].dim())
        _refuse_batch_axis(self, axis)
        return [torch.cat(bottoms, dim=axis)], None


@register
class Slice(Layer):
    TYPE = "Slice"

    def _splits(self, bshape):
        p = self.lp.slice_param
        axis = (
            p.slice_dim if p and p.slice_dim is not None
            else (p.axis if p else 1)
        ) % len(bshape)
        n_top = max(1, len(self.lp.top))
        size = bshape[axis]
        if p and p.slice_point:
            points = list(p.slice_point)
        else:
            if size % n_top:
                raise ValueError(f"Slice {self.name!r}: {size} not divisible")
            points = [size // n_top * i for i in range(1, n_top)]
        return axis, [0] + points + [size]

    def out_shapes(self, bottom_shapes):
        axis, bounds = self._splits(bottom_shapes[0])
        outs = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            s = list(bottom_shapes[0])
            s[axis] = hi - lo
            outs.append(tuple(s))
        return outs

    def apply(self, blobs, bottoms, rng, train):
        axis, bounds = self._splits(tuple(bottoms[0].shape))
        _refuse_batch_axis(self, axis)
        return [bottoms[0].narrow(axis, lo, hi - lo)
                for lo, hi in zip(bounds[:-1], bounds[1:])], None


@register
class Split(Layer):
    """Explicit fan-out (identity copies); autograd sums the gradients at
    fan-out points, so splits are never inserted — configs that declare
    them work."""

    TYPE = "Split"

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]] * max(1, len(self.lp.top))

    def apply(self, blobs, bottoms, rng, train):
        return [bottoms[0]] * max(1, len(self.lp.top)), None


@register
class Flatten(Layer):
    TYPE = "Flatten"

    def out_shapes(self, bottom_shapes):
        p = self.lp.flatten_param or FlattenParameter()
        s = bottom_shapes[0]
        a = p.axis % len(s)
        e = p.end_axis % len(s)
        mid = 1
        for d in s[a : e + 1]:
            mid *= d
        return [tuple(s[:a]) + (mid,) + tuple(s[e + 1 :])]

    def apply(self, blobs, bottoms, rng, train):
        x = bottoms[0]
        return [x.reshape(self.out_shapes([tuple(x.shape)])[0])], None


@register
class Reshape(Layer):
    """Caffe reshape with 0 (copy) and -1 (infer) dims over an axis window
    (``reshape_layer.cpp``)."""

    TYPE = "Reshape"

    def out_shapes(self, bottom_shapes, shard=None):
        p = self.lp.reshape_param
        s = list(bottom_shapes[0])
        dims = list(p.shape.dim) if p and p.shape else []
        axis = (p.axis if p else 0) % (len(s) + 1)
        if shard is not None and axis == 0 and dims and dims[0] > 0:
            # a declared batch is the global one: this rank's share
            if dims[0] % shard.size:
                raise ValueError(
                    f"Reshape {self.name!r}: declared batch {dims[0]} does "
                    f"not split over {shard.size} data-parallel ranks")
            dims[0] //= shard.size
        num_axes = p.num_axes if p else -1
        end = len(s) if num_axes == -1 else axis + num_axes
        window = s[axis:end]
        out_mid, infer = [], -1
        for i, d in enumerate(dims):
            if d == 0:
                out_mid.append(window[i])
            elif d == -1:
                infer = i
                out_mid.append(1)
            else:
                out_mid.append(d)
        total = known = 1
        for d in window:
            total *= d
        for d in out_mid:
            known *= d
        if infer >= 0:
            out_mid[infer] = total // known
        return [tuple(s[:axis]) + tuple(out_mid) + tuple(s[end:])]

    def apply(self, blobs, bottoms, rng, train):
        x = bottoms[0]
        return [x.reshape(self.out_shapes([tuple(x.shape)],
                                          dp.current())[0])], None


@register
class Eltwise(Layer):
    """Elementwise PROD/SUM/MAX with coefficients (``eltwise_layer.cpp``)."""

    TYPE = "Eltwise"

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.eltwise_param or EltwiseParameter()
        op = p.operation.upper()
        if op == "PROD":
            y = bottoms[0]
            for b in bottoms[1:]:
                y = y * b
        elif op == "SUM":
            coeffs = list(p.coeff) or [1.0] * len(bottoms)
            if len(coeffs) != len(bottoms):
                raise ValueError(
                    f"Eltwise {self.name!r}: {len(coeffs)} coeffs for "
                    f"{len(bottoms)} bottoms (must match or be omitted)"
                )
            y = coeffs[0] * bottoms[0]
            for c, b in zip(coeffs[1:], bottoms[1:]):
                y = y + c * b
        elif op == "MAX":
            y = bottoms[0]
            for b in bottoms[1:]:
                y = torch.maximum(y, b)
        else:
            raise ValueError(f"unknown eltwise op {p.operation!r}")
        return [y], None


@register
class Tile(Layer):
    TYPE = "Tile"

    def out_shapes(self, bottom_shapes):
        p = self.lp.tile_param
        s = list(bottom_shapes[0])
        s[p.axis % len(s)] *= p.tiles
        return [tuple(s)]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.tile_param
        x = bottoms[0]
        reps = [1] * x.dim()
        reps[p.axis % x.dim()] = p.tiles
        _refuse_batch_axis(self, p.axis % x.dim())
        return [x.repeat(reps)], None


@register
class Reduction(Layer):
    """Reduce the trailing axes from ``axis`` (``reduction_layer.cpp``):
    SUM | ASUM | SUMSQ | MEAN, scaled by coeff.  With ``axis`` 0 under a
    data-parallel step the top is this rank's share of the global value
    (a MEAN divides by the global count), as a loss layer's is."""

    TYPE = "Reduction"

    def out_shapes(self, bottom_shapes):
        p = self.lp.reduction_param
        axis = (p.axis if p else 0) % len(bottom_shapes[0])
        return [tuple(bottom_shapes[0][:axis])]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.reduction_param or ReductionParameter()
        x = bottoms[0]
        axes = tuple(range(p.axis % x.dim(), x.dim()))
        op = p.operation.upper()
        if op == "SUM":
            y = x.sum(dim=axes)
        elif op == "ASUM":
            y = x.abs().sum(dim=axes)
        elif op == "SUMSQ":
            y = (x * x).sum(dim=axes)
        elif op == "MEAN":
            shard = dp.current()
            if shard is not None and axes[0] == 0:
                # the mean over the global batch; this rank's share
                y = x.sum(dim=axes) / float(shard.global_rows(x.numel()))
            else:
                y = x.mean(dim=axes)
        else:
            raise ValueError(f"unknown reduction {p.operation!r}")
        return [p.coeff * y], None


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the top ``k`` along the last axis, largest
    first (ties: the lower index first, as ``lax.top_k``)."""
    if k == 1:
        idx = torch.argmax(x, dim=-1, keepdim=True)
        return torch.gather(x, -1, idx), idx
    return torch.topk(x, k, dim=-1, sorted=True)


@register
class ArgMax(Layer):
    """Top-k indices (and optionally values) over the channel axis
    (``argmax_layer.cpp``)."""

    TYPE = "ArgMax"

    def out_shapes(self, bottom_shapes):
        p = self.lp.argmax_param or ArgMaxParameter()
        s = bottom_shapes[0]
        if p.axis is not None:
            out = list(s)
            out[p.axis % len(s)] = p.top_k
            return [tuple(out)]
        return [(s[0], 2 if p.out_max_val else 1, p.top_k)]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.argmax_param or ArgMaxParameter()
        x = bottoms[0]
        if p.axis is not None:
            axis = p.axis % x.dim()
            vals, idx = _top_k(torch.movedim(x, axis, -1), p.top_k)
            out = vals if p.out_max_val else idx.to(x.dtype)
            return [torch.movedim(out, -1, axis)], None
        vals, idx = _top_k(x.reshape(x.shape[0], -1), p.top_k)
        idxf = idx.to(x.dtype)
        if p.out_max_val:
            return [torch.stack([idxf, vals], dim=1)], None
        return [idxf[:, None, :]], None


@register
class Embed(Layer):
    """Embedding lookup; weight blob ``(input_dim, num_output)``
    (``embed_layer.cpp``)."""

    TYPE = "Embed"

    def blob_defs(self, bottom_shapes):
        p = self.lp.embed_param
        defs = [BlobDef((p.input_dim, p.num_output), p.weight_filler,
                        *_mults(self.lp, 0))]
        if p.bias_term:
            defs.append(BlobDef(
                (p.num_output,), p.bias_filler or FillerParameter(type="constant"),
                *_mults(self.lp, 1)))
        return defs

    def out_shapes(self, bottom_shapes):
        return [tuple(bottom_shapes[0]) + (self.lp.embed_param.num_output,)]

    def apply(self, blobs, bottoms, rng, train):
        y = blobs[0][bottoms[0].to(torch.int64)]
        if self.lp.embed_param.bias_term:
            y = y + blobs[1]
        return [y], None


@register
class BatchReindex(Layer):
    """Gather rows of bottom[0] by the index blob bottom[1]
    (``batch_reindex_layer.cpp``)."""

    TYPE = "BatchReindex"

    def out_shapes(self, bottom_shapes):
        return [(bottom_shapes[1][0],) + tuple(bottom_shapes[0][1:])]

    def apply(self, blobs, bottoms, rng, train):
        _refuse_batch_axis(self, 0)
        return [bottoms[0][bottoms[1].reshape(-1).to(torch.int64)]], None


@register
class Silence(Layer):
    """Consumes bottoms, produces nothing (``silence_layer.cpp``)."""

    TYPE = "Silence"

    def out_shapes(self, bottom_shapes):
        return []

    def apply(self, blobs, bottoms, rng, train):
        return [], None


@register
class Filter(Layer):
    """The JAX package's static-shape Filter: unselected items are zeroed,
    not dropped (its documented deviation from ``filter_layer.cpp``)."""

    TYPE = "Filter"

    def out_shapes(self, bottom_shapes):
        return list(bottom_shapes[:-1])

    def apply(self, blobs, bottoms, rng, train):
        sel = bottoms[-1].reshape(-1)
        outs = []
        for b in bottoms[:-1]:
            mask = sel.reshape((-1,) + (1,) * (b.dim() - 1)) > 0
            outs.append(b * mask)
        return outs, None


@register
class Python(Layer):
    """User-defined layers (``python_layer.hpp`` + ``PythonParameter``):
    ``python_param.module``/``layer`` name a class implementing the
    port's Layer contract (``blob_defs``/``out_shapes``/``apply``);
    ``param_str`` reaches it as ``self.lp.python_param.param_str``.
    Construction dispatches straight to the user class."""

    TYPE = "Python"

    def __new__(cls, lp, phase):
        p = lp.python_param
        if not (p and p.module and p.layer):
            raise ValueError(
                f"layer {lp.name!r}: Python layers need python_param "
                "{ module: ... layer: ... }"
            )
        try:
            mod = importlib.import_module(p.module)
        except ImportError as e:
            raise ValueError(
                f"layer {lp.name!r}: cannot import python_param module "
                f"{p.module!r}: {e}"
            ) from e
        ucls = getattr(mod, p.layer, None)
        if not (isinstance(ucls, type) and issubclass(ucls, Layer)):
            raise TypeError(
                f"layer {lp.name!r}: {p.module}.{p.layer} must be a "
                "sparknet_tpu_torch.ops.base.Layer subclass"
            )
        return ucls(lp, phase)
