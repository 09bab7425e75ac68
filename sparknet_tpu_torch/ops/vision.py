"""Vision layers: convolution, Caffe ceil-mode pooling, LRN.

The port of ``Convolution``, ``Pooling`` (MAX and AVE) and ``LRN`` of
``sparknet_tpu/ops/vision.py``, with the reference's shape arithmetic
and numerics: floor conv shapes, Caffe's ceil-mode pooling with the
boundary-window clip, AVE-pool divisors that count the padded ring but
not the ceil extension, and both LRN regions (``pooling_layer.cpp``,
``lrn_layer.cpp``).  NCHW activations, OIHW weights — the JAX layout.

ACROSS_CHANNELS goes to ``cuda_lrn.lrn_across_channels``: K5 forward
and K6 backward on a CUDA tensor, their plain version on a CPU tensor
(``SPARKNET_PALLAS_LRN`` of the JAX package has nothing left to choose
here).  WITHIN_CHANNEL is plain PyTorch through the AVE-pool path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.config.schema import FillerParameter, LRNParameter
from sparknet_tpu_torch.ops import cuda_lrn
from sparknet_tpu_torch.ops.base import BlobDef, Layer, register


def _pair(lst, h_val, w_val, default):
    """Resolve Caffe's repeated-or-h/w spatial params to an (h, w) pair."""
    if h_val or w_val:
        return int(h_val or default), int(w_val or default)
    if isinstance(lst, int):
        return (int(lst or default),) * 2 if lst or default else (default, default)
    if not lst:
        return default, default
    if len(lst) == 1:
        return int(lst[0]), int(lst[0])
    return int(lst[0]), int(lst[1])


@register
class Convolution(Layer):
    """2-D convolution: weight blob ``(num_output, in_c/group, kh, kw)``,
    output ``floor((in + 2p - ((k-1)*d + 1)) / s) + 1``."""

    TYPE = "Convolution"

    def _geometry(self):
        cp = self.lp.convolution_param
        kh, kw = _pair(cp.kernel_size, cp.kernel_h, cp.kernel_w, 0)
        sh, sw = _pair(cp.stride, cp.stride_h, cp.stride_w, 1)
        ph, pw = _pair(cp.pad, cp.pad_h, cp.pad_w, 0)
        dh, dw = _pair(cp.dilation, 0, 0, 1)
        if kh <= 0 or kw <= 0:
            raise ValueError(f"layer {self.name!r}: kernel_size required")
        return (kh, kw), (sh, sw), (ph, pw), (dh, dw)

    def blob_defs(self, bottom_shapes):
        cp = self.lp.convolution_param
        (kh, kw), _, _, _ = self._geometry()
        in_c = bottom_shapes[0][1]
        group = max(1, cp.group)
        if in_c % group or cp.num_output % group:
            raise ValueError(f"layer {self.name!r}: channels not divisible by group")
        ps = self.lp.param
        w = ps[0] if len(ps) > 0 else None
        b = ps[1] if len(ps) > 1 else None
        defs = [
            BlobDef(
                (cp.num_output, in_c // group, kh, kw), cp.weight_filler,
                w.lr_mult if w else 1.0, w.decay_mult if w else 1.0,
            )
        ]
        if cp.bias_term:
            defs.append(
                BlobDef(
                    (cp.num_output,),
                    cp.bias_filler or FillerParameter(type="constant"),
                    b.lr_mult if b else 1.0, b.decay_mult if b else 1.0,
                )
            )
        return defs

    def out_shapes(self, bottom_shapes):
        cp = self.lp.convolution_param
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = self._geometry()
        n, _, h, w = bottom_shapes[0]
        oh = (h + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
        ow = (w + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"layer {self.name!r}: output {oh}x{ow} non-positive for "
                f"input {h}x{w}"
            )
        return [(n, cp.num_output, oh, ow)]

    def apply(self, blobs, bottoms, rng, train):
        cp = self.lp.convolution_param
        _, stride, pad, dil = self._geometry()
        y = F.conv2d(bottoms[0], blobs[0], None, stride, pad, dil,
                     max(1, cp.group))
        if cp.bias_term:
            y = y + blobs[1][None, :, None, None]
        return [y], None


def _pool_geometry(pp, h, w):
    if pp.global_pooling:
        kh, kw = h, w
        sh = sw = 1
        ph = pw = 0
    else:
        kh, kw = _pair(pp.kernel_size, pp.kernel_h, pp.kernel_w, 0)
        sh, sw = _pair(pp.stride, pp.stride_h, pp.stride_w, 1)
        ph, pw = _pair(pp.pad, pp.pad_h, pp.pad_w, 0)
        if kh <= 0 or kw <= 0:
            raise ValueError("pooling kernel_size required")
    oh = int(math.ceil((h + 2 * ph - kh) / sh)) + 1
    ow = int(math.ceil((w + 2 * pw - kw) / sw)) + 1
    if ph or pw:
        # last window must start strictly inside image+pad
        # (reference: pooling_layer.cpp LayerSetUp clip)
        if (oh - 1) * sh >= h + ph:
            oh -= 1
        if (ow - 1) * sw >= w + pw:
            ow -= 1
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"pooling kernel {kh}x{kw} stride {sh}x{sw} pad {ph}x{pw} "
            f"yields non-positive output for input {h}x{w}"
        )
    return (kh, kw), (sh, sw), (ph, pw), (oh, ow)


def caffe_max_pool(x, kernel, stride, pad, out_hw):
    """Ceil-mode max pooling over NCHW, Caffe shape semantics: the
    windows past the image (the ceil extension) see -inf."""
    (kh, kw), (sh, sw), (ph, pw), (oh, ow) = kernel, stride, pad, out_hw
    h, w = x.shape[2], x.shape[3]
    hi_h = max(0, (oh - 1) * sh + kh - h - ph)
    hi_w = max(0, (ow - 1) * sw + kw - w - pw)
    xp = F.pad(x, (pw, hi_w, ph, hi_h), value=float("-inf"))
    return F.max_pool2d(xp, (kh, kw), (sh, sw))


def _window_sums(x, kernel, stride, pads):
    """Sum over each (kh, kw) window of ``x`` zero-padded by ``pads``
    (left_w, right_w, top_h, bottom_h)."""
    return F.avg_pool2d(F.pad(x, pads), kernel, stride, divisor_override=1)


def caffe_avg_pool(x, kernel, stride, pad, out_hw):
    """Ceil-mode average pooling; the divisor counts window positions
    inside the pad-extended image (border averages include the zero pad
    ring but not the ceil extension), as the reference does."""
    (kh, kw), (sh, sw), (ph, pw), (oh, ow) = kernel, stride, pad, out_hw
    h, w = x.shape[2], x.shape[3]
    hi_h = max(0, (oh - 1) * sh + kh - h - ph)
    hi_w = max(0, (ow - 1) * sw + kw - w - pw)
    s = _window_sums(x, (kh, kw), (sh, sw), (pw, hi_w, ph, hi_h))
    ones = torch.ones((1, 1, h + 2 * ph, w + 2 * pw), dtype=x.dtype,
                      device=x.device)
    div = _window_sums(ones, (kh, kw), (sh, sw),
                       (0, max(0, hi_w - pw), 0, max(0, hi_h - ph)))
    return s / div


@register
class Pooling(Layer):
    """MAX / AVE pooling (reference: ``pooling_layer.cpp``)."""

    TYPE = "Pooling"

    def out_shapes(self, bottom_shapes):
        n, c, h, w = bottom_shapes[0]
        _, _, _, (oh, ow) = _pool_geometry(self.lp.pooling_param, h, w)
        return [(n, c, oh, ow)]

    def apply(self, blobs, bottoms, rng, train):
        pp = self.lp.pooling_param
        x = bottoms[0]
        geom = _pool_geometry(pp, x.shape[2], x.shape[3])
        method = pp.pool.upper()
        if method == "MAX":
            return [caffe_max_pool(x, *geom)], None
        if method == "AVE":
            return [caffe_avg_pool(x, *geom)], None
        if method == "STOCHASTIC":
            raise NotImplementedError(
                "STOCHASTIC pooling is not yet ported to sparknet_tpu_torch"
            )
        raise ValueError(f"unknown pool method {pp.pool!r}")


class _PoolGeom:
    """Minimal pooling_param stand-in for reusing _pool_geometry."""

    def __init__(self, k, s, p):
        self.global_pooling = False
        self.kernel_size, self.kernel_h, self.kernel_w = k, 0, 0
        self.stride, self.stride_h, self.stride_w = s, 0, 0
        self.pad, self.pad_h, self.pad_w = p, 0, 0


@register
class LRN(Layer):
    """Local response normalization, both norm regions (reference:
    ``lrn_layer.cpp``).  ACROSS_CHANNELS divides alpha by local_size;
    WITHIN_CHANNEL is ``x * (1 + alpha * avgpool(x^2))^-beta`` through
    the AVE-pool path."""

    TYPE = "LRN"

    def out_shapes(self, bottom_shapes):
        return [bottom_shapes[0]]

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.lrn_param or LRNParameter()
        x = bottoms[0]
        n = p.local_size
        if p.norm_region.upper() == "ACROSS_CHANNELS":
            return [cuda_lrn.lrn_across_channels(x, n, p.alpha, p.beta, p.k)], None
        # WITHIN_CHANNEL: average pool of squares over an n x n window,
        # stride 1, Caffe-pad (n-1)/2
        pad = (n - 1) // 2
        _, _, _, out_hw = _pool_geometry(
            _PoolGeom(n, 1, pad), x.shape[2], x.shape[3]
        )
        avg = caffe_avg_pool(x * x, (n, n), (1, 1), (pad, pad), out_hw)
        scale = 1.0 + p.alpha * avg
        return [x * torch.pow(scale, -p.beta)], None
