"""Vision layers: convolution, deconvolution, pooling, LRN, im2col, SPP.

The port of ``sparknet_tpu/ops/vision.py``, with the reference's shape
arithmetic and numerics: floor conv shapes, Caffe's ceil-mode pooling
with the boundary-window clip, AVE-pool divisors that count the padded
ring but not the ceil extension, STOCHASTIC pooling, and both LRN
regions (``pooling_layer.cpp``, ``lrn_layer.cpp``).  NCHW activations,
OIHW weights — the JAX layout.

ACROSS_CHANNELS goes to ``cuda_lrn.lrn_across_channels``: K5 forward
and K6 backward on a CUDA tensor, their plain version on a CPU tensor
(``SPARKNET_PALLAS_LRN`` of the JAX package has nothing left to choose
here).  WITHIN_CHANNEL is plain PyTorch through the AVE-pool path.  The
JAX package's opt-in space-to-depth stem lowering (``SPARKNET_S2D``) is
not ported: it is the same convolution re-bracketed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.config.schema import FillerParameter, LRNParameter
from sparknet_tpu_torch.ops import cuda_lrn
from sparknet_tpu_torch.ops.base import BlobDef, Layer, register
from sparknet_tpu_torch.utils import rngs


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


class _ConvBase(Layer):
    """What Convolution, Deconvolution and Im2col share: the geometry of
    ``convolution_param`` and the blob multipliers."""

    def _geometry(self):
        cp = self.lp.convolution_param
        kh, kw = _pair(cp.kernel_size, cp.kernel_h, cp.kernel_w, 0)
        sh, sw = _pair(cp.stride, cp.stride_h, cp.stride_w, 1)
        ph, pw = _pair(cp.pad, cp.pad_h, cp.pad_w, 0)
        dh, dw = _pair(cp.dilation, 0, 0, 1)
        if kh <= 0 or kw <= 0:
            raise ValueError(f"layer {self.name!r}: kernel_size required")
        return (kh, kw), (sh, sw), (ph, pw), (dh, dw)

    def _blob_defs(self, wshape):
        cp = self.lp.convolution_param
        ps = self.lp.param
        w = ps[0] if len(ps) > 0 else None
        b = ps[1] if len(ps) > 1 else None
        defs = [BlobDef(wshape, cp.weight_filler,
                        w.lr_mult if w else 1.0, w.decay_mult if w else 1.0)]
        if cp.bias_term:
            defs.append(BlobDef(
                (cp.num_output,),
                cp.bias_filler or FillerParameter(type="constant"),
                b.lr_mult if b else 1.0, b.decay_mult if b else 1.0))
        return defs

    def _groups(self, in_c):
        cp = self.lp.convolution_param
        group = max(1, cp.group)
        if in_c % group or cp.num_output % group:
            raise ValueError(f"layer {self.name!r}: channels not divisible by group")
        return group

    def _checked(self, oh, ow, h, w):
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"layer {self.name!r}: output {oh}x{ow} non-positive for "
                f"input {h}x{w}"
            )
        return oh, ow

    def _conv_out_hw(self, h, w):
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = self._geometry()
        return self._checked((h + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1,
                             (w + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1, h, w)


@register
class Convolution(_ConvBase):
    """2-D convolution: weight blob ``(num_output, in_c/group, kh, kw)``,
    output ``floor((in + 2p - ((k-1)*d + 1)) / s) + 1``."""

    TYPE = "Convolution"

    def blob_defs(self, bottom_shapes):
        cp = self.lp.convolution_param
        (kh, kw), _, _, _ = self._geometry()
        in_c = bottom_shapes[0][1]
        return self._blob_defs(
            (cp.num_output, in_c // self._groups(in_c), kh, kw))

    def out_shapes(self, bottom_shapes):
        n, _, h, w = bottom_shapes[0]
        return [(n, self.lp.convolution_param.num_output)
                + self._conv_out_hw(h, w)]

    def apply(self, blobs, bottoms, rng, train):
        cp = self.lp.convolution_param
        _, stride, pad, dil = self._geometry()
        y = F.conv2d(bottoms[0], blobs[0], None, stride, pad, dil,
                     max(1, cp.group))
        if cp.bias_term:
            y = y + blobs[1][None, :, None, None]
        return [y], None


@register
class Deconvolution(_ConvBase):
    """Transposed convolution, the adjoint of Convolution: weight blob
    ``(in_c, num_output/group, kh, kw)``, output ``s*(in-1) + (k-1)*d + 1
    - 2p`` (``deconv_layer.cpp``)."""

    TYPE = "Deconvolution"

    def blob_defs(self, bottom_shapes):
        cp = self.lp.convolution_param
        (kh, kw), _, _, _ = self._geometry()
        in_c = bottom_shapes[0][1]
        return self._blob_defs(
            (in_c, cp.num_output // self._groups(in_c), kh, kw))

    def out_shapes(self, bottom_shapes):
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = self._geometry()
        n, _, h, w = bottom_shapes[0]
        oh, ow = self._checked(sh * (h - 1) + (kh - 1) * dh + 1 - 2 * ph,
                               sw * (w - 1) + (kw - 1) * dw + 1 - 2 * pw, h, w)
        return [(n, self.lp.convolution_param.num_output, oh, ow)]

    def apply(self, blobs, bottoms, rng, train):
        cp = self.lp.convolution_param
        _, stride, pad, dil = self._geometry()
        y = F.conv_transpose2d(bottoms[0], blobs[0], None, stride, pad, 0,
                               max(1, cp.group), dil)
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


def _windows(x, kernel, stride, pad, out_hw):
    """Every pooling window's entries: (n, c, kh*kw, oh, ow), the pad ring
    and the ceil extension zero."""
    (kh, kw), (sh, sw), (ph, pw), (oh, ow) = kernel, stride, pad, out_hw
    n, c, h, w = x.shape
    hi_h = max(0, (oh - 1) * sh + kh - h - ph)
    hi_w = max(0, (ow - 1) * sw + kw - w - pw)
    xp = F.pad(x, (pw, hi_w, ph, hi_h))
    cols = F.unfold(xp, (kh, kw), stride=(sh, sw))
    ph_, pw_ = (xp.shape[2] - kh) // sh + 1, (xp.shape[3] - kw) // sw + 1
    return cols.reshape(n, c, kh * kw, ph_, pw_)[..., :oh, :ow]


def stochastic_pool(x, kernel, stride, pad, out_hw, rng, train):
    """STOCHASTIC pooling (the reference's CUDA-only mode): in TEST the
    activation-weighted average of each window; in TRAIN one entry of the
    window drawn with probability proportional to its (ReLU'd) value,
    the uniforms drawn on the CPU from ``rngs.generator(rng)`` (so one key
    gives one draw on any device; the JAX package draws another stream,
    the same distribution)."""
    patches = torch.relu(_windows(x, kernel, stride, pad, out_hw))
    total = patches.sum(dim=2, keepdim=True)
    prob = torch.where(total > 0, patches / torch.clamp_min(total, 1e-12),
                       torch.zeros_like(patches))
    if not train:
        return (prob * patches).sum(dim=2)
    if rng is None:
        raise ValueError("stochastic pooling needs an rng in train mode")
    n, c, k, oh, ow = patches.shape
    g = torch.rand((n, c, 1, oh, ow), generator=rngs.generator(rng),
                   dtype=x.dtype).to(x.device)
    idx = (torch.cumsum(prob, dim=2) < g).sum(dim=2, keepdim=True)
    return torch.gather(patches, 2, idx.clamp(0, k - 1))[:, :, 0]


@register
class Pooling(Layer):
    """MAX / AVE / STOCHASTIC pooling (``pooling_layer.cpp``)."""

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
            return [stochastic_pool(x, *geom, rng, train)], None
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


@register
class Im2col(_ConvBase):
    """Explicit patch extraction (``im2col_layer.cpp``): (N, C*kh*kw, oh,
    ow), channel-major."""

    TYPE = "Im2col"

    def out_shapes(self, bottom_shapes):
        (kh, kw), _, _, _ = self._geometry()
        n, c, h, w = bottom_shapes[0]
        return [(n, c * kh * kw) + self._conv_out_hw(h, w)]

    def apply(self, blobs, bottoms, rng, train):
        kernel, stride, pad, dil = self._geometry()
        x = bottoms[0]
        n, c, h, w = x.shape
        oh, ow = self._conv_out_hw(h, w)
        cols = F.unfold(x, kernel, dilation=dil, padding=pad, stride=stride)
        return [cols.reshape(n, -1, oh, ow)], None


@register
class SPP(Layer):
    """Spatial pyramid pooling (``spp_layer.cpp``): level i pools into a
    2^i x 2^i grid; the flattened levels concatenate along channels."""

    TYPE = "SPP"

    def _levels(self, h, w):
        levels = []
        for i in range(self.lp.spp_param.pyramid_height):
            bins = 2**i
            kh, kw = int(math.ceil(h / bins)), int(math.ceil(w / bins))
            ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
            levels.append((bins, (kh, kw), (kh, kw), (ph, pw)))
        return levels

    def out_shapes(self, bottom_shapes):
        n, c, h, w = bottom_shapes[0]
        return [(n, sum(b * b * c for b, _, _, _ in self._levels(h, w)))]

    def apply(self, blobs, bottoms, rng, train):
        x = bottoms[0]
        n, _, h, w = x.shape
        pool = (caffe_avg_pool if self.lp.spp_param.pool.upper() == "AVE"
                else caffe_max_pool)
        outs = []
        for bins, kernel, stride, pad in self._levels(h, w):
            _, _, _, out_hw = _pool_geometry(
                _PoolGeom(kernel[0], stride[0], pad[0]), h, w)
            y = pool(x, kernel, stride, pad, out_hw)[:, :, :bins, :bins]
            outs.append(y.reshape(n, -1))
        return [torch.cat(outs, dim=1)], None
