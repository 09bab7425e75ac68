"""Analytic model-FLOP counting for MFU reporting.

The port of ``sparknet_tpu/utils/flops.py``, over ``TorchNet``'s blob
shapes.  The convention is the JAX package's: count the convolutions and
matmuls (a multiply-accumulate is 2 FLOPs, the bias counted), ignore
the elementwise and normalization tails, run a Deconvolution's GEMM over
its input extent, and charge the backward at 2x the forward (the input
gradient and the weight gradient each cost one forward).
"""

from __future__ import annotations


def _conv_flops(net, layer) -> float:
    lp = layer.lp
    cp = lp.convolution_param
    (n, c, _, _) = net.blob_shapes[lp.bottom[0]]
    out = net.blob_shapes[lp.top[0]]
    if lp.type == "Deconvolution":
        # the GEMM runs over the input's spatial extent
        _, k, _, _ = out
        _, _, oh, ow = net.blob_shapes[lp.bottom[0]]
    else:
        _, k, oh, ow = out
    g = max(1, cp.group)
    (kh, kw), _, _, _ = layer._geometry()
    macs = n * oh * ow * k * (c // g) * kh * kw
    if cp.bias_term:
        macs += n * k * oh * ow
    return 2.0 * macs


def _ip_flops(net, layer) -> float:
    lp = layer.lp
    bshape = net.blob_shapes[lp.bottom[0]]
    p = lp.inner_product_param
    axis = p.axis if p.axis >= 0 else len(bshape) + p.axis
    n = 1
    for d in bshape[:axis]:
        n *= d
    fan_in = 1
    for d in bshape[axis:]:
        fan_in *= d
    macs = n * fan_in * p.num_output
    if p.bias_term:
        macs += n * p.num_output
    return 2.0 * macs


def forward_flops(net) -> float:
    """FLOPs of one forward pass at the net's static shapes."""
    total = 0.0
    for layer in net.layers:
        t = layer.lp.type
        if t in ("Convolution", "Deconvolution"):
            total += _conv_flops(net, layer)
        elif t == "InnerProduct":
            total += _ip_flops(net, layer)
    return total


def train_flops(net) -> float:
    """Forward + backward (2x forward) per training iteration."""
    return 3.0 * forward_flops(net)
