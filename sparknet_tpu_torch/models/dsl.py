"""Programmatic net-definition DSL.

The port's own copy of ``sparknet_tpu/models/dsl.py``.  The Scala driver
builds nets from constructor sugar (reference:
``src/main/scala/libs/Layers.scala:18-137`` — RDDLayer, ConvolutionLayer,
PoolingLayer, InnerProductLayer, ReLULayer, SoftmaxWithLoss, NetParam);
the same shape here, extended to the ops a modern model zoo needs.  Every
helper returns a LayerParameter and ``net_param(...)`` assembles the
NetParameter, so a builder here gives the JAX builder's NetParameter.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from sparknet_tpu_torch.config.schema import (
    AccuracyParameter,
    AttentionParameter,
    BlobShape,
    ConcatParameter,
    ConvolutionParameter,
    DropoutParameter,
    EltwiseParameter,
    FillerParameter,
    InnerProductParameter,
    JavaDataParameter,
    LayerParameter,
    LRNParameter,
    NetParameter,
    NetStateRule,
    ParamSpec,
    PoolingParameter,
    ReLUParameter,
    ScaleParameter,
    SoftmaxParameter,
)


def _filler(spec) -> Optional[FillerParameter]:
    if spec is None:
        return None
    if isinstance(spec, FillerParameter):
        return spec
    if isinstance(spec, str):
        return FillerParameter(type=spec)
    if isinstance(spec, dict):
        return FillerParameter(**spec)
    raise TypeError(f"bad filler spec {spec!r}")


def _include(phase: Optional[str]):
    return [NetStateRule(phase=phase)] if phase else []


def host_data_layer(
    name: str, tops: Sequence[str], shapes: Sequence[Sequence[int]], phase=None
) -> LayerParameter:
    """The RDDLayer analog (Layers.scala:18-41): a host-fed data layer with
    declared batch shapes."""
    return LayerParameter(
        name=name,
        type="HostData",
        top=list(tops),
        include=_include(phase),
        java_data_param=JavaDataParameter(
            shape=[BlobShape(dim=list(map(int, s))) for s in shapes]
        ),
    )


# Layers.scala name kept as an alias
rdd_layer = host_data_layer


def conv_layer(
    name: str,
    bottom: str,
    num_output: int,
    kernel: Union[int, Sequence[int]],
    stride: int = 1,
    pad: int = 0,
    group: int = 1,
    dilation: int = 1,
    bias_term: bool = True,
    weight_filler="xavier",
    bias_filler="constant",
    lr_mults: Sequence[float] = (1.0, 2.0),
    decay_mults: Sequence[float] = (1.0, 0.0),
    top: Optional[str] = None,
) -> LayerParameter:
    kernel = [kernel] if isinstance(kernel, int) else list(kernel)
    return LayerParameter(
        name=name,
        type="Convolution",
        bottom=[bottom],
        top=[top or name],
        param=[
            ParamSpec(lr_mult=lr_mults[0], decay_mult=decay_mults[0]),
            ParamSpec(lr_mult=lr_mults[1], decay_mult=decay_mults[1]),
        ][: 2 if bias_term else 1],
        convolution_param=ConvolutionParameter(
            num_output=num_output,
            kernel_size=kernel,
            stride=[stride],
            pad=[pad],
            group=group,
            dilation=[dilation],
            bias_term=bias_term,
            weight_filler=_filler(weight_filler),
            bias_filler=_filler(bias_filler),
        ),
    )


def pool_layer(
    name: str,
    bottom: str,
    kernel: int,
    stride: int = 1,
    pad: int = 0,
    method: str = "MAX",
    global_pooling: bool = False,
    top: Optional[str] = None,
) -> LayerParameter:
    return LayerParameter(
        name=name,
        type="Pooling",
        bottom=[bottom],
        top=[top or name],
        pooling_param=PoolingParameter(
            pool=method,
            kernel_size=kernel,
            stride=stride,
            pad=pad,
            global_pooling=global_pooling,
        ),
    )


def ip_layer(
    name: str,
    bottom: str,
    num_output: int,
    weight_filler="xavier",
    bias_filler="constant",
    lr_mults: Sequence[float] = (1.0, 2.0),
    decay_mults: Sequence[float] = (1.0, 0.0),
    top: Optional[str] = None,
) -> LayerParameter:
    return LayerParameter(
        name=name,
        type="InnerProduct",
        bottom=[bottom],
        top=[top or name],
        param=[
            ParamSpec(lr_mult=lr_mults[0], decay_mult=decay_mults[0]),
            ParamSpec(lr_mult=lr_mults[1], decay_mult=decay_mults[1]),
        ],
        inner_product_param=InnerProductParameter(
            num_output=num_output,
            weight_filler=_filler(weight_filler),
            bias_filler=_filler(bias_filler),
        ),
    )


def relu_layer(name: str, bottom: str, negative_slope: float = 0.0, top=None):
    return LayerParameter(
        name=name,
        type="ReLU",
        bottom=[bottom],
        top=[top or bottom],  # in-place by default, like the reference nets
        relu_param=ReLUParameter(negative_slope=negative_slope),
    )


def lrn_layer(
    name: str,
    bottom: str,
    local_size: int = 5,
    alpha: float = 1e-4,
    beta: float = 0.75,
    norm_region: str = "ACROSS_CHANNELS",
    top=None,
):
    return LayerParameter(
        name=name,
        type="LRN",
        bottom=[bottom],
        top=[top or name],
        lrn_param=LRNParameter(
            local_size=local_size, alpha=alpha, beta=beta, norm_region=norm_region
        ),
    )


def dropout_layer(name: str, bottom: str, ratio: float = 0.5, top=None):
    return LayerParameter(
        name=name,
        type="Dropout",
        bottom=[bottom],
        top=[top or bottom],
        dropout_param=DropoutParameter(dropout_ratio=ratio),
    )


def batch_norm_layer(name: str, bottom: str, top=None):
    return LayerParameter(
        name=name,
        type="BatchNorm",
        bottom=[bottom],
        top=[top or name],
        param=[ParamSpec(lr_mult=0.0), ParamSpec(lr_mult=0.0), ParamSpec(lr_mult=0.0)],
    )


def scale_layer(name: str, bottom: str, bias: bool = True, top=None):
    return LayerParameter(
        name=name,
        type="Scale",
        bottom=[bottom],
        top=[top or bottom],
        scale_param=ScaleParameter(
            bias_term=bias, filler=FillerParameter(type="constant", value=1.0)
        ),
    )


def eltwise_layer(name: str, bottoms: Sequence[str], operation="SUM", top=None):
    return LayerParameter(
        name=name,
        type="Eltwise",
        bottom=list(bottoms),
        top=[top or name],
        eltwise_param=EltwiseParameter(operation=operation),
    )


def concat_layer(name: str, bottoms: Sequence[str], axis: int = 1, top=None):
    return LayerParameter(
        name=name,
        type="Concat",
        bottom=list(bottoms),
        top=[top or name],
        concat_param=ConcatParameter(axis=axis),
    )


def softmax_loss_layer(
    name: str, bottom: str, label: str = "label", phase: Optional[str] = None
):
    # default: active in BOTH phases, like the reference DSL's
    # SoftmaxWithLoss (Layers.scala:115-126 sets no include rule)
    return LayerParameter(
        name=name,
        type="SoftmaxWithLoss",
        bottom=[bottom, label],
        top=[name],
        include=_include(phase),
    )


def softmax_layer(name: str, bottom: str, top=None):
    return LayerParameter(
        name=name,
        type="Softmax",
        bottom=[bottom],
        top=[top or name],
        softmax_param=SoftmaxParameter(),
    )


def accuracy_layer(
    name: str,
    bottom: str,
    label: str = "label",
    top_k: int = 1,
    phase: Optional[str] = "TEST",
):
    return LayerParameter(
        name=name,
        type="Accuracy",
        bottom=[bottom, label],
        top=[name],
        include=_include(phase),
        accuracy_param=AccuracyParameter(top_k=top_k),
    )


def attention_layer(
    name: str,
    bottom: str,
    num_heads: int,
    head_dim: int = 0,
    causal: bool = False,
    block_size: int = 512,
    top=None,
):
    """Multi-head self-attention over a (B, T, E) bottom (an extension
    layer, ``ops/attention.py`` ``Attention``: the flash kernels K1 and
    K3/K4 on the card)."""
    return LayerParameter(
        name=name,
        type="Attention",
        bottom=[bottom],
        top=[top or name],
        attention_param=AttentionParameter(
            num_heads=num_heads,
            head_dim=head_dim,
            causal=causal,
            block_size=block_size,
        ),
    )


def net_param(name: str, *layers: LayerParameter) -> NetParameter:
    """NetParam analog (Layers.scala:130-137)."""
    flat: List[LayerParameter] = []
    for l in layers:
        if isinstance(l, (list, tuple)):
            flat.extend(l)
        else:
            flat.append(l)
    return NetParameter(name=name, layer=flat)
