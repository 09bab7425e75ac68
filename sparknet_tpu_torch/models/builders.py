"""Programmatic builders of the port's zoo: CaffeNet.

The port of ``caffenet`` of ``sparknet_tpu/models/builders.py``
(reference: ``caffe/models/bvlc_reference_caffenet``): AlexNet with
pool-before-norm, so its LRNs run K5/K6 unfused (``norm1`` and ``norm2``
read a pooled tensor that nothing pools again).  The layers are built
as the JAX package's DSL builds them (``models/dsl.py``): weight lr/decay
multipliers (1, 1) and bias (2, 0), in-place ReLU and Dropout.  The JAX
builders of GoogLeNet and ResNet-50 are not yet ported.
"""

from __future__ import annotations

from typing import List

from sparknet_tpu_torch.config.schema import (
    AccuracyParameter,
    BlobShape,
    ConvolutionParameter,
    DropoutParameter,
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
)


def _gauss(std: float) -> FillerParameter:
    return FillerParameter(type="gaussian", std=std)


def _const(value: float = 0.0) -> FillerParameter:
    return FillerParameter(type="constant", value=value)


def _mults() -> List[ParamSpec]:
    return [ParamSpec(lr_mult=1.0, decay_mult=1.0),
            ParamSpec(lr_mult=2.0, decay_mult=0.0)]


def _conv(name, bottom, n, k, s=1, p=0, g=1, bias=0.0) -> LayerParameter:
    return LayerParameter(
        name=name, type="Convolution", bottom=[bottom], top=[name],
        param=_mults(),
        convolution_param=ConvolutionParameter(
            num_output=n, kernel_size=[k], stride=[s], pad=[p], group=g,
            dilation=[1], weight_filler=_gauss(0.01), bias_filler=_const(bias),
        ),
    )


def _relu(name, bottom) -> LayerParameter:
    return LayerParameter(name=name, type="ReLU", bottom=[bottom],
                          top=[bottom], relu_param=ReLUParameter())


def _pool(name, bottom) -> LayerParameter:
    return LayerParameter(
        name=name, type="Pooling", bottom=[bottom], top=[name],
        pooling_param=PoolingParameter(pool="MAX", kernel_size=3, stride=2),
    )


def _lrn(name, bottom) -> LayerParameter:
    return LayerParameter(
        name=name, type="LRN", bottom=[bottom], top=[name],
        lrn_param=LRNParameter(local_size=5, alpha=1e-4, beta=0.75),
    )


def _ip(name, bottom, n, std, bias=0.0) -> LayerParameter:
    return LayerParameter(
        name=name, type="InnerProduct", bottom=[bottom], top=[name],
        param=_mults(),
        inner_product_param=InnerProductParameter(
            num_output=n, weight_filler=_gauss(std), bias_filler=_const(bias)),
    )


def _dropout(name, bottom) -> LayerParameter:
    return LayerParameter(name=name, type="Dropout", bottom=[bottom],
                          top=[bottom],
                          dropout_param=DropoutParameter(dropout_ratio=0.5))


def caffenet(batch: int = 256, image: int = 227,
             classes: int = 1000) -> NetParameter:
    """CaffeNet: conv1 -> pool1 -> norm1 -> conv2 (group 2) -> pool2 ->
    norm2 -> conv3..5 -> pool5 -> fc6, fc7 (4096, dropout 0.5) -> fc8."""
    L: List[LayerParameter] = [LayerParameter(
        name="data", type="HostData", top=["data", "label"],
        java_data_param=JavaDataParameter(shape=[
            BlobShape(dim=[batch, 3, image, image]), BlobShape(dim=[batch])]),
    )]
    L += [_conv("conv1", "data", 96, 11, s=4), _relu("relu_conv1", "conv1"),
          _pool("pool1", "conv1"), _lrn("norm1", "pool1"),
          _conv("conv2", "norm1", 256, 5, p=2, g=2, bias=1.0),
          _relu("relu_conv2", "conv2"), _pool("pool2", "conv2"),
          _lrn("norm2", "pool2"),
          _conv("conv3", "norm2", 384, 3, p=1), _relu("relu_conv3", "conv3"),
          _conv("conv4", "conv3", 384, 3, p=1, g=2, bias=1.0),
          _relu("relu_conv4", "conv4"),
          _conv("conv5", "conv4", 256, 3, p=1, g=2, bias=1.0),
          _relu("relu_conv5", "conv5"), _pool("pool5", "conv5"),
          _ip("fc6", "pool5", 4096, 0.005, 1.0), _relu("relu6", "fc6"),
          _dropout("drop6", "fc6"),
          _ip("fc7", "fc6", 4096, 0.005, 1.0), _relu("relu7", "fc7"),
          _dropout("drop7", "fc7"),
          _ip("fc8", "fc7", classes, 0.01),
          LayerParameter(name="loss", type="SoftmaxWithLoss",
                         bottom=["fc8", "label"], top=["loss"]),
          LayerParameter(name="accuracy", type="Accuracy",
                         bottom=["fc8", "label"], top=["accuracy"],
                         include=[NetStateRule(phase="TEST")],
                         accuracy_param=AccuracyParameter(top_k=1))]
    return NetParameter(name="CaffeNet", layer=L)


BUILDERS = {"caffenet": caffenet}
