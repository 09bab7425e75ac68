"""Typed configuration schema compatible with Caffe's proto2 config language.

The port's own copy of ``sparknet_tpu/config/schema.py``, cut to the
messages the ported training path reads: the cifar10_full net and
solver prototxts and the small host-fed nets of the tests (HostData,
Convolution, Pooling, LRN, InnerProduct, ReLU, SoftmaxWithLoss,
Accuracy).  Field names, defaults and enum literals match the reference
schema, so those configs parse unchanged; a layer parameter message
outside this set is refused by the parser as not yet ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


class Message:
    """Base marker for config messages (bound by the prototext module)."""

    def copy(self):
        return dataclasses.replace(
            self,
            **{
                f.name: _deep_copy(getattr(self, f.name))
                for f in dataclasses.fields(self)
            },
        )


def _deep_copy(v):
    if isinstance(v, Message):
        return v.copy()
    if isinstance(v, list):
        return [_deep_copy(x) for x in v]
    return v


@dataclass
class BlobShape(Message):
    dim: List[int] = field(default_factory=list)


@dataclass
class FillerParameter(Message):
    """Weight-initializer config (reference: ``include/caffe/filler.hpp``)."""

    type: str = "constant"
    value: float = 0.0
    min: float = 0.0
    max: float = 1.0
    mean: float = 0.0
    std: float = 1.0
    sparse: int = -1
    variance_norm: str = "FAN_IN"  # FAN_IN | FAN_OUT | AVERAGE


@dataclass
class NetStateRule(Message):
    """Phase/level/stage inclusion rule (reference: caffe.proto:267-281)."""

    phase: Optional[str] = None  # TRAIN | TEST
    min_level: Optional[int] = None
    max_level: Optional[int] = None
    stage: List[str] = field(default_factory=list)
    not_stage: List[str] = field(default_factory=list)


@dataclass
class NetState(Message):
    phase: str = "TEST"
    level: int = 0
    stage: List[str] = field(default_factory=list)


@dataclass
class ParamSpec(Message):
    """Per-parameter training config incl. sharing (caffe.proto:283-308)."""

    name: Optional[str] = None
    share_mode: Optional[str] = None  # STRICT | PERMISSIVE
    lr_mult: float = 1.0
    decay_mult: float = 1.0


@dataclass
class LossParameter(Message):
    ignore_label: Optional[int] = None
    normalization: str = "VALID"  # FULL | VALID | BATCH_SIZE | NONE
    normalize: Optional[bool] = None  # deprecated alias


@dataclass
class AccuracyParameter(Message):
    top_k: int = 1
    axis: int = 1
    ignore_label: Optional[int] = None


@dataclass
class ConvolutionParameter(Message):
    num_output: int = 0
    bias_term: bool = True
    pad: List[int] = field(default_factory=list)
    kernel_size: List[int] = field(default_factory=list)
    stride: List[int] = field(default_factory=list)
    dilation: List[int] = field(default_factory=list)
    pad_h: int = 0
    pad_w: int = 0
    kernel_h: int = 0
    kernel_w: int = 0
    stride_h: int = 0
    stride_w: int = 0
    group: int = 1
    weight_filler: Optional[FillerParameter] = None
    bias_filler: Optional[FillerParameter] = None
    axis: int = 1
    force_nd_im2col: bool = False
    engine: Optional[str] = None  # DEFAULT | CAFFE | CUDNN (ignored)


@dataclass
class InnerProductParameter(Message):
    num_output: int = 0
    bias_term: bool = True
    weight_filler: Optional[FillerParameter] = None
    bias_filler: Optional[FillerParameter] = None
    axis: int = 1
    transpose: bool = False


@dataclass
class JavaDataParameter(Message):
    """Host-feed layer config (reference: caffe.proto:991-993): the
    shapes of the batches the host input pipeline supplies each step."""

    shape: List[BlobShape] = field(default_factory=list)


@dataclass
class LRNParameter(Message):
    local_size: int = 5
    alpha: float = 1.0
    beta: float = 0.75
    norm_region: str = "ACROSS_CHANNELS"  # ACROSS_CHANNELS | WITHIN_CHANNEL
    k: float = 1.0
    engine: Optional[str] = None


@dataclass
class PoolingParameter(Message):
    pool: str = "MAX"  # MAX | AVE | STOCHASTIC
    pad: int = 0
    pad_h: int = 0
    pad_w: int = 0
    kernel_size: int = 0
    kernel_h: int = 0
    kernel_w: int = 0
    stride: int = 1
    stride_h: int = 0
    stride_w: int = 0
    global_pooling: bool = False
    engine: Optional[str] = None


@dataclass
class ReLUParameter(Message):
    negative_slope: float = 0.0
    engine: Optional[str] = None


@dataclass
class SoftmaxParameter(Message):
    engine: Optional[str] = None
    axis: int = 1


@dataclass
class LayerParameter(Message):
    """One layer of a net (reference: caffe.proto:310-430), with the
    parameter messages of the ported layers."""

    name: Optional[str] = None
    type: Optional[str] = None
    bottom: List[str] = field(default_factory=list)
    top: List[str] = field(default_factory=list)
    phase: Optional[str] = None
    loss_weight: List[float] = field(default_factory=list)
    param: List[ParamSpec] = field(default_factory=list)
    propagate_down: List[bool] = field(default_factory=list)
    include: List[NetStateRule] = field(default_factory=list)
    exclude: List[NetStateRule] = field(default_factory=list)
    loss_param: Optional[LossParameter] = None
    accuracy_param: Optional[AccuracyParameter] = None
    convolution_param: Optional[ConvolutionParameter] = None
    inner_product_param: Optional[InnerProductParameter] = None
    java_data_param: Optional[JavaDataParameter] = None
    lrn_param: Optional[LRNParameter] = None
    pooling_param: Optional[PoolingParameter] = None
    relu_param: Optional[ReLUParameter] = None
    softmax_param: Optional[SoftmaxParameter] = None


@dataclass
class NetParameter(Message):
    """Whole-net config (reference: caffe.proto:64-100)."""

    name: Optional[str] = None
    input: List[str] = field(default_factory=list)
    input_shape: List[BlobShape] = field(default_factory=list)
    input_dim: List[int] = field(default_factory=list)
    force_backward: bool = False
    state: Optional[NetState] = None
    debug_info: bool = False
    layer: List[LayerParameter] = field(default_factory=list)


@dataclass
class SolverParameter(Message):
    """Solver config (reference: caffe.proto:102-243)."""

    net: Optional[str] = None
    net_param: Optional[NetParameter] = None
    train_net: Optional[str] = None
    test_net: List[str] = field(default_factory=list)
    train_net_param: Optional[NetParameter] = None
    test_iter: List[int] = field(default_factory=list)
    test_interval: int = 0
    test_compute_loss: bool = False
    test_initialization: bool = True
    base_lr: float = 0.01
    display: int = 0
    average_loss: int = 1
    max_iter: int = 0
    iter_size: int = 1
    lr_policy: str = "fixed"
    gamma: float = 0.0
    power: float = 0.0
    momentum: float = 0.0
    weight_decay: float = 0.0
    regularization_type: str = "L2"
    stepsize: int = 0
    stepvalue: List[int] = field(default_factory=list)
    clip_gradients: float = -1.0
    snapshot: int = 0
    snapshot_prefix: str = ""
    snapshot_diff: bool = False
    snapshot_format: str = "BINARYPROTO"  # HDF5 | BINARYPROTO
    solver_mode: str = "GPU"  # CPU | GPU — informational
    device_id: int = 0
    random_seed: int = -1
    type: str = "SGD"
    delta: float = 1e-8
    momentum2: float = 0.999
    rms_decay: float = 0.99
    debug_info: bool = False
    snapshot_after_train: bool = True
    # legacy enum solver_type (SGD=0..ADAM=5)
    solver_type: Optional[str] = None


_LEGACY_SOLVER_TYPES = {
    "0": "SGD",
    "1": "NESTEROV",
    "2": "ADAGRAD",
    "3": "RMSPROP",
    "4": "ADADELTA",
    "5": "ADAM",
    "SGD": "SGD",
    "NESTEROV": "NESTEROV",
    "ADAGRAD": "ADAGRAD",
    "RMSPROP": "RMSPROP",
    "ADADELTA": "ADADELTA",
    "ADAM": "ADAM",
}


def solver_method(p: SolverParameter) -> str:
    """Resolve the solver algorithm, honoring the legacy enum field."""
    if p.solver_type is not None:
        key = str(p.solver_type).upper()
        if key not in _LEGACY_SOLVER_TYPES:
            raise ValueError(
                f"unrecognized solver_type: {p.solver_type!r} "
                f"(expected one of {sorted(set(_LEGACY_SOLVER_TYPES.values()))})"
            )
        return _LEGACY_SOLVER_TYPES[key]
    key = p.type.upper()
    if key not in _LEGACY_SOLVER_TYPES:
        raise ValueError(f"unrecognized solver type: {p.type!r}")
    return key
