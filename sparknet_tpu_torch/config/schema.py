"""Typed configuration schema compatible with Caffe's proto2 config language.

The port's own copy of ``sparknet_tpu/config/schema.py``: every layer
parameter message of the JAX package's schema (50), the net, solver and
net-state messages.  Field names, defaults and enum literals match the
reference schema, so its configs parse unchanged.  Not copied: the
``BlobProto`` message and the V1 legacy fields (``LayerParameter.blobs``,
``blobs_lr``, ``weight_decay``, ``NetParameter.layers``), which the port's
parser does not upgrade — weights travel in ``.caffemodel`` files
(``io/caffemodel.py``), never inside a prototxt.
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
class TransformationParameter(Message):
    scale: float = 1.0
    mirror: bool = False
    crop_size: int = 0
    mean_file: Optional[str] = None
    mean_value: List[float] = field(default_factory=list)
    force_color: bool = False
    force_gray: bool = False


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
class ArgMaxParameter(Message):
    out_max_val: bool = False
    top_k: int = 1
    axis: Optional[int] = None


@dataclass
class ConcatParameter(Message):
    axis: int = 1
    concat_dim: Optional[int] = None  # legacy


@dataclass
class BatchNormParameter(Message):
    use_global_stats: Optional[bool] = None
    moving_average_fraction: float = 0.999
    eps: float = 1e-5


@dataclass
class BiasParameter(Message):
    axis: int = 1
    num_axes: int = 1
    filler: Optional[FillerParameter] = None


@dataclass
class ScaleParameter(Message):
    axis: int = 1
    num_axes: int = 1
    filler: Optional[FillerParameter] = None
    bias_term: bool = False
    bias_filler: Optional[FillerParameter] = None


@dataclass
class ContrastiveLossParameter(Message):
    margin: float = 1.0
    legacy_version: bool = False


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
class DataParameter(Message):
    source: Optional[str] = None
    batch_size: int = 0
    rand_skip: int = 0
    backend: str = "LEVELDB"  # LEVELDB | LMDB (both read into the record DB)
    scale: float = 1.0
    mean_file: Optional[str] = None
    crop_size: int = 0
    mirror: bool = False
    force_encoded_color: bool = False
    prefetch: int = 4


@dataclass
class DropoutParameter(Message):
    dropout_ratio: float = 0.5


@dataclass
class DummyDataParameter(Message):
    data_filler: List[FillerParameter] = field(default_factory=list)
    shape: List[BlobShape] = field(default_factory=list)
    num: List[int] = field(default_factory=list)
    channels: List[int] = field(default_factory=list)
    height: List[int] = field(default_factory=list)
    width: List[int] = field(default_factory=list)


@dataclass
class ELUParameter(Message):
    alpha: float = 1.0


@dataclass
class EltwiseParameter(Message):
    operation: str = "SUM"  # PROD | SUM | MAX
    coeff: List[float] = field(default_factory=list)
    stable_prod_grad: bool = True


@dataclass
class EmbedParameter(Message):
    num_output: int = 0
    input_dim: int = 0
    bias_term: bool = True
    weight_filler: Optional[FillerParameter] = None
    bias_filler: Optional[FillerParameter] = None


@dataclass
class ExpParameter(Message):
    base: float = -1.0
    scale: float = 1.0
    shift: float = 0.0


@dataclass
class FlattenParameter(Message):
    axis: int = 1
    end_axis: int = -1


@dataclass
class HDF5DataParameter(Message):
    source: Optional[str] = None
    batch_size: int = 0
    shuffle: bool = False


@dataclass
class HDF5OutputParameter(Message):
    file_name: Optional[str] = None


@dataclass
class HingeLossParameter(Message):
    norm: str = "L1"  # L1 | L2


@dataclass
class ImageDataParameter(Message):
    source: Optional[str] = None
    batch_size: int = 1
    rand_skip: int = 0
    shuffle: bool = False
    new_height: int = 0
    new_width: int = 0
    is_color: bool = True
    scale: float = 1.0
    mean_file: Optional[str] = None
    crop_size: int = 0
    mirror: bool = False
    root_folder: str = ""


@dataclass
class InfogainLossParameter(Message):
    source: Optional[str] = None


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
class LogParameter(Message):
    base: float = -1.0
    scale: float = 1.0
    shift: float = 0.0


@dataclass
class LRNParameter(Message):
    local_size: int = 5
    alpha: float = 1.0
    beta: float = 0.75
    norm_region: str = "ACROSS_CHANNELS"  # ACROSS_CHANNELS | WITHIN_CHANNEL
    k: float = 1.0
    engine: Optional[str] = None


@dataclass
class MemoryDataParameter(Message):
    batch_size: int = 0
    channels: int = 0
    height: int = 0
    width: int = 0


@dataclass
class MVNParameter(Message):
    normalize_variance: bool = True
    across_channels: bool = False
    eps: float = 1e-9


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
class PowerParameter(Message):
    power: float = 1.0
    scale: float = 1.0
    shift: float = 0.0


@dataclass
class PReLUParameter(Message):
    filler: Optional[FillerParameter] = None
    channel_shared: bool = False


@dataclass
class PythonParameter(Message):
    module: Optional[str] = None
    layer: Optional[str] = None
    param_str: str = ""
    share_in_parallel: bool = False


@dataclass
class ReductionParameter(Message):
    operation: str = "SUM"  # SUM | ASUM | SUMSQ | MEAN
    axis: int = 0
    coeff: float = 1.0


@dataclass
class ReLUParameter(Message):
    negative_slope: float = 0.0
    engine: Optional[str] = None


@dataclass
class ReshapeParameter(Message):
    shape: Optional[BlobShape] = None
    axis: int = 0
    num_axes: int = -1


@dataclass
class SigmoidParameter(Message):
    engine: Optional[str] = None


@dataclass
class SliceParameter(Message):
    axis: int = 1
    slice_point: List[int] = field(default_factory=list)
    slice_dim: Optional[int] = None  # legacy


@dataclass
class SoftmaxParameter(Message):
    engine: Optional[str] = None
    axis: int = 1


@dataclass
class SPPParameter(Message):
    pyramid_height: int = 0
    pool: str = "MAX"
    engine: Optional[str] = None


@dataclass
class TanHParameter(Message):
    engine: Optional[str] = None


@dataclass
class ThresholdParameter(Message):
    threshold: float = 0.0


@dataclass
class TileParameter(Message):
    axis: int = 1
    tiles: int = 0


@dataclass
class WindowDataParameter(Message):
    source: Optional[str] = None
    scale: float = 1.0
    mean_file: Optional[str] = None
    batch_size: int = 0
    crop_size: int = 0
    mirror: bool = False
    fg_threshold: float = 0.5
    bg_threshold: float = 0.5
    fg_fraction: float = 0.25
    context_pad: int = 0
    crop_mode: str = "warp"
    cache_images: bool = False
    root_folder: str = ""


@dataclass
class InputParameter(Message):
    shape: List[BlobShape] = field(default_factory=list)


@dataclass
class AttentionParameter(Message):
    """Multi-head attention config (an extension with no reference
    equivalent; the ``Attention`` layer of ``ops/attention.py``)."""

    num_heads: int = 1
    head_dim: int = 0
    causal: bool = False
    dropout_ratio: float = 0.0
    weight_filler: Optional[FillerParameter] = None
    bias_term: bool = True
    block_size: int = 512  # blockwise/ring attention chunk along sequence


@dataclass
class LayerParameter(Message):
    """One layer of a net (reference: caffe.proto:310-430), with every
    layer parameter message of the JAX package's schema."""

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
    transform_param: Optional[TransformationParameter] = None
    loss_param: Optional[LossParameter] = None
    accuracy_param: Optional[AccuracyParameter] = None
    argmax_param: Optional[ArgMaxParameter] = None
    attention_param: Optional[AttentionParameter] = None
    batch_norm_param: Optional[BatchNormParameter] = None
    bias_param: Optional[BiasParameter] = None
    concat_param: Optional[ConcatParameter] = None
    contrastive_loss_param: Optional[ContrastiveLossParameter] = None
    convolution_param: Optional[ConvolutionParameter] = None
    data_param: Optional[DataParameter] = None
    dropout_param: Optional[DropoutParameter] = None
    dummy_data_param: Optional[DummyDataParameter] = None
    eltwise_param: Optional[EltwiseParameter] = None
    elu_param: Optional[ELUParameter] = None
    embed_param: Optional[EmbedParameter] = None
    exp_param: Optional[ExpParameter] = None
    flatten_param: Optional[FlattenParameter] = None
    hdf5_data_param: Optional[HDF5DataParameter] = None
    hdf5_output_param: Optional[HDF5OutputParameter] = None
    hinge_loss_param: Optional[HingeLossParameter] = None
    image_data_param: Optional[ImageDataParameter] = None
    infogain_loss_param: Optional[InfogainLossParameter] = None
    inner_product_param: Optional[InnerProductParameter] = None
    input_param: Optional[InputParameter] = None
    java_data_param: Optional[JavaDataParameter] = None
    log_param: Optional[LogParameter] = None
    lrn_param: Optional[LRNParameter] = None
    memory_data_param: Optional[MemoryDataParameter] = None
    mvn_param: Optional[MVNParameter] = None
    pooling_param: Optional[PoolingParameter] = None
    power_param: Optional[PowerParameter] = None
    prelu_param: Optional[PReLUParameter] = None
    python_param: Optional[PythonParameter] = None
    reduction_param: Optional[ReductionParameter] = None
    relu_param: Optional[ReLUParameter] = None
    reshape_param: Optional[ReshapeParameter] = None
    scale_param: Optional[ScaleParameter] = None
    sigmoid_param: Optional[SigmoidParameter] = None
    slice_param: Optional[SliceParameter] = None
    softmax_param: Optional[SoftmaxParameter] = None
    spp_param: Optional[SPPParameter] = None
    tanh_param: Optional[TanHParameter] = None
    threshold_param: Optional[ThresholdParameter] = None
    tile_param: Optional[TileParameter] = None
    window_data_param: Optional[WindowDataParameter] = None


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
