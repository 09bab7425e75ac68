"""Layer protocol + registry for the net builder.

The port of ``sparknet_tpu/ops/base.py`` (reference: ``layer.hpp``,
``layer_factory.cpp``): a layer is a shape-to-shape transform with
explicit parameter blobs, applied to tensors under autograd.  Each layer
exposes an ordered blob list exactly like the reference's
``layer->blobs()`` (Convolution = [weight, bias]) — the contract that
makes weights line up with the JAX package's ``{layer: [blob, ...]}``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Type

import torch

from sparknet_tpu_torch.config.schema import FillerParameter, LayerParameter

Shape = Tuple[int, ...]


@dataclasses.dataclass
class BlobDef:
    """One parameter/stat blob of a layer (ordered like Caffe's blobs_)."""

    shape: Shape
    filler: Optional[FillerParameter] = None
    lr_mult: float = 1.0
    decay_mult: float = 1.0
    learnable: bool = True  # False => stat blob (e.g. BN moving stats)


class Layer:
    """Base layer. Subclasses override ``blob_defs``, ``out_shapes`` and
    ``apply``."""

    TYPE: str = ""
    # loss layers get an implicit loss_weight of 1 on their first top
    IS_LOSS: bool = False
    # layers that consume index-valued bottoms (labels, embedding ids,
    # gather indices): a net with a compute dtype never casts their
    # inputs or blobs to it — bf16 holds integers exactly only up to 256
    MIXED_PRECISION_EXEMPT: bool = False

    def __init__(self, lp: LayerParameter, phase: str):
        self.lp = lp
        self.phase = phase
        self.name = lp.name or lp.type

    def blob_defs(self, bottom_shapes: Sequence[Shape]) -> List[BlobDef]:
        return []

    def out_shapes(self, bottom_shapes: Sequence[Shape]) -> List[Shape]:
        raise NotImplementedError

    def apply(
        self,
        blobs: List[torch.Tensor],
        bottoms: List[torch.Tensor],
        rng: Optional[int],
        train: bool,
    ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
        """Return (tops, updated_stat_blobs_or_None).  ``rng`` is the
        layer's own key (``utils.rngs``; the JAX layers' ``rng``), None
        where the caller gave the net none; layers that draw nothing
        ignore it."""
        raise NotImplementedError

    def loss_weights(self) -> List[float]:
        n_top = max(1, len(self.lp.top))
        if self.lp.loss_weight:
            w = list(self.lp.loss_weight)
            return w + [0.0] * (n_top - len(w))
        return [1.0 if (self.IS_LOSS and i == 0) else 0.0 for i in range(n_top)]


LAYER_REGISTRY: Dict[str, Type[Layer]] = {}

# layer types of the JAX package that later slices bring: the attention
# layer (A.9)
_NOT_YET_PORTED = frozenset(("Attention",))


def register(cls: Type[Layer]) -> Type[Layer]:
    """``REGISTER_LAYER_CLASS`` analog (layer_factory.cpp)."""
    if not cls.TYPE:
        raise TypeError(f"{cls.__name__} missing TYPE")
    LAYER_REGISTRY[cls.TYPE] = cls
    return cls


def create_layer(lp: LayerParameter, phase: str) -> Layer:
    if lp.type in LAYER_REGISTRY:
        return LAYER_REGISTRY[lp.type](lp, phase)
    if lp.type in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"layer type {lp.type!r} (layer {lp.name!r}) is not yet ported "
            "to sparknet_tpu_torch"
        )
    raise ValueError(
        f"unknown layer type {lp.type!r} (layer {lp.name!r}); "
        f"registered: {sorted(LAYER_REGISTRY)}"
    )
