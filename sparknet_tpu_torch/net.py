"""TorchNet — the net builder: NetParameter -> functions of tensors.

The port of ``JaxNet`` (``sparknet_tpu/net.py:56``): the prototxt's
layers are built once (phase filter, static shape walk, parameter
sharing by ``ParamSpec.name``), and ``apply`` runs them in listed order
as a pure function of ``(params, stats, batch)`` under autograd —
gradients come from ``torch.autograd``, nothing is stored on the net.

Parameters keep the JAX package's layout: ``params[layer_name] ==
[weight, bias, ...]`` ordered like the reference layer's ``blobs_``,
shared params stored once under the owning layer.  The
``SPARKNET_FUSION`` LRN+pool planner and the horizontal-conv fusion of
the JAX net are not ported here (ROADMAP, with the ImageNet slices).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from sparknet_tpu_torch.config.schema import NetParameter, NetState
from sparknet_tpu_torch.graph import filter_net, toposort_check
from sparknet_tpu_torch.ops import common, data_layers, losses, vision  # noqa: F401
from sparknet_tpu_torch.ops import fillers
from sparknet_tpu_torch.ops.base import BlobDef, Layer, create_layer

Params = Dict[str, List[torch.Tensor]]
Stats = Dict[str, List[torch.Tensor]]


@dataclasses.dataclass
class _BlobRef:
    """Where one layer blob lives: (collection, owner layer, index)."""

    collection: str  # "params" | "stats"
    owner: str
    index: int


@dataclasses.dataclass
class NetOutputs:
    blobs: Dict[str, torch.Tensor]
    loss: torch.Tensor
    stats: Stats


class TorchNet:
    """A built net for one phase ("TRAIN" or "TEST").  ``feed_shapes``
    gives {top: shape} for host-fed data layers that declare none."""

    def __init__(
        self,
        net_param: NetParameter,
        phase: str = "TRAIN",
        feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
    ):
        self.phase = phase.upper()
        state = NetState(phase=self.phase)
        self.net_param = filter_net(net_param, state)
        self.name = self.net_param.name
        feed_shapes = {k: tuple(map(int, v)) for k, v in (feed_shapes or {}).items()}
        for i, blob in enumerate(self.net_param.input):
            if blob not in feed_shapes:
                if i < len(self.net_param.input_shape):
                    feed_shapes[blob] = tuple(
                        int(d) for d in self.net_param.input_shape[i].dim
                    )
                elif len(self.net_param.input_dim) >= 4 * (i + 1):
                    feed_shapes[blob] = tuple(
                        self.net_param.input_dim[4 * i : 4 * i + 4]
                    )
        toposort_check(self.net_param, external_tops=list(feed_shapes))

        self.layers: List[Layer] = []
        self.blob_shapes: Dict[str, Tuple[int, ...]] = dict(feed_shapes)
        self.feed_blobs: List[str] = list(feed_shapes)
        self._blob_defs: Dict[str, List[BlobDef]] = {}
        self._blob_refs: Dict[str, List[_BlobRef]] = {}
        self._loss_weights: Dict[str, List[float]] = {}
        param_owners: Dict[str, _BlobRef] = {}  # ParamSpec.name -> ref

        for lp in self.net_param.layer:
            layer = create_layer(lp, self.phase)
            if layer.name in self._blob_defs:
                raise ValueError(f"duplicate layer name {layer.name!r}")
            bshapes = [self.blob_shapes[b] for b in lp.bottom]
            if isinstance(layer, data_layers._HostFed):
                declared = layer.declared_shapes()
                tshapes = []
                for i, top in enumerate(lp.top):
                    if declared is not None and i < len(declared):
                        shape = declared[i]
                    elif top in feed_shapes:
                        shape = feed_shapes[top]
                    else:
                        raise ValueError(
                            f"data layer {layer.name!r}: no shape for top "
                            f"{top!r}; pass feed_shapes"
                        )
                    tshapes.append(tuple(shape))
                    self.feed_blobs.append(top)
            else:
                tshapes = layer.out_shapes(bshapes)

            defs = layer.blob_defs(bshapes)
            refs: List[_BlobRef] = []
            pi = si = 0
            for bi, d in enumerate(defs):
                spec = lp.param[bi] if bi < len(lp.param) else None
                shared_name = spec.name if spec and spec.name else None
                if shared_name and shared_name in param_owners:
                    owner_ref = param_owners[shared_name]
                    owner_defs = self._blob_defs[owner_ref.owner]
                    mode = (spec.share_mode or "STRICT").upper()
                    if mode == "STRICT" and tuple(
                        owner_defs[owner_ref.index].shape
                    ) != tuple(d.shape):
                        raise ValueError(
                            f"shared param {shared_name!r}: shape mismatch "
                            f"{owner_defs[owner_ref.index].shape} vs {d.shape}"
                        )
                    refs.append(owner_ref)
                else:
                    coll = "params" if d.learnable else "stats"
                    ref = _BlobRef(coll, layer.name, pi if d.learnable else si)
                    if d.learnable:
                        pi += 1
                    else:
                        si += 1
                    refs.append(ref)
                    if shared_name:
                        param_owners[shared_name] = ref

            self._blob_defs[layer.name] = defs
            self._blob_refs[layer.name] = refs
            self._loss_weights[layer.name] = layer.loss_weights()
            for top, shape in zip(lp.top, tshapes):
                self.blob_shapes[top] = tuple(int(x) for x in shape)
            self.layers.append(layer)

        seen = set()
        self.feed_blobs = [
            b for b in self.feed_blobs if not (b in seen or seen.add(b))
        ]

    def param_multipliers(self) -> Tuple[Dict[str, List[float]], Dict[str, List[float]]]:
        """Per-blob (lr_mult, decay_mult) dicts matching ``init()``'s params
        (reference: ParamSpec handling in ``net.cpp AppendParam``)."""
        lr: Dict[str, List[float]] = {}
        decay: Dict[str, List[float]] = {}
        for layer in self.layers:
            for d, ref in zip(
                self._blob_defs[layer.name], self._blob_refs[layer.name]
            ):
                if ref.collection == "params" and ref.owner == layer.name:
                    lr.setdefault(layer.name, []).append(d.lr_mult)
                    decay.setdefault(layer.name, []).append(d.decay_mult)
        return lr, decay

    def init(self, seed: int = 0,
             device: Optional[torch.device] = None) -> Tuple[Params, Stats]:
        """Fill every blob with its filler (Net::Init's filler pass), drawing
        from one ``torch.Generator`` seeded with ``seed``, layer by layer."""
        gen = torch.Generator().manual_seed(int(seed))
        params: Params = {}
        stats: Stats = {}
        for layer in self.layers:
            for d, ref in zip(
                self._blob_defs[layer.name], self._blob_refs[layer.name]
            ):
                if ref.owner != layer.name:
                    continue  # shared: the owner already initialized it
                arr = fillers.fill(gen, d.shape, d.filler).to(device)
                coll = params if ref.collection == "params" else stats
                coll.setdefault(layer.name, []).append(arr)
        return params, stats

    def blob_layout(self, collection: str = "params") -> Dict[str, List[Tuple[int, ...]]]:
        """``{layer: [blob shape, ...]}`` of the ``"params"`` (or
        ``"stats"``) blobs, in ``init()`` order — what a carried-in
        parameter dict must match."""
        out: Dict[str, List[Tuple[int, ...]]] = {}
        for layer in self.layers:
            for d, ref in zip(
                self._blob_defs[layer.name], self._blob_refs[layer.name]
            ):
                if ref.collection == collection and ref.owner == layer.name:
                    out.setdefault(layer.name, []).append(tuple(d.shape))
        return out

    def _gather_blobs(self, layer_name: str, params: Params, stats: Stats):
        return [
            (params if ref.collection == "params" else stats)[ref.owner][ref.index]
            for ref in self._blob_refs[layer_name]
        ]

    def apply(
        self,
        params: Params,
        stats: Stats,
        batch: Dict[str, torch.Tensor],
        train: Optional[bool] = None,
    ) -> NetOutputs:
        """Run the net: every named blob (the ``getData`` analog), the
        weighted total loss, and the updated stats."""
        train = (self.phase == "TRAIN") if train is None else train
        blobs: Dict[str, torch.Tensor] = {}
        for b in self.feed_blobs:
            if b not in batch:
                raise ValueError(f"batch missing feed blob {b!r}")
            blobs[b] = batch[b]
        new_stats: Stats = {k: list(v) for k, v in stats.items()}
        loss = None
        for layer in self.layers:
            lp = layer.lp
            if isinstance(layer, data_layers._HostFed):
                tops = [blobs[t] for t in lp.top]
            else:
                lblobs = self._gather_blobs(layer.name, params, new_stats)
                tops, updated = layer.apply(
                    lblobs, [blobs[b] for b in lp.bottom], train
                )
                if updated is not None:
                    for ref, arr in zip(self._blob_refs[layer.name], updated):
                        if ref.collection == "stats":
                            new_stats[ref.owner][ref.index] = arr
            for w, top in zip(self._loss_weights[layer.name], tops):
                if w:
                    term = w * top.sum()
                    loss = term if loss is None else loss + term
            for name, top in zip(lp.top, tops):
                blobs[name] = top
        if loss is None:
            dev = next(iter(blobs.values())).device if blobs else None
            loss = torch.zeros((), device=dev)
        return NetOutputs(blobs=blobs, loss=loss, stats=new_stats)

    def forward(self, params: Params, stats: Stats,
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inference forward returning all blobs."""
        return self.apply(params, stats, batch, train=False).blobs

    def loss_fn(self, params, stats, batch, train: bool = True):
        """``(loss, (blobs, stats))`` — the JAX net's ``loss_fn`` contract."""
        out = self.apply(params, stats, batch, train=train)
        return out.loss, (out.blobs, out.stats)
