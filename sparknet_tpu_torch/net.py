"""TorchNet — the net builder: NetParameter -> functions of tensors.

The port of ``JaxNet`` (``sparknet_tpu/net.py:56``): the prototxt's
layers are built once (phase filter, static shape walk, parameter
sharing by ``ParamSpec.name``), and ``apply`` runs them in listed order
as a pure function of ``(params, stats, batch)`` under autograd —
gradients come from ``torch.autograd``, nothing is stored on the net.

Parameters keep the JAX package's layout: ``params[layer_name] ==
[weight, bias, ...]`` ordered like the reference layer's ``blobs_``,
shared params stored once under the owning layer.  ``apply`` hands
each layer its own key, ``fold_in(rng, layer index)`` (``utils.rngs``),
as the JAX net does; layers that draw nothing ignore it.

Two plans of the JAX net, under its switches:

- ``SPARKNET_FUSION=1``, the LRN + max-pool fusion (``_plan_fusion``):
  in the TRAIN phase an ACROSS_CHANNELS LRN whose only consumer is a
  ``fusable`` 3x3/2 MAX pool runs as ``cuda_plp.lrn_maxpool`` at the
  LRN's slot (K7 forward, K8 backward on the card), the pool layer is
  skipped and the LRN's top is absent from the blob map.
- The horizontal-conv fusion (``_plan_hconv``, on unless
  ``SPARKNET_HFUSE=0``; groups of at least ``SPARKNET_HFUSE_MIN``,
  default 3): sibling convolutions that read the same bottom with the
  same geometry and bias term (GoogLeNet's Inception branches) run as
  one ``F.conv2d`` over their concatenated weights at the first
  member's slot, its output split back into the members' tops.
  Parameters stay per layer, so checkpoints and the blob map are
  unchanged.

``compute_dtype`` (JAX ``JaxNet(compute_dtype=...)``, e.g.
``"bfloat16"``) runs the layers in that dtype: parameters stay float32
master copies cast at each use, loss layers (``IS_LOSS``) take their
bottoms in float32, ``MIXED_PRECISION_EXEMPT`` layers are left alone,
host-fed blobs keep their dtype (labels never round through bf16) and
stat blobs are written back at their master dtype.  None keeps the
reference numerics.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sparknet_tpu_torch.config.schema import LRNParameter, NetParameter, NetState
from sparknet_tpu_torch.graph import filter_net, toposort_check
from sparknet_tpu_torch.ops import (  # noqa: F401
    attention, common, data_layers, losses, vision)
from sparknet_tpu_torch.ops import cuda_plp, fillers
from sparknet_tpu_torch.ops.base import BlobDef, Layer, create_layer
from sparknet_tpu_torch.utils import jax_prng, rngs

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


def _compute_dtype(dtype) -> Optional[torch.dtype]:
    """``None``, a ``torch.dtype`` or its name (``"bfloat16"``) -> the
    floating dtype layers compute in (None: the reference numerics)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = getattr(torch, str(dtype), None)
    if out is not None and (not isinstance(out, torch.dtype)
                            or not out.is_floating_point):
        raise ValueError(f"compute_dtype {dtype!r}: expected a float dtype")
    return out


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype`` when it is floating (index tensors as they are)."""
    return t.to(dtype) if t.is_floating_point() else t


def _device_of(batch, params) -> torch.device:
    """The device a net runs on: its batch's, else its parameters'."""
    tensors = list(batch.values()) + [b for bl in params.values() for b in bl]
    return tensors[0].device if tensors else torch.device("cpu")


class TorchNet:
    """A built net for one phase ("TRAIN" or "TEST").  ``feed_shapes``
    gives {top: shape} for host-fed data layers that declare none."""

    def __init__(
        self,
        net_param: NetParameter,
        phase: str = "TRAIN",
        feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
        compute_dtype=None,
    ):
        self.compute_dtype = _compute_dtype(compute_dtype)
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
        self._plan_fusion()
        self._plan_hconv()

    def _plan_fusion(self) -> None:
        """Fuse ``LRN -> Pooling`` pairs into ``cuda_plp.lrn_maxpool``
        under ``SPARKNET_FUSION=1`` (JAX ``net.py`` ``_plan_fusion``): TRAIN
        phase only (the TEST net keeps the full blob map), the LRN's top
        read by the pool alone, no loss weight on either layer, and a
        geometry ``cuda_plp.fusable`` accepts."""
        self._plp_fused: Dict[int, Tuple[str, Tuple[int, float, float, float]]] = {}
        self._plp_skip: set = set()
        if os.environ.get("SPARKNET_FUSION", "") != "1" or self.phase != "TRAIN":
            return
        consumers: Dict[str, int] = {}
        for layer in self.layers:
            for b in layer.lp.bottom:
                consumers[b] = consumers.get(b, 0) + 1
        for i in range(len(self.layers) - 1):
            lrn, pool = self.layers[i], self.layers[i + 1]
            if lrn.lp.type != "LRN" or pool.lp.type != "Pooling":
                continue
            mid = lrn.lp.top[0]
            if list(pool.lp.bottom) != [mid] or consumers.get(mid, 0) != 1:
                continue
            if any(self._loss_weights[lrn.name]) or any(
                self._loss_weights[pool.name]
            ):
                continue
            lp = lrn.lp.lrn_param or LRNParameter()
            shape = self.blob_shapes[lrn.lp.bottom[0]]
            pp = pool.lp.pooling_param
            if len(shape) != 4 or pp.global_pooling:
                continue
            h, w = shape[2], shape[3]
            try:
                kernel, stride, pad, _ = vision._pool_geometry(pp, h, w)
            except ValueError:
                continue
            if not cuda_plp.fusable(lp.norm_region, lp.local_size, pp.pool,
                                    kernel, stride, pad, h, w):
                continue
            self._plp_fused[i] = (pool.lp.top[0], (
                int(lp.local_size), float(lp.alpha), float(lp.beta),
                float(lp.k)))
            self._plp_skip.add(i + 1)

    def _plan_hconv(self) -> None:
        """Group sibling convolutions (JAX ``net.py`` ``_plan_hconv``): key
        (bottom, geometry, bias term), ``group == 1``, no loss weight, at
        least ``SPARKNET_HFUSE_MIN`` members.  A group is dropped when
        running every member at the leader's slot would change what a
        layer reads: (a) a layer in the fused span rewrites the shared
        bottom in place; (b) a member's top is produced or read by a
        layer between the leader and that member's own slot (legal top
        rebinding, ``graph.py``).  Layers at or after a member's slot are
        unaffected: production only moves earlier."""
        self._hconv_groups: Dict[int, dict] = {}
        self._hconv_skip: set = set()
        if os.environ.get("SPARKNET_HFUSE", "1") == "0":
            return
        min_members = int(os.environ.get("SPARKNET_HFUSE_MIN", "3"))
        groups: Dict[tuple, List[int]] = {}
        for li, layer in enumerate(self.layers):
            lp = layer.lp
            if lp.type != "Convolution" or len(lp.bottom) != 1:
                continue
            cp = lp.convolution_param
            if max(1, cp.group) != 1 or any(self._loss_weights[layer.name]):
                continue
            key = (lp.bottom[0], layer._geometry(), bool(cp.bias_term))
            groups.setdefault(key, []).append(li)
        for (bottom, geom, bias), lis in groups.items():
            if len(lis) < min_members:
                continue
            if any(bottom in self.layers[mid].lp.top
                   for mid in range(lis[0], lis[-1] + 1)):
                continue  # hazard (a)
            if any(self.layers[li].lp.top[0] in lm.lp.top
                   or self.layers[li].lp.top[0] in lm.lp.bottom
                   for li in lis[1:] for lm in self.layers[lis[0]:li]):
                continue  # hazard (b)
            self._hconv_groups[lis[0]] = {
                "lis": lis, "geom": geom, "bias": bias,
                # each member's own num_output, not blob_shapes[top]: that
                # holds the last binding of a possibly rebound name
                "sizes": [self.layers[li].lp.convolution_param.num_output
                          for li in lis],
            }
            self._hconv_skip.update(lis[1:])

    @property
    def hconv_groups(self) -> List[List[str]]:
        """The fused sibling-conv groups, as lists of member layer names."""
        return [[self.layers[li].name for li in g["lis"]]
                for g in self._hconv_groups.values()]

    def _apply_hconv(self, group, x, params, blobs, on_top=None) -> None:
        """Run one fused sibling-conv group; write every member's top."""
        _, stride, pad, dil = group["geom"]
        members = [self.layers[li] for li in group["lis"]]
        gathered = [self._gather_blobs(m.name, params, {}) for m in members]
        cd = self.compute_dtype
        if cd is not None:
            x = _cast(x, cd)
            gathered = [[_cast(b, cd) for b in g] for g in gathered]
        y = F.conv2d(x, torch.cat([g[0] for g in gathered]), None, stride, pad,
                     dil)
        if group["bias"]:
            y = y + torch.cat([g[1] for g in gathered])[None, :, None, None]
        for m, part in zip(members, torch.split(y, group["sizes"], dim=1)):
            if on_top is not None:
                part = on_top(m.lp.top[0], part)
            blobs[m.lp.top[0]] = part

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
        """Fill every blob with its filler (Net::Init's filler pass), with
        the JAX package's key tree (``JaxNet.init``): the key of layer
        ``i`` is ``fold_in(PRNGKey(seed), i)``, split into one key per
        blob.  The draws run on the host (``utils/jax_prng.py``), so the
        same seed gives the JAX package's weights on every device."""
        key = jax_prng.prng_key(seed)
        params: Params = {}
        stats: Stats = {}
        for li, layer in enumerate(self.layers):
            defs = self._blob_defs[layer.name]
            if not defs:
                continue
            keys = jax_prng.split(jax_prng.fold_in(key, li), len(defs))
            for d, ref, k in zip(defs, self._blob_refs[layer.name], keys):
                if ref.owner != layer.name:
                    continue  # shared: the owner already initialized it
                arr = fillers.fill(k, d.shape, d.filler).to(device)
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
        rng: Optional[int] = None,
        on_top=None,
    ) -> NetOutputs:
        """Run the net: every named blob (the ``getData`` analog), the
        weighted total loss, and the updated stats.  ``rng`` is the key
        the layers' keys are folded from (None: no layer may draw).
        ``on_top(name, tensor)``, when given, sees every top a layer
        binds, in order (a rebound name once a binding; fed blobs not),
        and returns the tensor to bind in its place: the solver's
        ``debug_info_pass`` hooks the activation gradients there, where
        the JAX net adds its zero taps (``perturb``)."""
        train = (self.phase == "TRAIN") if train is None else train
        blobs: Dict[str, torch.Tensor] = {}
        for b in self.feed_blobs:
            if b not in batch:
                raise ValueError(f"batch missing feed blob {b!r}")
            blobs[b] = batch[b]
        new_stats: Stats = {k: list(v) for k, v in stats.items()}
        loss = None
        cd = self.compute_dtype
        for li, layer in enumerate(self.layers):
            lp = layer.lp
            if li in self._hconv_skip or li in self._plp_skip:
                continue
            if li in self._hconv_groups:
                self._apply_hconv(self._hconv_groups[li], blobs[lp.bottom[0]],
                                  params, blobs, on_top)
                continue
            if li in self._plp_fused:
                pool_top, hp = self._plp_fused[li]
                x = blobs[lp.bottom[0]]
                if cd is not None:
                    x = _cast(x, cd)
                y = cuda_plp.lrn_maxpool(x, *hp)
                blobs[pool_top] = y if on_top is None else on_top(pool_top, y)
                continue
            if isinstance(layer, data_layers._HostFed):
                # host blobs keep their dtype: labels never round
                # through a low-precision compute dtype
                tops = [blobs[t] for t in lp.top]
            else:
                lblobs = self._gather_blobs(layer.name, params, new_stats)
                bottoms = [blobs[b] for b in lp.bottom]
                if cd is not None:
                    if layer.IS_LOSS:
                        # losses compute in float32 (stable log/exp)
                        bottoms = [_cast(b, torch.float32) for b in bottoms]
                    elif not layer.MIXED_PRECISION_EXEMPT:
                        lblobs = [_cast(b, cd) for b in lblobs]
                        bottoms = [_cast(b, cd) for b in bottoms]
                lrng = rngs.fold_in(rng, li) if rng is not None else None
                tops, updated = layer.apply(lblobs, bottoms, lrng, train)
                if not lp.bottom:  # DummyData draws on the host
                    dev = _device_of(batch, params)
                    tops = [t.to(dev) for t in tops]
                if updated is not None:
                    for ref, arr in zip(self._blob_refs[layer.name], updated):
                        if ref.collection == "stats":
                            # stat blobs stay at their master dtype
                            cur = new_stats[ref.owner][ref.index]
                            new_stats[ref.owner][ref.index] = arr.to(cur.dtype)
            if on_top is not None and not isinstance(layer,
                                                     data_layers._HostFed):
                tops = [on_top(name, top) for name, top in zip(lp.top, tops)]
            for w, top in zip(self._loss_weights[layer.name], tops):
                if w:
                    term = w * top.sum()
                    if cd is not None:
                        term = term.float()  # the loss sums in float32
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

    def loss_fn(self, params, stats, batch, train: bool = True,
                rng: Optional[int] = None):
        """``(loss, (blobs, stats))`` — the JAX net's ``loss_fn`` contract."""
        out = self.apply(params, stats, batch, train=train, rng=rng)
        return out.loss, (out.blobs, out.stats)
