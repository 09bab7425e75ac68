"""Models of the port: the prototxt zoo and the TransformerLM.

``zoo/`` holds the port's own copies of the JAX package's zoo configs,
and ``builders.py`` its builders (CaffeNet, GoogLeNet, ResNet-50 and the
CaffeNet variants, on the DSL of ``dsl.py``).  ``load_model(name)``
returns the NetParameter (a builder model takes ``batch``/``image``/
``classes`` overrides), ``load_model_solver(name)`` the solver with the
net embedded; ``build_transformer_lm(**kw)`` the LM as a Solver net;
``deploy_variant(netp)`` a train/test net's deploy view (the serving
engine builds its net from it, ``serve/engine.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

from sparknet_tpu_torch.config import (
    NetParameter,
    SolverParameter,
    load_net_prototxt,
    load_solver_prototxt,
)

ZOO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zoo")

# prototxt-backed models; the others are builder-backed
# (models/builders.py): a name lives in exactly one registry
_NET_FILES = {
    "cifar10_full": "cifar10_full_train_test.prototxt",
    "lenet": "lenet_train_test.prototxt",
    "alexnet": "alexnet_train_val.prototxt",
    "mnist_siamese": "mnist_siamese_train_test.prototxt",
    "cifar10_quick": "cifar10_quick_train_test.prototxt",
    "mnist_autoencoder": "mnist_autoencoder.prototxt",
}
_SOLVER_FILES = {
    "cifar10_full": "cifar10_full_solver.prototxt",
    "lenet": "lenet_solver.prototxt",
    "alexnet": "alexnet_solver.prototxt",
    "caffenet": "caffenet_solver.prototxt",
    "googlenet": "googlenet_solver.prototxt",
    "resnet50": "resnet50_solver.prototxt",
    "mnist_siamese": "mnist_siamese_solver.prototxt",
    "cifar10_quick": "cifar10_quick_solver.prototxt",
    "mnist_autoencoder": "mnist_autoencoder_solver.prototxt",
}


def available_models() -> List[str]:
    """Every model ``load_model`` builds: the zoo files and the builders."""
    from sparknet_tpu_torch.models.builders import BUILDERS

    return sorted(set(_NET_FILES) | set(BUILDERS))


def solver_models() -> List[str]:
    """Every model ``load_model_solver`` has a zoo solver for."""
    return sorted(_SOLVER_FILES)


def build_transformer_lm(**kwargs):
    """The zoo's sequence model: the decoder-only transformer LM as a
    Solver net (``models/transformer_lm.TransformerLMNet``) — not a
    prototxt net; it plugs into ``Solver(..., net=lm)``."""
    from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet

    return TransformerLMNet(**kwargs)


def load_model(name: str, **builder_kwargs) -> NetParameter:
    """Load a zoo model's net by name: a builder model takes
    ``batch``/``image``/``classes`` overrides, a prototxt model none (use
    ``config.replace_data_layers`` for its batch shapes)."""
    from sparknet_tpu_torch.models.builders import BUILDERS

    if name in BUILDERS:
        return BUILDERS[name](**builder_kwargs)
    if name not in _NET_FILES:
        raise KeyError(f"unknown model {name!r}; have {available_models()}")
    if builder_kwargs:
        raise ValueError(
            f"model {name!r} is prototxt-backed; overrides "
            f"{sorted(builder_kwargs)} only apply to builder models"
        )
    return load_net_prototxt(os.path.join(ZOO_DIR, _NET_FILES[name]))


def deploy_variant(netp: NetParameter, batch: int = 1) -> NetParameter:
    """Train/test config -> deploy config (the transform behind every
    BVLC zoo ``deploy.prototxt``; JAX ``models.deploy_variant``): the
    first data layer becomes a single-top ``Input`` at ``batch``,
    Accuracy/Silence, the label's consumers and non-softmax losses drop,
    and the last ``SoftmaxWithLoss`` becomes a ``Softmax`` scoring layer
    named/topped ``prob``; layers the output does not reach are pruned.
    The TEST-phase view is taken first so train-only layers never leak."""
    from sparknet_tpu_torch.config.schema import (
        BlobShape,
        InputParameter,
        LayerParameter,
        NetState,
    )
    from sparknet_tpu_torch.graph import filter_net
    from sparknet_tpu_torch.ops import common, losses, vision  # noqa: F401
    from sparknet_tpu_torch.ops.base import LAYER_REGISTRY, create_layer
    from sparknet_tpu_torch.ops.data_layers import _HostFed

    def is_loss(type_: str) -> bool:
        cls = LAYER_REGISTRY.get(type_)
        return cls is not None and getattr(cls, "IS_LOSS", False)

    netp = filter_net(netp, NetState(phase="TEST"))
    out: list = []
    label_blobs: set = set()
    data_done = False
    for lp in netp.layer:
        cls = LAYER_REGISTRY.get(lp.type)
        if (cls is not None and issubclass(cls, _HostFed)) or (
            lp.type == "DummyData"
        ):
            if data_done:
                continue
            data_done = True
            tops = list(lp.top)
            label_blobs.update(tops[1:])  # labels never feed deploy nets
            shapes = None
            try:
                layer = create_layer(lp, "TEST")
                if hasattr(layer, "declared_shapes"):
                    shapes = layer.declared_shapes()
                if not shapes:
                    shapes = layer.out_shapes([])  # DummyData's dims
            except Exception:
                shapes = None
            if not shapes:
                raise ValueError(
                    f"deploy_variant: data layer {lp.name!r} declares no "
                    "shapes to derive the Input dims from"
                )
            dims = [batch] + [int(d) for d in shapes[0][1:]]
            out.append(LayerParameter(
                name="data", type="Input", top=[tops[0]],
                input_param=InputParameter(shape=[BlobShape(dim=dims)]),
            ))
            continue
        if lp.type in ("Accuracy", "Silence"):
            continue
        if is_loss(lp.type):
            # kept for now: the LAST SoftmaxWithLoss becomes the prob
            # head below, every other loss (aux heads too) drops
            out.append(lp.copy())
            continue
        if any(b in label_blobs for b in lp.bottom):
            continue  # consumers of the label
        out.append(lp.copy())

    # the final SoftmaxWithLoss is the main head (the zoo lists aux
    # heads first); the other losses drop
    last_swl = max(
        (i for i, l in enumerate(out) if l.type == "SoftmaxWithLoss"),
        default=None,
    )
    pruned = []
    for i, lp in enumerate(out):
        if i == last_swl:
            lp.type = "Softmax"
            lp.name = "prob"
            lp.bottom = [b for b in lp.bottom if b not in label_blobs][:1]
            lp.top = ["prob"]
            lp.loss_weight = []
            pruned.append(lp)
        elif not is_loss(lp.type):
            pruned.append(lp)
    out = pruned

    # keep only the layers the output reaches: with a prob head it is
    # the sole output (the aux towers' tops are unconsumed too); a
    # headless net keeps every terminal top
    if last_swl is not None:
        live = {"prob"}
    else:
        consumed = {b for lp in out for b in lp.bottom}
        live = {t for lp in out for t in lp.top if t not in consumed}
    keep = []
    for lp in reversed(out):
        if lp.type == "Input" or any(t in live for t in lp.top):
            keep.append(lp)
            live.update(lp.bottom)
    return dataclasses.replace(netp, layer=list(reversed(keep)))


def load_model_solver(name: str) -> SolverParameter:
    """Load a zoo model's solver with its net embedded inline."""
    if name not in _SOLVER_FILES:
        raise KeyError(f"no zoo solver for {name!r}; have {sorted(_SOLVER_FILES)}")
    solver = load_solver_prototxt(os.path.join(ZOO_DIR, _SOLVER_FILES[name]))
    solver.net = None
    solver.net_param = load_model(name)
    return solver
