"""Models of the port: the prototxt zoo and the TransformerLM.

``zoo/`` holds the port's own copies of the JAX package's zoo configs
for the ported training paths (cifar10_full, AlexNet), and
``builders.py`` the CaffeNet builder.  ``load_model(name)`` returns the
NetParameter (a builder model takes ``batch``/``image``/``classes``
overrides), ``load_model_solver(name)`` the solver with the net
embedded; ``build_transformer_lm(**kw)`` the LM as a Solver net.  The
other zoo models come with later slices.
"""

from __future__ import annotations

import os

from sparknet_tpu_torch.config import (
    NetParameter,
    SolverParameter,
    load_net_prototxt,
    load_solver_prototxt,
)

ZOO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zoo")

# prototxt-backed models; caffenet is builder-backed (models/builders.py)
_NET_FILES = {
    "cifar10_full": "cifar10_full_train_test.prototxt",
    "alexnet": "alexnet_train_val.prototxt",
}
_SOLVER_FILES = {
    "cifar10_full": "cifar10_full_solver.prototxt",
    "alexnet": "alexnet_solver.prototxt",
    "caffenet": "caffenet_solver.prototxt",
}
# zoo models of the JAX package that later slices bring
_NOT_YET_PORTED = (
    "lenet", "googlenet", "resnet50", "flickr_style", "rcnn_ilsvrc13",
    "mnist_siamese", "cifar10_quick", "mnist_autoencoder",
)


def _check(name: str, table) -> str:
    if name in table:
        return os.path.join(ZOO_DIR, table[name])
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not yet ported to sparknet_tpu_torch"
        )
    raise KeyError(f"unknown model {name!r}; have {sorted(table)}")


def build_transformer_lm(**kwargs):
    """The zoo's sequence model: the decoder-only transformer LM as a
    Solver net (``models/transformer_lm.TransformerLMNet``) — not a
    prototxt net; it plugs into ``Solver(..., net=lm)``."""
    from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet

    return TransformerLMNet(**kwargs)


def load_model(name: str, **builder_kwargs) -> NetParameter:
    """Load a zoo model's net by name: a builder model (``caffenet``)
    takes ``batch``/``image``/``classes`` overrides, a prototxt model
    none (use ``config.replace_data_layers`` for its batch shapes)."""
    from sparknet_tpu_torch.models.builders import BUILDERS

    if name in BUILDERS:
        return BUILDERS[name](**builder_kwargs)
    path = _check(name, _NET_FILES)
    if builder_kwargs:
        raise ValueError(
            f"model {name!r} is prototxt-backed; overrides "
            f"{sorted(builder_kwargs)} only apply to builder models"
        )
    return load_net_prototxt(path)


def load_model_solver(name: str) -> SolverParameter:
    """Load a zoo model's solver with its net embedded inline."""
    solver = load_solver_prototxt(_check(name, _SOLVER_FILES))
    solver.net = None
    solver.net_param = load_model(name)
    return solver
