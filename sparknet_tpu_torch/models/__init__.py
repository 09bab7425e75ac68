"""Models of the port: the prototxt zoo and the TransformerLM.

``zoo/`` holds the port's own copies of the JAX package's zoo configs,
and ``builders.py`` its builders (CaffeNet, GoogLeNet, ResNet-50 and the
CaffeNet variants, on the DSL of ``dsl.py``).  ``load_model(name)``
returns the NetParameter (a builder model takes ``batch``/``image``/
``classes`` overrides), ``load_model_solver(name)`` the solver with the
net embedded; ``build_transformer_lm(**kw)`` the LM as a Solver net.
``deploy_variant`` of the JAX package is not yet ported.
"""

from __future__ import annotations

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


def load_model_solver(name: str) -> SolverParameter:
    """Load a zoo model's solver with its net embedded inline."""
    if name not in _SOLVER_FILES:
        raise KeyError(f"no zoo solver for {name!r}; have {sorted(_SOLVER_FILES)}")
    solver = load_solver_prototxt(os.path.join(ZOO_DIR, _SOLVER_FILES[name]))
    solver.net = None
    solver.net_param = load_model(name)
    return solver
