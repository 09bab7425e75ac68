"""Config system of the port: proto2-text net/solver definitions.

Own copy of ``sparknet_tpu/config``: typed dataclasses
(``config.schema``) bound by a prototxt parser (``config.prototext``).
"""

import os

from sparknet_tpu_torch.config.prototext import ParseError, parse, parse_file
from sparknet_tpu_torch.config.schema import (
    LayerParameter,
    NetParameter,
    NetState,
    SolverParameter,
)

__all__ = [
    "LayerParameter",
    "NetParameter",
    "NetState",
    "ParseError",
    "SolverParameter",
    "load_net_prototxt",
    "load_solver_prototxt",
    "parse_net_prototxt",
    "parse_solver_prototxt",
    "resolve_solver_net",
]


def parse_net_prototxt(text: str, permissive: bool = False) -> NetParameter:
    return parse(text, NetParameter, permissive=permissive)


def parse_solver_prototxt(text: str, permissive: bool = False) -> SolverParameter:
    return parse(text, SolverParameter, permissive=permissive)


def load_net_prototxt(path: str, permissive: bool = False) -> NetParameter:
    return parse_file(path, NetParameter, permissive=permissive)


def load_solver_prototxt(path: str, permissive: bool = False) -> SolverParameter:
    """Net paths resolve relative to the cwd, falling back to the solver
    file's own directory so zoo configs load from any cwd."""
    solver = parse_file(path, SolverParameter, permissive=permissive)
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        if p and not os.path.isabs(p) and not os.path.exists(p):
            cand = os.path.join(base, p)
            if os.path.exists(cand):
                return cand
        return p

    solver.net = resolve(solver.net)
    solver.train_net = resolve(solver.train_net)
    solver.test_net = [resolve(p) for p in solver.test_net]
    return solver


def resolve_solver_net(solver: SolverParameter) -> NetParameter:
    """The solver's net definition, whichever field carries it (inline
    ``net_param``/``train_net_param`` or the ``net``/``train_net`` file
    path) — ``Solver::InitTrainNet``'s resolution order."""
    netp = solver.net_param or solver.train_net_param
    if netp is not None:
        return netp
    path = solver.net or solver.train_net
    if path is None:
        raise ValueError("solver has no net definition")
    return load_net_prototxt(path)
