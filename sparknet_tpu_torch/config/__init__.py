"""Config system of the port: proto2-text net/solver definitions.

Own copy of ``sparknet_tpu/config``: typed dataclasses
(``config.schema``) bound by a prototxt parser (``config.prototext``).
"""

import os

from sparknet_tpu_torch.config.prototext import ParseError, parse, parse_file
from sparknet_tpu_torch.config.schema import (
    BlobShape,
    JavaDataParameter,
    LayerParameter,
    NetParameter,
    NetState,
    NetStateRule,
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
    "replace_data_layers",
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


# data layer types replace_data_layers swaps for host-fed layers
_DATA_TYPES = frozenset((
    "Data", "ImageData", "HDF5Data", "MemoryData", "DummyData", "WindowData",
    "JavaData", "HostData", "Input",
))


def replace_data_layers(
    net: NetParameter,
    train_batch_shapes,
    test_batch_shapes=None,
) -> NetParameter:
    """Swap the net's data layers for host-fed ``HostData`` layers, one
    per phase, with the given top shapes (reference:
    ``ProtoLoader.replaceDataLayers``, ProtoLoader.scala:50-57; JAX
    ``config.replace_data_layers``).  The tops are the first data layer's
    (default ``data``, ``label``); shapes are lists, one per top, such as
    ``[(N, C, H, W), (N,)]``."""
    net = net.copy()
    kept = [lp for lp in net.layer if lp.type not in _DATA_TYPES]
    tops = next((list(lp.top) for lp in net.layer if lp.type in _DATA_TYPES),
                ["data", "label"])

    def host(phase, shapes):
        return LayerParameter(
            name=f"{'train' if phase == 'TRAIN' else 'test'}_data",
            type="HostData",
            top=list(tops[: len(shapes)]),
            include=[NetStateRule(phase=phase)],
            java_data_param=JavaDataParameter(
                shape=[BlobShape(dim=list(map(int, s))) for s in shapes]
            ),
        )

    new_layers = [host("TRAIN", train_batch_shapes)]
    if test_batch_shapes is not None:
        new_layers.append(host("TEST", test_batch_shapes))
    net.layer = new_layers + kept
    return net
