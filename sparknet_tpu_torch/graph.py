"""Graph passes over NetParameter.

The port of ``sparknet_tpu/graph.py``: the phase/stage/level filter
(``net.cpp:287-366``) and the listed-order bottom check.  Split
insertion is not needed: autograd accumulates fan-out gradients itself.
"""

from __future__ import annotations

from typing import Iterable

from sparknet_tpu_torch.config.schema import (
    LayerParameter,
    NetParameter,
    NetState,
    NetStateRule,
)

__all__ = ["filter_net", "state_meets_rule", "toposort_check"]


def state_meets_rule(state: NetState, rule: NetStateRule) -> bool:
    """NetState vs NetStateRule matching (``net.cpp StateMeetsRule``)."""
    if rule.phase is not None and rule.phase != state.phase:
        return False
    if rule.min_level is not None and state.level < rule.min_level:
        return False
    if rule.max_level is not None and state.level > rule.max_level:
        return False
    if any(s not in state.stage for s in rule.stage):
        return False
    return not any(s in state.stage for s in rule.not_stage)


def _layer_included(layer: LayerParameter, state: NetState) -> bool:
    # legacy per-layer phase field acts like an include rule
    if layer.phase is not None and not layer.include and layer.phase != state.phase:
        return False
    if layer.include:
        return any(state_meets_rule(state, r) for r in layer.include)
    return not any(state_meets_rule(state, r) for r in layer.exclude)


def filter_net(net: NetParameter, state: NetState) -> NetParameter:
    """A copy of ``net`` keeping only layers whose rules admit ``state``."""
    out = net.copy()
    out.state = NetState(
        phase=state.phase, level=state.level, stage=list(state.stage)
    )
    out.layer = [l for l in net.layer if _layer_included(l, state)]
    return out


def toposort_check(net: NetParameter, external_tops: Iterable[str] = ()) -> None:
    """Layers run in listed order and every bottom must already be
    produced (``net.cpp AppendBottom``); in-place tops rebind a name."""
    available = set(external_tops) | set(net.input)
    for layer in net.layer:
        for b in layer.bottom:
            if b not in available:
                raise ValueError(
                    f"layer {layer.name!r}: unknown bottom blob {b!r} "
                    f"(blob order follows listed layer order)"
                )
        available.update(layer.top)
