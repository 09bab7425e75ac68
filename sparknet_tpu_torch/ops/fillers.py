"""Weight initializers matching the reference's filler semantics.

The port of the ``gaussian``, ``constant`` and ``xavier`` fillers of
``sparknet_tpu/ops/fillers.py`` (reference: ``filler.hpp``), with the
same fan computation (``fan_in = count / shape[0]``, ``fan_out = count /
shape[1]``).  Random draws come from an explicit ``torch.Generator``:
the values differ from the JAX package's PRNG for the same seed, so
parity tests carry weights across instead (``interop.py``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from sparknet_tpu_torch.config.schema import FillerParameter

__all__ = ["fill", "FILLERS"]


def _fans(shape: Sequence[int]):
    count = math.prod(shape) if shape else 1
    fan_in = count // shape[0] if len(shape) >= 1 and shape[0] else count
    fan_out = count // shape[1] if len(shape) >= 2 and shape[1] else count
    return fan_in, fan_out


def _scale_n(p: FillerParameter, shape) -> float:
    fan_in, fan_out = _fans(shape)
    norm = (p.variance_norm or "FAN_IN").upper()
    if norm == "FAN_IN":
        return float(fan_in)
    if norm == "FAN_OUT":
        return float(fan_out)
    if norm == "AVERAGE":
        return (fan_in + fan_out) / 2.0
    raise ValueError(f"unknown variance_norm {p.variance_norm!r}")


def _constant(gen, shape, p):
    return torch.full(shape, p.value, dtype=torch.float32)


def _gaussian(gen, shape, p):
    x = p.mean + p.std * torch.randn(shape, generator=gen)
    if p.sparse >= 0:
        # keep ~sparse non-zeros per output unit (filler.hpp:76-86)
        prob = min(1.0, p.sparse / max(1, shape[0]))
        x = x * (torch.rand(shape, generator=gen) < prob)
    return x


def _xavier(gen, shape, p):
    scale = math.sqrt(3.0 / _scale_n(p, shape))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * scale


FILLERS = {"constant": _constant, "gaussian": _gaussian, "xavier": _xavier}


def fill(gen: torch.Generator, shape: Sequence[int],
         p: FillerParameter | None) -> torch.Tensor:
    """A float32 CPU tensor of ``shape`` per the filler config (constant
    0 if no filler is given, the reference default)."""
    p = p or FillerParameter()
    fn = FILLERS.get(p.type)
    if fn is None:
        raise NotImplementedError(
            f"filler type {p.type!r} is not yet ported to sparknet_tpu_torch"
        )
    return fn(gen, tuple(int(s) for s in shape), p).to(torch.float32)
