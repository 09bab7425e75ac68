"""Weight initializers matching the reference's filler semantics.

The port of the ``constant``, ``uniform``, ``gaussian`` (with
``sparse``), ``positive_unitball``, ``xavier``, ``msra`` and ``bilinear``
fillers of
``sparknet_tpu/ops/fillers.py`` (reference: ``filler.hpp``), with the
same fan computation (``fan_in = count / shape[0]``, ``fan_out = count /
shape[1]``).  Each takes a threefry key and draws what the JAX filler
draws from it (``utils/jax_prng.py``): uniform draws bit for bit,
normal draws within a few ulp.  The draws run on the host, so a blob
is the same on every device.

A draw is a pure function of its key, shape and filler, and the
threefry hash is slow (``utils/jax_prng.py``: 2.6 s for AlexNet's 61M
parameters on an H100 machine's 8-core host), so ``fill`` keeps
the draws of its large blobs (``KEEP_MIN_ELEMS`` elements or more,
``KEEP_BYTES`` in all, least recently used out first): a process that
builds one net again from one seed (an app's legs, a second trainer)
hashes its weights once, not each time.  Every call returns its own
copy.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from sparknet_tpu_torch.config.schema import FillerParameter
from sparknet_tpu_torch.utils import jax_prng

__all__ = ["fill", "FILLERS"]

KEEP_MIN_ELEMS = 1 << 16
KEEP_BYTES = 1 << 30
_kept: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_kept_lock = threading.Lock()


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


def _constant(key, shape, p):
    return np.full(shape, p.value, dtype=np.float32)


def _uniform(key, shape, p):
    return jax_prng.uniform(key, shape, p.min, p.max)


def _gaussian(key, shape, p):
    k1, k2 = jax_prng.split(key)
    # mean + std * n, rounded once (XLA contracts it into an FMA)
    x = (jax_prng.normal(k1, shape).astype(np.float64)
         * np.float64(np.float32(p.std))
         + np.float64(np.float32(p.mean))).astype(np.float32)
    if p.sparse >= 0:
        # keep ~sparse non-zeros per output unit (filler.hpp:76-86)
        prob = min(1.0, p.sparse / max(1, shape[0]))
        x = x * jax_prng.bernoulli(k2, prob, shape)
    return x


def _positive_unitball(key, shape, p):
    # uniform [0, 1), then every shape[0]-slice normalised to sum to 1
    flat = jax_prng.uniform(key, shape).reshape(shape[0], -1)
    return (flat / flat.sum(axis=1, keepdims=True)).reshape(shape)


def _xavier(key, shape, p):
    scale = math.sqrt(3.0 / _scale_n(p, shape))
    return jax_prng.uniform(key, shape, -scale, scale)


def _msra(key, shape, p):
    std = math.sqrt(2.0 / _scale_n(p, shape))
    return np.float32(std) * jax_prng.normal(key, shape)


def _bilinear(key, shape, p):
    # upsampling kernel for deconvolution (filler.hpp BilinearFiller)
    if len(shape) != 4 or shape[2] != shape[3]:
        raise ValueError("bilinear filler expects a square 4-D kernel")
    k = shape[3]
    f = math.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w1d = 1 - np.abs(np.arange(k) / f - c)
    return np.broadcast_to(np.outer(w1d, w1d).astype(np.float32), shape)


FILLERS = {
    "constant": _constant,
    "uniform": _uniform,
    "gaussian": _gaussian,
    "positive_unitball": _positive_unitball,
    "xavier": _xavier,
    "msra": _msra,
    "bilinear": _bilinear,
}


def fill(key: np.ndarray, shape: Sequence[int],
         p: FillerParameter | None) -> torch.Tensor:
    """A float32 CPU tensor of ``shape`` per the filler config (constant
    0 if no filler is given, the reference default), drawn from the
    threefry ``key`` as the JAX package's ``fill`` draws it."""
    p = p or FillerParameter()
    fn = FILLERS.get(p.type)
    if fn is None:
        raise NotImplementedError(
            f"filler type {p.type!r} is not yet ported to sparknet_tpu_torch"
        )
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) < KEEP_MIN_ELEMS:
        return torch.from_numpy(
            np.ascontiguousarray(fn(key, shape, p), dtype=np.float32))
    ident = (np.asarray(key).tobytes(), shape, dataclasses.astuple(p))
    with _kept_lock:
        drawn = _kept.get(ident)
        if drawn is not None:
            _kept.move_to_end(ident)
    if drawn is None:
        drawn = np.ascontiguousarray(fn(key, shape, p), dtype=np.float32)
        with _kept_lock:
            _kept[ident] = drawn
            while sum(a.nbytes for a in _kept.values()) > KEEP_BYTES:
                _kept.popitem(last=False)
    return torch.from_numpy(drawn.copy())
