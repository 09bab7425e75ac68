"""Data layers: ``HostData`` (and its ``JavaData`` alias), ``Input``,
``Data``, ``MemoryData`` and ``DummyData``.

The port of those layers of ``sparknet_tpu/ops/data_layers.py``: the
host input pipeline pushes ready batches and a host-fed layer binds
them to its top names (the reference's JavaData/RDDLayer, inverted from
pull to push).  ``Data`` is fed from its DB by the host
(``runtime.DataPipeline``, ``data/source.py``).  ``DummyData`` fills its
tops from its fillers with the JAX package's threefry draws
(``utils/jax_prng.py``).  The file-backed ``ImageData``, ``WindowData``,
``HDF5Data`` and ``HDF5Output`` are not yet ported (``ops/base.py``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from sparknet_tpu_torch.ops import fillers
from sparknet_tpu_torch.ops.base import Layer, Shape, register
from sparknet_tpu_torch.utils import jax_prng


class _HostFed(Layer):
    """Tops come from the externally supplied batch dict, keyed by top
    name; shapes come from the layer config."""

    def declared_shapes(self) -> Optional[List[Shape]]:
        return None

    def out_shapes(self, bottom_shapes):
        shapes = self.declared_shapes()
        if shapes is None:
            raise ValueError(
                f"layer {self.name!r} ({self.TYPE}) needs feed shapes: pass "
                f"feed_shapes={{top: shape}} to the net, or declare them in "
                f"the layer config"
            )
        return shapes

    def apply(self, blobs, bottoms, rng, train):
        raise RuntimeError(
            f"data layer {self.name!r} tops must be bound from the batch"
        )


def _shapes_of(param) -> Optional[List[Shape]]:
    if param and param.shape:
        return [tuple(int(d) for d in s.dim) for s in param.shape]
    return None


@register
class HostData(_HostFed):
    """Shapes declared inline via ``java_data_param.shape`` (reference:
    JavaDataParameter, caffe.proto:991-993)."""

    TYPE = "HostData"

    def declared_shapes(self):
        return _shapes_of(self.lp.java_data_param)


@register
class JavaData(HostData):
    """Alias so reference configs naming JavaData load unchanged."""

    TYPE = "JavaData"


@register
class Data(_HostFed):
    """DB-backed data layer (reference: ``data_layer.cpp``): its DB read
    and transform run on the host (``runtime.DataPipeline``, through
    ``data/source.py``); its shapes come from the net's ``feed_shapes``."""

    TYPE = "Data"


@register
class Input(_HostFed):
    """Deploy-net input (``input_layer.cpp``): shapes from
    ``input_param.shape``."""

    TYPE = "Input"

    def declared_shapes(self):
        return _shapes_of(self.lp.input_param)


@register
class MemoryData(_HostFed):
    """In-memory batches (``memory_data_layer.cpp``): data and label tops
    shaped by ``memory_data_param``."""

    TYPE = "MemoryData"

    def declared_shapes(self):
        p = self.lp.memory_data_param
        if p and p.batch_size:
            return [(p.batch_size, p.channels, p.height, p.width),
                    (p.batch_size,)]
        return None


def threefry_key(key: Optional[int]) -> np.ndarray:
    """A threefry key for a training-step key (``utils/rngs.py``): its
    high and low 32 bits; None gives ``PRNGKey(0)``, the JAX layer's key
    when the net is given none."""
    if key is None:
        return jax_prng.prng_key(0)
    return np.array([(int(key) >> 32) & 0xFFFFFFFF, int(key) & 0xFFFFFFFF],
                    np.uint32)


@register
class DummyData(Layer):
    """Filler-generated data (``dummy_data_layer.cpp``): top ``i`` is
    filled from ``fold_in(base, i)``, ``base`` the layer's key (constant
    fillers refill identically every step; random ones draw per step).
    The draws run on the host; the net moves the tops to its device."""

    TYPE = "DummyData"

    def _shapes(self):
        p = self.lp.dummy_data_param
        if p.shape:
            return [tuple(int(d) for d in s.dim) for s in p.shape]
        return [
            tuple(dims[i] if i < len(dims) else dims[-1]
                  for dims in (p.num, p.channels, p.height, p.width))
            for i in range(max(len(p.num), 1))
        ]

    def out_shapes(self, bottom_shapes):
        return self._shapes()

    def apply(self, blobs, bottoms, rng, train):
        p = self.lp.dummy_data_param
        base = threefry_key(rng)
        tops = []
        for i, shape in enumerate(self._shapes()):
            filler = (p.data_filler[i] if i < len(p.data_filler)
                      else (p.data_filler[-1] if p.data_filler else None))
            tops.append(fillers.fill(jax_prng.fold_in(base, i), shape, filler))
        return tops, None
