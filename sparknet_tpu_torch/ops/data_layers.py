"""Host-fed data layers: ``HostData`` and its ``JavaData`` alias.

The port of those layers of ``sparknet_tpu/ops/data_layers.py``: the
host input pipeline pushes ready batches and a data layer binds them to
its top names (the reference's JavaData/RDDLayer, inverted from pull to
push).  The DB- and file-backed data layers come with later slices.
"""

from __future__ import annotations

from typing import List, Optional

from sparknet_tpu_torch.ops.base import Layer, Shape, register


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

    def apply(self, blobs, bottoms, train):
        raise RuntimeError(
            f"data layer {self.name!r} tops must be bound from the batch"
        )


@register
class HostData(_HostFed):
    """Shapes declared inline via ``java_data_param.shape`` (reference:
    JavaDataParameter, caffe.proto:991-993)."""

    TYPE = "HostData"

    def declared_shapes(self):
        p = self.lp.java_data_param
        if p and p.shape:
            return [tuple(int(d) for d in s.dim) for s in p.shape]
        return None


@register
class JavaData(HostData):
    """Alias so reference configs naming JavaData load unchanged."""

    TYPE = "JavaData"
