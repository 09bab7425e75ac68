"""Data layers: ``HostData`` (and its ``JavaData`` alias), ``Input``,
``Data``, ``ImageData``, ``WindowData``, ``HDF5Data``, ``MemoryData``,
``DummyData`` and the ``HDF5Output`` sink.

The port of ``sparknet_tpu/ops/data_layers.py``: the host input pipeline
pushes ready batches and a host-fed layer binds them to its top names
(the reference's JavaData/RDDLayer, inverted from pull to push).
``Data`` is fed from its DB by the host (``runtime.DataPipeline``),
``ImageData`` from its listfile (``data/transformer.py``), ``WindowData``
by the R-CNN window sampler (``data/windows.py``) and ``HDF5Data`` from
its ``.h5`` files (h5py), all through ``data/source.py``; the
file-backed layers resolve their shapes from their sources as the JAX
layers do.  ``DummyData`` fills its tops from its fillers with the JAX
package's threefry draws (``utils/jax_prng.py``).  ``HDF5Output`` keeps
the bottoms of the last forward that ran it; ``io/hdf5.py
write_net_outputs`` writes them to its ``file_name``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from sparknet_tpu_torch.ops import fillers
from sparknet_tpu_torch.ops.base import Layer, Shape, register
from sparknet_tpu_torch.utils import jax_prng


def hdf5_source_files(source: str) -> List[str]:
    """An HDF5 source's ``.h5`` file list: a single ``.h5``/``.hdf5``
    path, or (the reference convention) a text listfile of paths, a
    relative entry resolved against the listfile's directory."""
    if source.endswith((".h5", ".hdf5")):
        return [source]
    base = os.path.dirname(os.path.abspath(source))
    out = []
    with open(source) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line if os.path.isabs(line)
                           else os.path.join(base, line))
    return out


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
class ImageData(_HostFed):
    """Listfile-fed image data (``image_data_layer.cpp``: ``source`` holds
    "<relpath> <label>" lines).  Shapes: the crop (``transform_param``,
    else the legacy ``image_data_param.crop_size``), else
    new_height/new_width, else the first listed image's size (the
    reference's first-image probe)."""

    TYPE = "ImageData"

    def declared_shapes(self):
        p = self.lp.image_data_param
        if not (p and p.source and p.batch_size):
            return None
        channels = 3 if p.is_color else 1
        if bool(p.new_height) != bool(p.new_width):
            raise ValueError(
                "ImageData: new_height and new_width must be set together")
        tp = self.lp.transform_param
        crop = int(tp.crop_size) if tp and tp.crop_size else int(p.crop_size)
        if crop:
            h = w = crop
        elif p.new_height and p.new_width:
            h, w = int(p.new_height), int(p.new_width)
        else:
            if not os.path.isfile(p.source):
                return None
            try:
                from PIL import Image

                with open(p.source) as f:
                    first = next(ln for ln in (x.strip() for x in f) if ln)
                name = first.rsplit(None, 1)[0]
                with Image.open(os.path.join(p.root_folder, name)) as im:
                    w, h = im.size
            except Exception:  # unreadable: the net then asks for feed_shapes
                return None
        return [(p.batch_size, channels, h, w), (p.batch_size,)]


@register
class WindowData(_HostFed):
    """R-CNN region-sampling data (``window_data_layer.cpp``); its batches
    come from ``data/windows.py WindowSampler`` through
    ``data/source.py``."""

    TYPE = "WindowData"

    def declared_shapes(self):
        p = self.lp.window_data_param
        if not (p and p.batch_size):
            return None
        from sparknet_tpu_torch.data.windows import (
            effective_window_params,
            read_window_file_header,
        )

        crop = effective_window_params(self.lp)[0]
        if not crop:
            return None
        channels = 3
        if p.source and os.path.isfile(p.source):
            try:
                channels = read_window_file_header(p.source)[0]
            except Exception:  # 3 channels; the sampler reports file errors
                pass
        return [(p.batch_size, channels, crop, crop), (p.batch_size,)]


@register
class HDF5Data(_HostFed):
    """HDF5-file-fed data (``hdf5_data_layer.cpp``): ``source`` lists
    ``.h5`` files whose datasets are named by this layer's tops.  Shapes
    come from the first listed file (``LoadHDF5FileData``)."""

    TYPE = "HDF5Data"

    def declared_shapes(self):
        p = self.lp.hdf5_data_param
        if not (p and p.source and p.batch_size):
            return None
        if not os.path.isfile(p.source):
            return None
        files = hdf5_source_files(p.source)
        if not files:
            return None
        import h5py

        with h5py.File(files[0], "r") as h:
            return [(p.batch_size,) + tuple(h[t].shape[1:])
                    for t in self.lp.top]


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


@register
class HDF5Output(Layer):
    """Sink layer (``hdf5_output_layer.cpp``): no tops.  Each forward
    that runs it keeps its bottoms, detached, as ``tapped`` ({bottom
    name: tensor}); ``io/hdf5.py write_net_outputs`` writes the last
    forward's to ``hdf5_output_param.file_name``, one dataset a blob."""

    TYPE = "HDF5Output"

    def __init__(self, lp, phase):
        super().__init__(lp, phase)
        self.tapped = {}

    def out_shapes(self, bottom_shapes):
        return []

    def apply(self, blobs, bottoms, rng, train):
        self.tapped = {name: b.detach()
                       for name, b in zip(self.lp.bottom, bottoms)}
        return [], None
