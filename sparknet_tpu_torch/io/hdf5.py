"""HDF5 weight and solver-state I/O — the reference's second snapshot
format.

The port's own copy of ``sparknet_tpu/io/hdf5.py``.  ``h5py`` is
imported inside each function, so the port (and ``io/checkpoint.py``)
imports without it; only an HDF5 snapshot needs it.

Layout matches Caffe so files interchange conceptually:

- weights (``Net::ToHDF5`` / ``CopyTrainedLayersFromHDF5``,
  ``caffe/src/caffe/net.cpp:856-981``): group ``/data`` containing one
  group per layer name, with datasets ``"0"``, ``"1"``, ... for that
  layer's param blobs.
- solver state (``SGDSolver::SnapshotSolverStateToHDF5`` /
  ``RestoreSolverStateFromHDF5``, ``sgd_solver.cpp:242-290``): datasets
  ``iter`` and ``current_step`` plus group ``/history`` with datasets
  ``"0"``..``"n-1"`` in flattened-tree order (``utils/tree.py``).

File naming follows the reference: ``{prefix}_iter_{N}.caffemodel.h5`` and
``{prefix}_iter_{N}.solverstate.h5`` (``solver.cpp:459-476``).

- ``HDF5Output`` layer files (``hdf5_output_layer.cpp``): one dataset per
  tapped blob, named by the blob (``write_hdf5_output``;
  ``write_net_outputs`` writes every HDF5Output layer of a net).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sparknet_tpu_torch.io.caffemodel import Blobs


def save_weights_hdf5(layer_blobs: Blobs, path: str) -> None:
    """Write {layer: [blob arrays]} in Net::ToHDF5 layout."""
    import h5py

    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for layer, blobs in layer_blobs.items():
            g = data.create_group(layer)
            for i, arr in enumerate(blobs):
                g.create_dataset(str(i), data=np.asarray(arr, np.float32))


def load_weights_hdf5(path: str) -> Blobs:
    """Read Net::ToHDF5 layout back into {layer: [blob arrays]}."""
    import h5py

    out: Blobs = {}
    with h5py.File(path, "r") as f:
        if "data" not in f:
            raise IOError(f"{path}: no /data group (not a caffemodel.h5)")
        data = f["data"]
        for layer in data:
            g = data[layer]
            out[layer] = [
                np.asarray(g[str(i)], np.float32) for i in range(len(g))
            ]
    return out


def save_state_hdf5(path: str, it: int, history_leaves: List[np.ndarray],
                    current_step: int = 0) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("iter", data=np.asarray(it, np.int64))
        f.create_dataset("current_step", data=np.asarray(current_step, np.int64))
        g = f.create_group("history")
        for i, leaf in enumerate(history_leaves):
            g.create_dataset(str(i), data=np.asarray(leaf))


def load_state_hdf5(path: str):
    """Returns (iter, current_step, [history leaves])."""
    import h5py

    with h5py.File(path, "r") as f:
        it = int(np.asarray(f["iter"]))
        step = int(np.asarray(f["current_step"])) if "current_step" in f else 0
        g = f["history"]
        leaves = [np.asarray(g[str(i)]) for i in range(len(g))]
    return it, step, leaves


def write_hdf5_output(path: str, blobs: Dict[str, np.ndarray]) -> None:
    """HDF5Output's host-side writer: one dataset per blob name
    (``hdf5_output_layer.cpp`` writes its bottoms under their names)."""
    import h5py

    with h5py.File(path, "w") as f:
        for name, arr in blobs.items():
            f.create_dataset(name, data=np.asarray(arr))


def write_net_outputs(net) -> List[str]:
    """Write each ``HDF5Output`` layer of ``net`` that has run to its
    ``hdf5_output_param.file_name``: the bottoms of its last forward.
    Returns the paths written."""
    from sparknet_tpu_torch.ops.data_layers import HDF5Output

    paths = []
    for layer in net.layers:
        if isinstance(layer, HDF5Output) and layer.tapped:
            path = layer.lp.hdf5_output_param.file_name
            write_hdf5_output(path, {k: t.cpu().numpy()
                                     for k, t in layer.tapped.items()})
            paths.append(path)
    return paths
