"""Binary I/O of the port: the wire codec, ``.caffemodel`` weights and
the mean image, HDF5 snapshots, the checkpoint layer (snapshot, verify,
restore, quarantine, job state) and Caffe's dataset stores with the
Datum codec (``io/lmdb.py``, ``io/leveldb.py``: pure-Python readers and
writers, and one-time importers into the runtime's record DB), and the
run journal (``io/journal.py``).

``io/protobin.py`` is the binary codec of the config schema (binary
``NetParameter`` and ``SolverParameter`` files, legacy V0/V1 nets
upgraded on load, layer weight blobs carried through), driven by the
field-number tables of ``io/proto_fields.py``."""

from sparknet_tpu_torch.io.caffemodel import (
    load_mean_image,
    load_weights,
    save_mean_image,
    save_weights,
)

__all__ = ["load_mean_image", "load_weights", "save_mean_image",
           "save_weights"]
