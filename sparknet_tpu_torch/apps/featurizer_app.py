"""FeaturizerApp — batch feature extraction.

The port of ``sparknet_tpu/apps/featurizer_app.py`` (reference:
``src/main/scala/apps/FeaturizerApp.scala:88-103``: broadcast the
weights once, forward each minibatch, pull a named blob back).  The
TEST net runs on the device; its forward returns every blob, so the tap
is a dict lookup.  The batches come from ``data/source.py
resolve_batches``, so every source feeds it: a CIFAR directory, an LMDB,
a LevelDB or a record DB (``--data``), or the net's own ``Data``,
``HDF5Data``, ``WindowData`` or ``ImageData`` layer.

Run (on the card; ``--device cpu`` runs the kernels' plain versions)::

    python -m sparknet_tpu_torch.apps.featurizer_app --model NAME|NET.prototxt \\
        --blob fc7 [--data DIR|DB] [--weights F.caffemodel] [--batches 4] \\
        [--out features.npz|features.h5]

``--out`` ending in ``.h5``/``.hdf5`` writes one dataset named by the
blob (the HDF5Output layer's role, ``io/hdf5.py``; needs h5py), any
other path an ``.npz`` with ``features``.  ``--allow_synthetic``
featurizes seeded random batches (smoke tests only).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None, result: Optional[dict] = None) -> int:
    """Extract; returns the exit code.  ``result``, when given, receives
    the features ``(batches, ...)``."""
    p = argparse.ArgumentParser(prog="sparknet_tpu_torch.apps.featurizer_app")
    p.add_argument("--model", default="cifar10_full",
                   help="a zoo name or a net prototxt")
    p.add_argument("--blob", default="ip1")
    p.add_argument("--weights", default=None)
    p.add_argument("--data", default=None,
                   help="CIFAR binary dir, LMDB, LevelDB, record DB, or an "
                   ".h5/listfile for an HDF5Data net (omitted: the net's "
                   "own source)")
    p.add_argument("--allow_synthetic", action="store_true",
                   help="smoke-test only: featurize random batches")
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a CUDA device) or cpu")
    args = p.parse_args(argv)

    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.data.source import resolve_batches
    from sparknet_tpu_torch.io import caffemodel
    from sparknet_tpu_torch.net import TorchNet
    from sparknet_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    netp = (config.load_net_prototxt(args.model)
            if args.model.endswith(".prototxt") else models.load_model(args.model))
    net = TorchNet(netp, phase="TEST")
    params, stats = net.init(0, device)
    if args.weights:
        params, stats = caffemodel.apply_blobs(
            net, params, stats, caffemodel.load_weights(args.weights))

    # real minibatches (FeaturizerApp.scala:88-103 pulls them from the RDD)
    stacked = resolve_batches(net, netp, args.data, args.batches, phase="TEST",
                              allow_synthetic=args.allow_synthetic)
    feats = []
    with torch.no_grad():
        for i in range(args.batches):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[i])).to(device)
                     for k, v in stacked.items()}
            blobs = net.forward(params, stats, batch)
            if args.blob not in blobs:
                raise SystemExit(
                    f"blob {args.blob!r} not in net; have {sorted(blobs)}")
            feats.append(blobs[args.blob].cpu().numpy())
    features = np.stack(feats)
    print(f"extracted {args.blob}: {features.shape}")
    if args.out:
        if args.out.endswith((".h5", ".hdf5")):
            # the HDF5Output layer's role: the tapped blob as a dataset
            from sparknet_tpu_torch.io.hdf5 import write_hdf5_output

            write_hdf5_output(args.out, {args.blob: features})
            print(f"wrote {args.out} (HDF5, dataset {args.blob!r})")
        else:
            np.savez(args.out, features=features)
            print(f"wrote {args.out}")
    if result is not None:
        result["features"] = features
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
