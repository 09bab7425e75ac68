"""Training-step keys: the port's counterpart of ``jax.random`` keys.

A key is a non-negative 63-bit integer.  ``fold_in(key, data)`` derives
a new key from a key and an integer, as ``jax.random.fold_in`` does, so
the JAX package's key structure carries over: the trainer folds in the
worker, the solver the iteration, the net the layer index.  What holds
is that one key gives one stream, on any device: ``generator(key)`` is a
CPU ``torch.Generator``, and what a layer draws from it (a dropout mask,
crop offsets) is drawn on the CPU and copied to the tensor's device, so
a run on the card and a run on the CPU draw the same masks and crops.

These bits are not the JAX package's, and need not be: it draws its
training-step randomness with RBG on a TPU and with threefry elsewhere
(``sparknet_tpu/utils/rngs.py``), backend-dependent by design.  Initial
weights are another matter: the JAX package draws them with threefry on
every backend, and the port draws the same bits (``jax_prng.py``).
"""

from __future__ import annotations

import hashlib
import struct

import torch

_MASK63 = (1 << 63) - 1


def train_key(seed: int = 0) -> int:
    """The root key of training-step randomness for ``seed``."""
    return fold_in(0x5EED, int(seed))


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and the integer ``data`` (63 bits of the
    SHA-256 of both)."""
    digest = hashlib.sha256(
        struct.pack("<QQ", int(key) & _MASK63, int(data) & ((1 << 64) - 1))
    ).digest()
    return int.from_bytes(digest[:8], "little") & _MASK63


def generator(key: int) -> torch.Generator:
    """A CPU generator seeded with ``key``."""
    return torch.Generator().manual_seed(int(key))
