"""The JAX package's weight-initialisation PRNG: threefry2x32, in numpy.

The JAX package draws every initial weight from ``jax.random`` with its
default implementation, threefry2x32 (``sparknet_tpu/utils/rngs.py``:
initialisation keys "stay threefry everywhere").  This module is the
port's own copy of what JAX 0.9.0 computes for float32 under its default
``jax_threefry_partitionable=True``, so that one seed gives the JAX
package's initial weights:

- ``threefry2x32``: the 20-round Threefry-2x32 block with the rotation
  constants and key schedule of ``jax._src.prng``;
- ``prng_key(seed)``: ``[0, seed & 0xFFFFFFFF]`` (without
  ``jax_enable_x64``, the default, JAX keeps the seed's low 32 bits);
- ``fold_in(key, data)``: the block of ``key`` over the counter pair
  ``(0, data)``;
- ``split(key, num)``: key ``i`` is the block of ``key`` over ``(0, i)``
  (the "foldlike" split of the partitionable mode);
- ``random_bits(key, shape)``: element ``i`` (row-major) is ``y0 ^ y1``
  of the block over the 64-bit counter ``i`` as ``(i >> 32, i & mask)``;
- ``uniform``: the top 23 bits as a mantissa of [1, 2), minus 1, then
  ``* (max - min) + min`` rounded once (XLA's CPU backend contracts it
  into one FMA) and clamped below at ``min``;
- ``normal``: ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))`` with
  the single-precision erfinv of Giles that XLA lowers ``erf_inv`` to.
  XLA's ``log1p`` is its own polynomial; this one rounds numpy's float64
  ``log1p`` to float32, so a draw may differ from JAX's by a few ulp
  (``tests/test_torch_jax_prng.py`` pins the bound);
- ``bernoulli(key, p, shape)``: ``uniform(key, shape) < p``.

Keys are numpy ``uint32`` arrays of shape (2,).  Everything runs on the
host, so every device gets the same weights; the hash runs over chunks
in a few threads (numpy releases the interpreter lock): 2.6 s for
AlexNet's 61M parameters on the 8-core host of an H100 machine
(``chip_smoke.py`` prints the time).  Training-step randomness (dropout
masks, crops, mirrors) does not come from here but from ``rngs.py``:
the JAX package draws those with RBG on a TPU and with threefry
elsewhere (``sparknet_tpu/utils/rngs.py``), backend-dependent by design.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

__all__ = ["prng_key", "fold_in", "split", "random_bits", "uniform",
           "normal", "bernoulli", "threefry2x32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_CHUNK = 1 << 18  # elements a job: a few arrays of it stay in cache

# XLA's single-precision erfinv (Giles), highest power first
_ERFINV_SMALL_W = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941], np.float32)
_ERFINV_LARGE_W = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682], np.float32)


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block of ``key`` over the counter pairs
    ``(x0, x1)`` (``uint32`` arrays, updated in place and returned)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ _PARITY))
    x0 += ks[0]
    x1 += ks[1]
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)
            x1 >>= np.uint32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += np.uint32(i + 1)
    return x0, x1


def _block(key, x0: int, x1: int) -> np.ndarray:
    a, b = threefry2x32(key, np.array([x0], np.uint32),
                        np.array([x1], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (64-bit types off): ``[0, seed]``
    over the seed's low 32 bits."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    return _block(key, 0, int(data) & 0xFFFFFFFF)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``num`` keys, shape (num, 2)."""
    x0, x1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([x0, x1], axis=1)


def _map_chunks(n: int, job: Callable[[int, int], None]) -> None:
    """``job(start, stop)`` over ``[0, n)`` in chunks, in a few threads."""
    starts = range(0, n, _CHUNK)
    if len(starts) <= 1:
        for s in starts:
            job(s, n)
        return
    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
        for f in [pool.submit(job, s, min(n, s + _CHUNK)) for s in starts]:
            f.result()


def _bits(key, s: int, e: int) -> np.ndarray:
    counts = np.arange(s, e, dtype=np.uint64)
    x0 = (counts >> np.uint64(32)).astype(np.uint32)
    x1 = counts.astype(np.uint32)
    threefry2x32(key, x0, x1)
    x0 ^= x1
    return x0


def _unit(bits: np.ndarray) -> np.ndarray:
    """[0, 1) from 32 random bits: 23 mantissa bits under exponent 0."""
    bits >>= np.uint32(9)
    bits |= np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def _shape(shape: Sequence[int]):
    shape = tuple(int(s) for s in shape)
    return shape, math.prod(shape)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    shape, n = _shape(shape)
    out = np.empty(n, np.uint32)

    def job(s, e):
        out[s:e] = _bits(key, s, e)

    _map_chunks(n, job)
    return out.reshape(shape)


def _scaled(u: np.ndarray, lo: np.float32, hi: np.float32) -> np.ndarray:
    # u * (hi - lo) + lo rounded once: float64 holds the product and the
    # sum exactly (XLA contracts them into an FMA)
    span = np.float64(np.float32(hi - lo))
    x = (u.astype(np.float64) * span + np.float64(lo)).astype(np.float32)
    return np.maximum(x, lo)


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    shape, n = _shape(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    out = np.empty(n, np.float32)

    def job(s, e):
        out[s:e] = _scaled(_unit(_bits(key, s, e)), lo, hi)

    _map_chunks(n, job)
    return out.reshape(shape)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on (-1, 1) (Giles' polynomials), each
    ``c + p * w`` rounded once as XLA's FMA does."""
    w = -np.log1p(-(x * x).astype(np.float64)).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    w64 = w.astype(np.float64)
    p = np.where(small, _ERFINV_SMALL_W[0], _ERFINV_LARGE_W[0])
    for cs, cl in zip(_ERFINV_SMALL_W[1:], _ERFINV_LARGE_W[1:]):
        c = np.where(small, np.float64(cs), np.float64(cl))
        p = (p * w64 + c).astype(np.float32)
    return p * x


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``, within a few ulp."""
    shape, n = _shape(shape)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    out = np.empty(n, np.float32)
    sqrt2 = np.float32(np.sqrt(2.0))

    def job(s, e):
        u = _scaled(_unit(_bits(key, s, e)), lo, np.float32(1.0))
        out[s:e] = sqrt2 * _erfinv32(u)

    _map_chunks(n, job)
    return out.reshape(shape)


def bernoulli(key: np.ndarray, p: float, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``."""
    return uniform(key, shape) < np.float32(p)
