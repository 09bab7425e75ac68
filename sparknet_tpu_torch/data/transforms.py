"""Device-side batch transforms: the train/test preprocessing closures.

The port of ``train_transform`` and ``test_transform`` of
``sparknet_tpu/data/transforms.py`` (reference:
``ImageNetApp.scala:128-180``, ``data_transformer.cpp:19-132``).  Batches
cross to the device as uint8 at full size; the crop, the mirror and the
mean subtraction run there, on the solver's device, before the forward.

- ``train_transform``: per-image random crop offsets and an optional
  per-image mirror, the mean subtracted over the image's source window
  (data_transformer.cpp:49-58), optional scale.
- ``test_transform``: the centre crop at ``(H - crop) // 2``, the mean
  subtracted, no mirror.

The offsets and flips are drawn from ``utils.rngs.generator(key)`` on the
CPU and copied over (a few hundred bytes), so one key gives one crop on
any device.  The bits cannot equal JAX's ``jax.random``; ``crop_batch``
takes explicit offsets and flips, so the arithmetic is held to JAX's
``_crop_one`` in the tests.  ``finish_host_crops`` and
``from_transform_param`` are not ported: no layer on the ported paths
uses them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from sparknet_tpu_torch.utils import rngs

Batch = Dict[str, torch.Tensor]

__all__ = ["crop_batch", "test_transform", "train_transform"]


def _placed_mean(mean: Optional[np.ndarray]):
    """``dev -> the mean image as float32 on dev`` (None without a mean),
    copied once per device."""
    host = None if mean is None else torch.from_numpy(
        np.array(mean, np.float32))
    placed: Dict[torch.device, torch.Tensor] = {}

    def on(dev: torch.device) -> Optional[torch.Tensor]:
        if host is None:
            return None
        if dev not in placed:
            placed[dev] = host.to(dev)
        return placed[dev]

    return on


def crop_batch(imgs: torch.Tensor, mean: Optional[torch.Tensor], h_offs,
               w_offs, flips, crop: int, scale: float = 1.0) -> torch.Tensor:
    """``(N, C, crop, crop)`` float32: image ``i``'s window at
    ``(h_offs[i], w_offs[i])``, minus the mean over the same source window
    (or a per-channel ``(C, 1, 1)`` mean), times ``scale``, mirrored where
    ``flips[i]`` — JAX ``_crop_one`` on every image.  The mirror is an
    index order: image and mean are read at the same reversed columns, so
    it commutes with the subtraction exactly."""
    n = imgs.shape[0]
    dev = imgs.device
    h_offs = torch.as_tensor(h_offs, dtype=torch.int64).to(dev)
    w_offs = torch.as_tensor(w_offs, dtype=torch.int64).to(dev)
    flips = torch.as_tensor(flips, dtype=torch.bool).to(dev)
    ar = torch.arange(crop, device=dev)
    cols = torch.where(flips[:, None], crop - 1 - ar[None, :], ar[None, :])
    rows = (h_offs[:, None] + ar[None, :])[:, :, None]  # (N, crop, 1)
    cols = (w_offs[:, None] + cols)[:, None, :]  # (N, 1, crop)
    bi = torch.arange(n, device=dev)[:, None, None]
    win = imgs.permute(0, 2, 3, 1)[bi, rows, cols].to(torch.float32)
    if mean is not None:
        if tuple(mean.shape[-2:]) == (1, 1):  # per-channel mean: broadcast
            win = win - mean.reshape(1, 1, 1, -1)
        else:  # the full mean image, indexed by the source window
            win = win - mean.permute(1, 2, 0)[rows, cols]
    if scale != 1.0:
        win = win * scale
    return win.permute(0, 3, 1, 2).contiguous()


def train_transform(
    mean: Optional[np.ndarray],
    crop: int,
    mirror: bool = True,
    scale: float = 1.0,
    data_key: str = "data",
) -> Callable[[Batch, int], Batch]:
    """Random crop + mirror + mean-subtraction for the TRAIN phase
    (``imageNetTrainPreprocessing``, ImageNetApp.scala:166-180): per image
    a crop offset in ``[0, H - crop]`` and ``[0, W - crop]`` and, with
    ``mirror``, a fair coin for the flip, drawn in that order from the
    key's CPU generator."""
    mean_on = _placed_mean(mean)

    def fn(batch: Batch, rng: int) -> Batch:
        imgs = batch[data_key]
        n, _, h, w = imgs.shape
        gen = rngs.generator(rng)
        h_offs = torch.randint(0, h - crop + 1, (n,), generator=gen)
        w_offs = torch.randint(0, w - crop + 1, (n,), generator=gen)
        flips = (torch.rand((n,), generator=gen) < 0.5 if mirror
                 else torch.zeros((n,), dtype=torch.bool))
        new = dict(batch)
        new[data_key] = crop_batch(imgs, mean_on(imgs.device),
                                   h_offs, w_offs, flips, crop, scale)
        return new

    return fn


def test_transform(
    mean: Optional[np.ndarray],
    crop: int,
    scale: float = 1.0,
    data_key: str = "data",
) -> Callable[[Batch], Batch]:
    """Centre crop + mean-subtraction for the TEST phase
    (``imageNetTestPreprocessing``, ImageNetApp.scala:128-142)."""
    mean_on = _placed_mean(mean)

    def fn(batch: Batch) -> Batch:
        imgs = batch[data_key]
        _, _, h, w = imgs.shape
        h_off, w_off = (h - crop) // 2, (w - crop) // 2
        out = imgs[:, :, h_off:h_off + crop, w_off:w_off + crop].to(
            torch.float32)
        m = mean_on(imgs.device)
        if m is not None:
            if tuple(m.shape[-2:]) == (1, 1):
                out = out - m
            else:
                out = out - m[:, h_off:h_off + crop, w_off:w_off + crop]
        if scale != 1.0:
            out = out * scale
        new = dict(batch)
        new[data_key] = out
        return new

    return fn
