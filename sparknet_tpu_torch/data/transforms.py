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
- ``finish_host_crops``: the device-side finish of the native reader's
  ``u8_output`` mode (``runtime.DataPipeline(u8_output=True)``): uint8
  crop windows arrive with their ``h_off``/``w_off``/``flip``; the mean
  over each source window is subtracted, the scale applied and the
  mirror taken on the device.
- ``from_transform_param``: the phase's closure from a layer's
  ``TransformationParameter`` (crop, mirror, scale, mean_file or
  mean_value), with the no-crop branches.

The offsets and flips are drawn from ``utils.rngs.generator(key)`` on the
CPU and copied over (a few hundred bytes), so one key gives one crop on
any device.  The bits cannot equal JAX's ``jax.random``; ``crop_batch``
takes explicit offsets and flips, so the arithmetic is held to JAX's
``_crop_one`` in the tests.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from sparknet_tpu_torch.utils import rngs

Batch = Dict[str, torch.Tensor]

__all__ = ["crop_batch", "finish_host_crops", "from_transform_param",
           "test_transform", "train_transform"]


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


def finish_host_crops(
    mean: Optional[np.ndarray],
    scale: float = 1.0,
    data_key: str = "data",
) -> Callable[[Batch, Optional[int]], Batch]:
    """The device-side finish for the native reader's ``u8_output``
    mode: the host shipped uint8 crop windows and their geometry
    (``h_off``/``w_off``/``flip`` batch keys); this subtracts the mean
    over each image's source window of the full mean image
    (data_transformer.cpp:49-58), or a per-channel mean, scales and
    mirrors, and drops the geometry keys.  The key argument is ignored:
    the randomness was drawn on the host."""
    mean_on = _placed_mean(mean)

    def fn(batch: Batch, rng=None) -> Batch:
        x = batch[data_key].to(torch.float32)
        n, _, crop_h, crop_w = x.shape
        m = mean_on(x.device)
        if m is not None:
            if m.dim() == 1 or tuple(m.shape[-2:]) == (1, 1):
                x = x - m.reshape(-1, 1, 1)
            else:
                dev = x.device
                h_offs = batch["h_off"].to(dev, torch.int64)
                w_offs = batch["w_off"].to(dev, torch.int64)
                rows = (h_offs[:, None] + torch.arange(crop_h, device=dev))
                cols = (w_offs[:, None] + torch.arange(crop_w, device=dev))
                win = m.permute(1, 2, 0)[rows[:, :, None], cols[:, None, :]]
                x = x - win.permute(0, 3, 1, 2)
        if scale != 1.0:
            x = x * scale
        flips = batch["flip"].to(x.device).to(torch.bool)
        x = torch.where(flips.reshape(n, 1, 1, 1), x.flip(-1), x)
        new = {k: v for k, v in batch.items()
               if k not in ("h_off", "w_off", "flip")}
        new[data_key] = x
        return new

    return fn


def from_transform_param(
    tp,
    mean: Optional[np.ndarray] = None,
    phase: str = "TRAIN",
    data_key: str = "data",
):
    """The phase's transform closure from a layer's
    ``TransformationParameter``, the mean resolved as ``DataTransformer``
    does (mean_file, else mean_value as a ``(C, 1, 1)`` mean;
    data_transformer.cpp:19-47).  None when the config is the identity.
    TRAIN: ``(batch, key) -> batch``; TEST: ``(batch) -> batch``.
    Without a crop only the mean, the scale and (TRAIN) a per-image
    mirror drawn from the key apply."""
    if mean is None:
        if tp.mean_file:
            from sparknet_tpu_torch.io.caffemodel import load_mean_image

            mean = load_mean_image(tp.mean_file)
        elif tp.mean_value:
            mean = np.asarray(tp.mean_value, np.float32)[:, None, None]
    crop = int(tp.crop_size)
    if crop <= 0 and mean is None and tp.scale == 1.0 and not tp.mirror:
        return None
    if crop > 0:
        if phase == "TRAIN":
            return train_transform(mean, crop, mirror=tp.mirror,
                                   scale=tp.scale, data_key=data_key)
        return test_transform(mean, crop, scale=tp.scale, data_key=data_key)
    mean_on = _placed_mean(mean)

    def finish(batch: Batch):
        x = batch[data_key].to(torch.float32)
        m = mean_on(x.device)
        if m is not None:
            x = x - m
        if tp.scale != 1.0:
            x = x * tp.scale
        return x

    def no_crop_train(batch: Batch, rng: int) -> Batch:
        x = finish(batch)
        if tp.mirror:
            gen = rngs.generator(rng)
            flip = (torch.rand((x.shape[0],), generator=gen) < 0.5).to(x.device)
            x = torch.where(flip.reshape((-1,) + (1,) * (x.dim() - 1)),
                            x.flip(-1), x)
        new = dict(batch)
        new[data_key] = x
        return new

    def no_crop_test(batch: Batch) -> Batch:
        new = dict(batch)
        new[data_key] = finish(batch)
        return new

    return no_crop_train if phase == "TRAIN" else no_crop_test
