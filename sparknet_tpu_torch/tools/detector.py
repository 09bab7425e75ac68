"""Windowed detection driver — R-CNN-style per-window scoring.

The port's own copy of ``sparknet_tpu/tools/detector.py``.  Reference
role: ``caffe/python/caffe/detector.py:1-216`` (``Detector``): crop each
proposal window (with optional surrounding context), warp to the net
input size, and score every window with the classifier.  Differences
from the reference, by design:

- crops go through ``data/windows.crop_window`` — the same routine the
  WindowData *training* layer uses — so train and inference see identical
  context-padding/warp geometry (the reference maintains two copies:
  ``window_data_layer.cpp`` and ``detector.py crop``);
- windows are scored in fixed batches of ``batch`` under
  ``torch.inference_mode()`` on the detector's device (one host-to-device
  copy and one device-to-host copy a batch; the last batch zero-padded)
  instead of one variable-length ``forward_all`` dispatch;
- the selective-search MATLAB bridge is out of scope (proposals come from
  the caller), as is channel_swap (images load as RGB planes here, not
  OpenCV BGR).

Window coordinates follow the reference convention ``(ymin, xmin, ymax,
xmax)`` with max-exclusive bounds (the numpy slice semantics of
``detector.py crop``: ``im[ymin:ymax, xmin:xmax]``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from sparknet_tpu_torch.config.schema import NetParameter


class Detector:
    """Score proposal windows with a deploy net.

    Parameters
    ----------
    netp : NetParameter (a deploy/Input-fed config, or anything
        ``models.deploy_variant`` can reduce)
    weights : optional .caffemodel path
    mean : per-channel mean values (C,) or mean image (C, H, W)
    input_scale : multiplier applied after mean subtraction
        (``Transformer.set_input_scale`` analog)
    context_pad : context border in input-image pixels (R-CNN uses 16)
    crop_mode : "warp" or "square" (``det_crop_mode`` semantics)
    batch : windows scored per forward
    device : ``None`` is ``cuda`` (raises without a CUDA device);
        ``"cpu"`` runs the plain versions of the kernels on the CPU
    """

    def __init__(
        self,
        netp: NetParameter,
        weights: Optional[str] = None,
        mean: Optional[np.ndarray] = None,
        input_scale: Optional[float] = None,
        context_pad: int = 0,
        crop_mode: str = "warp",
        batch: int = 32,
        device=None,
    ):
        from sparknet_tpu_torch import models
        from sparknet_tpu_torch.io import caffemodel
        from sparknet_tpu_torch.net import TorchNet
        from sparknet_tpu_torch.utils.devices import resolve_device

        self.device = resolve_device(device)  # no card: raises first
        net = TorchNet(netp, phase="TEST")
        if len(net.feed_blobs) > 1:
            netp = models.deploy_variant(netp, batch=batch)
            net = TorchNet(netp, phase="TEST")
        self.net = net
        self.data_blob = net.feed_blobs[0]
        _, self.channels, self.crop_h, self.crop_w = net.blob_shapes[
            self.data_blob
        ]
        if self.crop_h != self.crop_w:
            raise ValueError(
                "windowed detection needs a square input "
                f"(net takes {self.crop_h}x{self.crop_w})"
            )
        self.params, self.stats = net.init(0, self.device)
        if weights:
            self.params, self.stats = caffemodel.apply_blobs(
                net, self.params, self.stats, caffemodel.load_weights(weights)
            )
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        if self.mean is not None and self.mean.ndim == 3 and (
            self.mean.shape[1] < self.crop_h
            or self.mean.shape[2] < self.crop_w
        ):
            raise ValueError(
                f"mean image {self.mean.shape[1]}x{self.mean.shape[2]} is "
                f"smaller than the net input {self.crop_h}x{self.crop_w}"
            )
        self.input_scale = input_scale
        self.context_pad = int(context_pad)
        self.crop_mode = crop_mode
        self.batch = int(batch)
        # "prob" if the deploy net names one (the BVLC convention), else
        # the last layer's top — same rule as `cli.py classify`
        self.out_blob = (
            "prob" if "prob" in net.blob_shapes
            else net.net_param.layer[-1].top[0]
        )

    # -- preprocessing ----------------------------------------------------

    def _preprocess(self, window_hwc: np.ndarray, content=None) -> np.ndarray:
        """Mean-subtract + scale one crop.  ``content`` is the
        (pad_h, pad_w, (warped_h, warped_w)) geometry from crop_window:
        the zero-padded border outside it is masked back to zero AFTER
        mean subtraction, so the net sees zero-signal padding exactly
        like WindowSampler training batches (the reference detector pads
        with the mean so the net likewise sees 0 post-subtraction,
        detector.py:96-108)."""
        chw = window_hwc.transpose(2, 0, 1).astype(np.float32)
        if self.mean is not None:
            if self.mean.ndim == 1:
                chw = chw - self.mean[:, None, None]
            else:
                off_h = (self.mean.shape[1] - self.crop_h) // 2
                off_w = (self.mean.shape[2] - self.crop_w) // 2
                chw = chw - self.mean[
                    :, off_h:off_h + self.crop_h, off_w:off_w + self.crop_w
                ]
            if content is not None:
                pad_h, pad_w, (wh, ww) = content
                mask = np.zeros(chw.shape[1:], bool)
                mask[pad_h:pad_h + wh, pad_w:pad_w + ww] = True
                chw = np.where(mask[None], chw, 0.0)
        if self.input_scale is not None:
            chw = chw * self.input_scale
        return chw

    def crop(self, im: np.ndarray, window: Sequence[float]):
        """Crop one (ymin, xmin, ymax, xmax) window (context-padded) —
        ``Detector.crop`` analog.  Returns ``(out_hwc, content)`` where
        ``content`` is the (pad_h, pad_w, warped_shape) geometry that
        _preprocess uses to keep padding at zero signal."""
        from sparknet_tpu_torch.data.windows import crop_window

        ymin, xmin, ymax, xmax = [float(v) for v in window]
        out, pad_h, pad_w, warped = crop_window(
            im, xmin, ymin, xmax - 1, ymax - 1, self.crop_h,
            context_pad=self.context_pad,
            square=self.crop_mode == "square",
        )
        return out, (pad_h, pad_w, warped)

    # -- scoring ----------------------------------------------------------

    def _score(self, inputs: List[np.ndarray]) -> np.ndarray:
        import torch

        preds = []
        for i in range(0, len(inputs), self.batch):
            chunk = inputs[i:i + self.batch]
            n = len(chunk)
            buf = np.zeros(
                (self.batch, self.channels, self.crop_h, self.crop_w),
                np.float32,
            )
            buf[:n] = np.stack(chunk)
            # one copy to the device, one copy of the scores back
            with torch.inference_mode():
                data = torch.from_numpy(buf).to(self.device)
                out = self.net.forward(
                    self.params, self.stats, {self.data_blob: data}
                )[self.out_blob].cpu().numpy()
            preds.append(out.reshape(self.batch, -1)[:n])
        return np.concatenate(preds) if preds else np.zeros((0, 0))

    def detect_windows(
        self,
        images_windows: Iterable[
            Tuple[Union[str, np.ndarray], Sequence[Sequence[float]]]
        ],
    ) -> List[Dict]:
        """Score every (image, window-list) pair; returns dicts of
        ``{filename, window, prediction}`` in input order
        (``Detector.detect_windows`` contract)."""
        from sparknet_tpu_torch.data.windows import _load_image

        images_windows = list(images_windows)
        inputs, meta = [], []
        for src, windows in images_windows:
            if isinstance(src, str):
                im = _load_image(src, self.channels)
                name = src
            else:
                im = np.asarray(src)
                name = None
                if im.dtype != np.uint8:
                    # accept caffe.io.load_image-style float [0,1] images;
                    # anything else is ambiguous for the uint8 warp path
                    if np.issubdtype(im.dtype, np.floating) and (
                        im.min() >= 0.0 and im.max() <= 1.0
                    ):
                        im = (im * 255.0).round().astype(np.uint8)
                    else:
                        raise TypeError(
                            "detect_windows takes uint8 images or float "
                            f"images in [0, 1]; got {im.dtype} with range "
                            f"[{im.min()}, {im.max()}]"
                        )
            for window in windows:
                out, content = self.crop(im, window)
                inputs.append(self._preprocess(out, content))
                meta.append((name, np.asarray(window)))
        preds = self._score(inputs)
        return [
            {"filename": name, "window": win, "prediction": preds[i]}
            for i, (name, win) in enumerate(meta)
        ]
