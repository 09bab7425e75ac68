"""Per-sample augmentation with the reference's exact semantics.

The port's own copy of ``sparknet_tpu/data/transformer.py`` (numpy on
the host; the same draws from the same seed).  Reference:
``caffe/src/caffe/data_transformer.cpp:19-132`` — scale, crop (random
in TRAIN, centre in TEST), mirror (TRAIN only), mean-file or per-channel
mean-value subtraction, with phase-dependent randomness.  ``ImageData``
batches go through it (``data/source.py``).

Naming note: this is Caffe's ``DataTransformer`` image augmenter, not
the transformer architecture (that is ``models/transformer_lm.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from sparknet_tpu_torch.config.schema import TransformationParameter


class DataTransformer:
    def __init__(
        self,
        param: Optional[TransformationParameter] = None,
        phase: str = "TRAIN",
        mean_image: Optional[np.ndarray] = None,
        seed: int = 0,
    ):
        self.param = param or TransformationParameter()
        self.phase = phase.upper()
        self.mean_image = mean_image
        if self.param.mean_file and mean_image is None:
            raise ValueError(
                "transform_param.mean_file set: pass the loaded mean_image"
            )
        if self.param.mean_value and mean_image is not None:
            raise ValueError("mean_file and mean_value are mutually exclusive")
        self._rng = np.random.RandomState(seed)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """Transform a (N, C, H, W) uint8/float batch -> float32 batch."""
        p = self.param
        x = images.astype(np.float32)
        n, c, h, w = x.shape
        # NOTE: the reference subtracts the mean indexed by the same crop
        # window (data_transformer.cpp mean[(c*H + h_off + h)*W ...]), so
        # when cropping we subtract per-sample inside the crop loop below.
        crop = p.crop_size
        if crop and (crop > h or crop > w):
            # reference hard-CHECKs crop_size <= height/width
            raise ValueError(
                f"crop_size {crop} exceeds input {h}x{w}"
            )
        if crop and (h > crop or w > crop):
            if self.phase == "TRAIN":
                h_offs = self._rng.randint(0, h - crop + 1, size=n)
                w_offs = self._rng.randint(0, w - crop + 1, size=n)
            else:
                h_offs = np.full(n, (h - crop) // 2)
                w_offs = np.full(n, (w - crop) // 2)
            out = np.empty((n, c, crop, crop), np.float32)
            for i in range(n):
                patch = x[i, :, h_offs[i] : h_offs[i] + crop, w_offs[i] : w_offs[i] + crop]
                if self.mean_image is not None:
                    patch = patch - self.mean_image[
                        :, h_offs[i] : h_offs[i] + crop, w_offs[i] : w_offs[i] + crop
                    ]
                out[i] = patch
            x = out
        elif self.mean_image is not None:
            x = x - self.mean_image[None]
        if p.mean_value:
            mv = np.asarray(p.mean_value, np.float32)
            if mv.size == 1:
                x = x - mv[0]
            else:
                x = x - mv.reshape(1, -1, 1, 1)
        if p.mirror and self.phase == "TRAIN":
            flips = self._rng.randint(0, 2, size=len(x)).astype(bool)
            x[flips] = x[flips, :, :, ::-1]
        if p.scale != 1.0:
            x = x * p.scale
        return x


def oversample_chw(chw: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    """10-crop oversampling of one (C, H, W) image: the four corners +
    center at the crop size, then their horizontal mirrors — the
    ``caffe.io.oversample`` crop set that ``Classifier.predict(...,
    oversample=True)`` score-averages (caffe/python/caffe/
    classifier.py:47-93, caffe/python/caffe/io.py oversample).
    Returns (10, C, crop_h, crop_w) in that order (corners+center,
    then mirrors)."""
    c, h, w = chw.shape
    if h < crop_h or w < crop_w:
        raise ValueError(
            f"oversample source {h}x{w} smaller than crop "
            f"{crop_h}x{crop_w}"
        )
    offs = [
        (0, 0),
        (0, w - crop_w),
        (h - crop_h, 0),
        (h - crop_h, w - crop_w),
        ((h - crop_h) // 2, (w - crop_w) // 2),
    ]
    crops = [
        chw[:, oy:oy + crop_h, ox:ox + crop_w] for oy, ox in offs
    ]
    crops += [cr[:, :, ::-1] for cr in crops]
    return np.stack(crops).astype(chw.dtype, copy=False)
