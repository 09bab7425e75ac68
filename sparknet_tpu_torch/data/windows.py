"""R-CNN window sampling — the WindowData host pipeline.

The port's own copy of ``sparknet_tpu/data/windows.py`` (numpy and PIL
on the host; the same batches from the same seed).  Reference:
``caffe/src/caffe/layers/window_data_layer.cpp``, the fine-tuning data
source of the R-CNN detection workflow:

- window_file format (``:41-47``): repeated ``# idx / img_path /
  channels / height / width / num_windows`` then ``class overlap
  x1 y1 x2 y2`` rows;
- fg/bg partition by overlap threshold (fg: overlap >= fg_threshold;
  bg: overlap in [0, bg_threshold)), a batch of ``batch_size *
  fg_fraction`` foreground samples (label = class) and the rest
  background (label 0), each drawn uniformly from its pool;
- context padding + warp (``:305-384``): the window is expanded by
  ``crop_size / (crop_size - 2*context_pad)`` about its centre (squared
  first under ``crop_mode: "square"``), clipped to the image, the
  clipped part warped into its proportional sub-rectangle of the
  ``crop_size`` square, the out-of-image remainder left at 0;
- mirror flips the warped window and its padding offsets; mean_file /
  mean_value subtraction and ``scale`` as DataTransformer.

The decode goes through PIL (the reference uses OpenCV); the bilinear
resize keeps the warp semantics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from sparknet_tpu_torch.config.schema import WindowDataParameter


@dataclass
class WindowImage:
    path: str
    channels: int
    height: int
    width: int
    # rows: (class_index, overlap, x1, y1, x2, y2)
    windows: np.ndarray = field(default_factory=lambda: np.zeros((0, 6)))


def parse_window_file(path: str, root_folder: str = "") -> List[WindowImage]:
    """Parse the R-CNN window_file format (window_data_layer.cpp:41-47)."""
    images: List[WindowImage] = []
    with open(path) as f:
        lines = [l.strip() for l in f]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        if not lines[i].startswith("#"):
            raise ValueError(
                f"{path}:{i + 1}: expected '# image_index', got {lines[i]!r}"
            )
        img_path = lines[i + 1]
        if root_folder and not os.path.isabs(img_path):
            img_path = os.path.join(root_folder, img_path)
        channels, height, width, num_windows = (
            int(lines[i + 2]),
            int(lines[i + 3]),
            int(lines[i + 4]),
            int(lines[i + 5]),
        )
        rows = []
        for j in range(num_windows):
            vals = lines[i + 6 + j].split()
            rows.append(
                (
                    int(vals[0]),
                    float(vals[1]),
                    int(vals[2]),
                    int(vals[3]),
                    int(vals[4]),
                    int(vals[5]),
                )
            )
        images.append(
            WindowImage(
                img_path,
                channels,
                height,
                width,
                np.asarray(rows, np.float64).reshape(num_windows, 6),
            )
        )
        i += 6 + num_windows
    return images


def effective_window_params(lp):
    """(crop_size, mirror, scale, mean_file, mean_value) for a
    WindowData layer, preferring ``transform_param`` (where the
    reference's canonical prototxts put them; ``window_data_layer.cpp``
    reads ``transform_param_``) over the legacy WindowDataParameter
    copies."""
    wdp = lp.window_data_param
    tp = lp.transform_param
    crop = int(tp.crop_size) if tp and tp.crop_size else int(wdp.crop_size)
    mirror = bool(tp.mirror) if tp and tp.mirror else bool(wdp.mirror)
    scale = (
        float(tp.scale)
        if tp is not None and tp.scale != 1.0
        else float(wdp.scale)
    )
    mean_file = tp.mean_file if tp and tp.mean_file else wdp.mean_file
    mean_value = list(tp.mean_value) if tp and tp.mean_value else []
    return crop, mirror, scale, mean_file, mean_value


def read_window_file_header(path: str) -> Tuple[int, int, int]:
    """(channels, height, width) of the FIRST entry only — the cheap
    read shape inference needs (real R-CNN window files list millions of
    windows; parsing them all to learn the channel count is waste)."""
    with open(path) as f:
        lines = []
        for line in f:
            line = line.strip()
            if line:
                lines.append(line)
            if len(lines) >= 5:
                break
    if len(lines) < 5 or not lines[0].startswith("#"):
        raise ValueError(f"{path}: not a window file")
    return int(lines[2]), int(lines[3]), int(lines[4])


def _load_image(path: str, channels: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("L" if channels == 1 else "RGB")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr  # (H, W, C)


def _warp(region: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of an (h, w, C) uint8 region."""
    from PIL import Image

    if region.shape[2] == 1:
        im = Image.fromarray(region[:, :, 0])
    else:
        im = Image.fromarray(region)
    im = im.resize((max(1, out_w), max(1, out_h)), Image.BILINEAR)
    arr = np.asarray(im, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def crop_window(
    img: np.ndarray,
    x1, y1, x2, y2,
    crop: int,
    context_pad: int = 0,
    square: bool = False,
    do_mirror: bool = False,
):
    """Crop one window from an (H, W, C) image, with R-CNN context
    padding and warp-to-square (``window_data_layer.cpp:246-375``
    semantics, shared by training batches and the Detector driver).

    Returns ``(out, pad_h, pad_w, (warped_h, warped_w))`` where ``out``
    is (crop, crop, C) float32 with zero padding outside the warped
    content region."""
    pad = int(context_pad)
    h_img, w_img = img.shape[:2]
    pad_w = pad_h = 0
    out_h = out_w = crop
    if pad > 0 or square:
        context_scale = crop / float(crop - 2 * pad)
        half_h = (y2 - y1 + 1) / 2.0
        half_w = (x2 - x1 + 1) / 2.0
        cx, cy = x1 + half_w, y1 + half_h
        if square:
            half_h = half_w = max(half_h, half_w)
        x1 = int(round(cx - half_w * context_scale))
        x2 = int(round(cx + half_w * context_scale))
        y1 = int(round(cy - half_h * context_scale))
        y2 = int(round(cy + half_h * context_scale))
        un_h, un_w = y2 - y1 + 1, x2 - x1 + 1
        pad_x1, pad_y1 = max(0, -x1), max(0, -y1)
        pad_x2 = max(0, x2 - w_img + 1)
        pad_y2 = max(0, y2 - h_img + 1)
        x1, x2 = x1 + pad_x1, x2 - pad_x2
        y1, y2 = y1 + pad_y1, y2 - pad_y2
        scale_x, scale_y = crop / float(un_w), crop / float(un_h)
        out_w = int(round((x2 - x1 + 1) * scale_x))
        out_h = int(round((y2 - y1 + 1) * scale_y))
        pad_h = int(round(pad_y1 * scale_y))
        # mirrored windows mirror their padding too (:370-375)
        pad_w = int(round((pad_x2 if do_mirror else pad_x1) * scale_x))
        out_h = min(out_h, crop - pad_h)
        out_w = min(out_w, crop - pad_w)
    region = img[int(y1):int(y2) + 1, int(x1):int(x2) + 1]
    warped = _warp(region, out_h, out_w)
    if do_mirror:
        warped = warped[:, ::-1]
    out = np.zeros((crop, crop, img.shape[2]), np.float32)
    out[pad_h:pad_h + warped.shape[0], pad_w:pad_w + warped.shape[1]] = (
        warped
    )
    return out, pad_h, pad_w, warped.shape[:2]


class WindowSampler:
    """Batch sampler with the reference's fg/bg composition and
    context-pad warp; emits (data (B, C, crop, crop) f32, label (B,))."""

    def __init__(
        self,
        param: WindowDataParameter,
        mean: Optional[np.ndarray] = None,
        phase: str = "TRAIN",
        seed: int = 0,
        crop_size: Optional[int] = None,
        mirror: Optional[bool] = None,
        scale: Optional[float] = None,
    ):
        # crop/mirror/scale may come from the layer's transform_param
        # (where the reference's canonical prototxts put them —
        # window_data_layer.cpp reads this->transform_param_; the
        # WindowDataParameter copies are the legacy location)
        self.p = param
        self.crop = int(crop_size if crop_size is not None else param.crop_size)
        self.mirror = bool(mirror if mirror is not None else param.mirror)
        self.scale = float(scale if scale is not None else param.scale)
        if self.crop <= 0:
            raise ValueError(
                "WindowData needs a positive crop_size (set it in "
                "transform_param or window_data_param)"
            )
        self.phase = phase.upper()
        self.rng = np.random.RandomState(seed)
        self.images = parse_window_file(param.source, param.root_folder)
        self.mean = mean  # (C,) mean values or (C, H, W) mean image
        fg, bg = [], []
        for idx, im in enumerate(self.images):
            for w in im.windows:
                entry = (idx,) + tuple(w)
                if w[1] >= param.fg_threshold:
                    fg.append(entry)
                elif w[1] < param.bg_threshold and w[1] >= 0:
                    bg.append(entry)
        if not fg or not bg:
            raise ValueError(
                f"window file {param.source}: need both foreground "
                f"({len(fg)}) and background ({len(bg)}) windows"
            )
        self.fg = fg
        self.bg = bg
        self._cache = {}

    def _image(self, idx: int) -> np.ndarray:
        im = self.images[idx]
        if not self.p.cache_images:
            return _load_image(im.path, im.channels)
        if idx not in self._cache:
            self._cache[idx] = _load_image(im.path, im.channels)
        return self._cache[idx]

    def _crop_window(self, img: np.ndarray, x1, y1, x2, y2, do_mirror):
        return crop_window(
            img, x1, y1, x2, y2, self.crop,
            context_pad=int(self.p.context_pad),
            square=self.p.crop_mode == "square",
            do_mirror=do_mirror,
        )

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        p = self.p
        batch, crop = int(p.batch_size), self.crop
        num_fg = int(batch * p.fg_fraction)
        channels = self.images[0].channels
        data = np.zeros((batch, channels, crop, crop), np.float32)
        labels = np.zeros(batch, np.float32)
        item = 0
        for is_fg, count in ((False, batch - num_fg), (True, num_fg)):
            pool = self.fg if is_fg else self.bg
            for _ in range(count):
                idx, cls, _ov, x1, y1, x2, y2 = pool[
                    self.rng.randint(len(pool))
                ]
                do_mirror = self.mirror and (
                    self.phase == "TRAIN" and self.rng.randint(2) == 1
                )
                img = self._image(int(idx))
                out, pad_h, pad_w, (wh, ww) = self._crop_window(
                    img, x1, y1, x2, y2, do_mirror
                )
                chw = out.transpose(2, 0, 1)
                if self.mean is not None:
                    mean = np.asarray(self.mean, np.float32)
                    if mean.ndim == 1:  # mean_value per channel
                        sub = chw - mean[:, None, None]
                    else:  # mean image: center-crop window + pad offsets
                        off = (mean.shape[1] - crop) // 2
                        sub = chw - mean[
                            :, off:off + crop, off:off + crop
                        ]
                    # padding stays zero-signal like the reference's
                    # zeroed batch buffer
                    m = np.zeros((crop, crop), bool)
                    m[pad_h:pad_h + wh, pad_w:pad_w + ww] = True
                    chw = np.where(m[None], sub, 0.0)
                data[item] = chw * self.scale
                labels[item] = float(cls) if is_fg else 0.0
                item += 1
        return data, labels
