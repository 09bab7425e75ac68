"""InferenceEngine: a deploy net served at a fixed set of batch buckets.

The port of ``sparknet_tpu/serve/engine.py``: the net is taken to its
deploy view (``models.deploy_variant``) when handed a train/test config,
weights load from a ``.caffemodel`` / ``.caffemodel.h5`` (BVLC or
snapshot output — ``io/checkpoint.py`` writes the same format) and live
on the engine's device for its life, and ``warmup()`` runs the forward
once at every bucket batch size.  Bucket shapes are static (the
pad-and-mask idiom of ``apps/imagenet_app.py``): a batch of n requests
runs at the smallest bucket >= n, rows beyond n are zero pad whose
outputs the caller slices away.

PyTorch keeps no jit cache, so the engine counts the distinct input
shapes that reached the forward (``jit_cache_size()``): ``len(buckets)``
after ``warmup()`` and ever after, under any traffic — the serving
no-new-shape invariant ``/metrics`` reports.  A forward makes one copy
of the padded batch to the device and one copy of the output back.

On the card the forward runs cuDNN's convolutions and pooling, cuBLAS's
products and the port's LRN kernel (K5, ``ops/cuda_lrn.py``) in float32
or, with ``compute_dtype="bfloat16"``, in bf16 (parameters stay float32
master copies; ``net.TorchNet``).  The engine runs on ``cuda`` unless
``device="cpu"`` is asked for.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparknet_tpu_torch.utils.devices import resolve_device

DEFAULT_BUCKETS = (1, 4, 16, 64)


def _host(out: torch.Tensor) -> np.ndarray:
    """A CPU output tensor as numpy; bfloat16 (which numpy lacks) as the
    float32 array of the same values."""
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.numpy()


class InferenceEngine:
    """Loads a deploy net and serves forward passes at fixed batch-size
    buckets.

    Parameters
    ----------
    net_param:
        NetParameter (deploy or train/test — the TEST view is derived),
        or a zoo model name.
    weights:
        Optional ``.caffemodel`` / ``.caffemodel.h5`` path.
    buckets:
        Ascending batch-size buckets; requests larger than the top
        bucket are chunked (``infer`` handles that transparently).
    output_blob:
        Blob to serve; defaults to ``"prob"`` when the net names one
        (the BVLC deploy convention), else the last layer's first top.
    compute_dtype:
        e.g. ``"bfloat16"``; None keeps reference float32 numerics
        (equal to ``TorchNet.forward``).
    seed:
        The init's seed (the JAX package's weights for the same seed);
        loaded weights replace it by layer name.
    device:
        ``None`` is ``cuda`` (raises without a CUDA device); ``"cpu"``
        runs the plain kernel versions on the CPU.
    """

    def __init__(
        self,
        net_param,
        weights: Optional[str] = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        output_blob: Optional[str] = None,
        compute_dtype: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        from sparknet_tpu_torch import models
        from sparknet_tpu_torch.net import TorchNet

        self.device = resolve_device(device)
        if isinstance(net_param, str):
            net_param = models.load_model(net_param)
        if self._config_feed_count(net_param) > 1:
            # train/test config (data + label feeds): take the deploy
            # view (Input data, losses -> prob) as cmd_classify does
            net_param = models.deploy_variant(net_param)
        net = TorchNet(net_param, phase="TEST", compute_dtype=compute_dtype)
        self.net = net
        self.net_param = net_param
        self.data_blob = net.feed_blobs[0]
        # per-item shape: the bucket batch dim replaces the config's
        self.item_shape: Tuple[int, ...] = tuple(
            net.blob_shapes[self.data_blob][1:]
        )
        self.buckets: List[int] = sorted({int(b) for b in buckets})
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {buckets}")

        params, stats = net.init(seed, self.device)
        if weights:
            from sparknet_tpu_torch.io import caffemodel, checkpoint

            loaded = checkpoint._load_model_blobs(weights)
            params, stats = caffemodel.apply_blobs(net, params, stats, loaded)
        # the weights stay on the device for the life of the engine
        self.params = params
        self.stats = stats

        if output_blob is not None and output_blob not in net.blob_shapes:
            raise ValueError(
                f"output blob {output_blob!r} not produced by the net; "
                f"have {sorted(net.blob_shapes)}"
            )
        self.output_blob = output_blob or (
            "prob"
            if "prob" in net.blob_shapes
            else net_param.layer[-1].top[0]
        )
        # input shapes that reached the forward (the jit-cache analog)
        self._shapes = set()
        # serialize forwards: concurrent callers (batcher worker + direct
        # infer) never interleave device work on one engine
        self._lock = threading.Lock()

    @staticmethod
    def _config_feed_count(net_param) -> int:
        """Host-fed blob count of the TEST view, straight from the
        config — no throwaway net build."""
        from sparknet_tpu_torch import net as _net  # noqa: F401 (registers layers)
        from sparknet_tpu_torch.config.schema import NetState
        from sparknet_tpu_torch.graph import filter_net
        from sparknet_tpu_torch.ops.base import LAYER_REGISTRY
        from sparknet_tpu_torch.ops.data_layers import _HostFed

        filtered = filter_net(net_param, NetState(phase="TEST"))
        feeds = list(filtered.input)
        for lp in filtered.layer:
            cls = LAYER_REGISTRY.get(lp.type)
            if cls is not None and issubclass(cls, _HostFed):
                feeds.extend(lp.top)
        return len(set(feeds))

    # ------------------------------------------------------------------
    # Warm-up
    # ------------------------------------------------------------------
    def warmup(self) -> int:
        """Run the forward at every bucket size (on the card this also
        builds the LRN kernel and settles cuDNN's choices); returns
        ``jit_cache_size()`` (== len(buckets))."""
        for b in self.buckets:
            self.run_padded(np.zeros((b,) + self.item_shape, np.float32))
        return self.jit_cache_size()

    def jit_cache_size(self) -> int:
        """Distinct input shapes the forward has run — stable after
        ``warmup()`` iff no new shape ran (the serving no-recompile
        invariant; tests and /metrics read this)."""
        return len(self._shapes)

    # ------------------------------------------------------------------
    # Bucketing
    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, or the max bucket when n exceeds it
        (caller chunks)."""
        if n < 1:
            raise ValueError(f"need at least one item, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def pad_to_bucket(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        """(x padded with zero rows to the selected bucket, n_real)."""
        n = x.shape[0]
        b = self.bucket_for(n)
        if n == b:
            return x, n
        pad = np.zeros((b - n,) + tuple(x.shape[1:]), x.dtype)
        return np.concatenate([x, pad], axis=0), n

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def run_padded(self, x: np.ndarray) -> np.ndarray:
        """Forward one already-bucket-shaped batch; returns the full
        (bucket-sized) output — callers slice off pad rows."""
        if x.shape[0] not in self.buckets:
            raise ValueError(
                f"batch dim {x.shape[0]} is not a bucket {self.buckets}"
            )
        if tuple(x.shape[1:]) != self.item_shape:
            raise ValueError(
                f"item shape {tuple(x.shape[1:])} != net input "
                f"{self.item_shape}"
            )
        x = np.ascontiguousarray(x, np.float32)
        # inference mode is thread-local: entered here, on the calling
        # thread (the batcher's worker or a direct caller)
        with self._lock, torch.inference_mode():
            self._shapes.add(tuple(x.shape))
            xd = torch.from_numpy(x).to(self.device)  # the one H2D copy
            out = self.net.forward(
                self.params, self.stats, {self.data_blob: xd}
            )[self.output_blob]
            # sparknet: sync-ok(serving D2H: the response rows ARE the product, the one D2H copy)
            out = out.cpu()
        return _host(out)

    def infer(self, x: np.ndarray) -> np.ndarray:
        """Single-shot inference for n items (any n >= 1): chunks by the
        max bucket, pads the tail, returns exactly n output rows."""
        # sparknet: sync-ok(host request payload coerced once at the API edge)
        x = np.asarray(x, np.float32)
        if x.ndim == len(self.item_shape):  # single item without batch dim
            x = x[None]
        outs = []
        for i in range(0, x.shape[0], self.max_bucket):
            chunk = x[i : i + self.max_bucket]
            padded, n = self.pad_to_bucket(chunk)
            outs.append(self.run_padded(padded)[:n])
        return np.concatenate(outs, axis=0)
