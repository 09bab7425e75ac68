"""Serving of the port: image inference and LM generation over HTTP.

- ``engine.InferenceEngine`` — a deploy net at fixed batch buckets, its
  weights on the card; ``batcher.MicroBatcher`` coalesces concurrent
  ``/predict`` requests into them.
- ``generate.GenerationEngine`` / ``kv_cache.KVBlockPool`` — greedy LM
  decode over a paged KV arena; ``batcher.StreamBatcher`` batches the
  streams continuously.
- ``fleet.ReplicaPool`` / ``fleet.Router`` — N shared-nothing replicas
  behind a load-shedding router (eject and retry, hot swap, canary
  mirroring).
- ``publish`` / ``delivery`` — train-to-serve delivery: a verdict-gated
  CRC-manifested publish, and a watcher that verifies, warms a standby,
  canaries live traffic and promotes or rolls back.
- ``server.ServeServer`` — the stdlib HTTP front end (``/predict`` or
  ``/generate``, ``/healthz``, ``/metrics``; 429 shedding, SIGTERM drain).
"""

from sparknet_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from sparknet_tpu_torch.serve.batcher import (
    GenStream,
    MicroBatcher,
    QueueFull,
    StreamBatcher,
)
from sparknet_tpu_torch.serve.delivery import DeliveryController
from sparknet_tpu_torch.serve.engine import InferenceEngine
from sparknet_tpu_torch.serve.fleet import (
    FleetUnservable,
    Replica,
    ReplicaPool,
    Router,
)
from sparknet_tpu_torch.serve.generate import GenerationEngine
from sparknet_tpu_torch.serve.kv_cache import KVBlockPool, KVBudgetExceeded
from sparknet_tpu_torch.serve.publish import PublishRefused, publish_snapshot
from sparknet_tpu_torch.serve.server import ServeServer

__all__ = [
    "Counter",
    "DeliveryController",
    "FleetUnservable",
    "Gauge",
    "GenStream",
    "GenerationEngine",
    "Histogram",
    "InferenceEngine",
    "KVBlockPool",
    "KVBudgetExceeded",
    "MetricsRegistry",
    "MicroBatcher",
    "PublishRefused",
    "QueueFull",
    "Replica",
    "ReplicaPool",
    "Router",
    "ServeServer",
    "StreamBatcher",
    "publish_snapshot",
]
