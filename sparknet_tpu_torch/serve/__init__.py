"""LM serving of the port: engine, paged KV cache, batcher, HTTP server."""

from sparknet_tpu_torch.serve.batcher import GenStream, QueueFull, StreamBatcher
from sparknet_tpu_torch.serve.generate import GenerationEngine
from sparknet_tpu_torch.serve.kv_cache import KVBlockPool, KVBudgetExceeded
from sparknet_tpu_torch.serve.server import ServeServer

__all__ = [
    "GenStream",
    "GenerationEngine",
    "KVBlockPool",
    "KVBudgetExceeded",
    "QueueFull",
    "ServeServer",
    "StreamBatcher",
]
