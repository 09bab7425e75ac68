"""Host data pipeline of the port: the CIFAR loader, the window sampler,
the text data plane and the pipelined round feed (own copies of
``sparknet_tpu/data``'s)."""

from sparknet_tpu_torch.data.cifar import CifarLoader
from sparknet_tpu_torch.data.round_feed import RoundFeed, stack_windows
from sparknet_tpu_torch.data.sampler import MinibatchSampler
from sparknet_tpu_torch.data.text import (
    ByteTokenizer,
    TextWindowSampler,
    load_corpus,
    write_synthetic_corpus,
)

__all__ = [
    "ByteTokenizer", "CifarLoader", "MinibatchSampler", "RoundFeed",
    "TextWindowSampler", "load_corpus", "stack_windows",
    "write_synthetic_corpus",
]
