"""Host data pipeline of the port: the CIFAR and ImageNet loaders, the
mean image, the minibatch and R-CNN window samplers, the text data
plane, the object stores and the chunk cache, the cross-epoch shuffle,
the prefetcher and the pipelined round feed, the host DataTransformer
and the device-side transforms (own copies of ``sparknet_tpu/data``'s)."""

from sparknet_tpu_torch.data import shuffle, transforms
from sparknet_tpu_torch.data.cifar import CifarLoader
from sparknet_tpu_torch.data.imagenet import (
    ImageNetLoader,
    ScaleAndConvert,
    compute_mean,
    reduce_mean_sums,
    write_synthetic_imagenet,
)
from sparknet_tpu_torch.data.prefetch import (
    Prefetcher,
    PrefetchStall,
    device_prefetch,
)
from sparknet_tpu_torch.data.round_feed import RoundFeed, stack_windows
from sparknet_tpu_torch.data.sampler import MinibatchSampler
from sparknet_tpu_torch.data.text import (
    ByteTokenizer,
    TextWindowSampler,
    load_corpus,
    write_synthetic_corpus,
)

__all__ = [
    "ByteTokenizer", "CifarLoader", "ImageNetLoader", "MinibatchSampler",
    "PrefetchStall", "Prefetcher", "RoundFeed", "ScaleAndConvert",
    "TextWindowSampler", "compute_mean", "device_prefetch", "load_corpus",
    "reduce_mean_sums", "shuffle", "stack_windows", "transforms",
    "write_synthetic_corpus", "write_synthetic_imagenet",
]
