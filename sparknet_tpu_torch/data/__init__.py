"""Host data pipeline of the port: the CIFAR and ImageNet loaders, the
mean image, the window sampler, the text data plane, the pipelined
round feed and the device-side transforms (own copies of
``sparknet_tpu/data``'s)."""

from sparknet_tpu_torch.data import transforms
from sparknet_tpu_torch.data.cifar import CifarLoader
from sparknet_tpu_torch.data.imagenet import (
    ImageNetLoader,
    ScaleAndConvert,
    compute_mean,
    reduce_mean_sums,
    write_synthetic_imagenet,
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
    "RoundFeed", "ScaleAndConvert", "TextWindowSampler", "compute_mean",
    "load_corpus", "reduce_mean_sums", "stack_windows", "transforms",
    "write_synthetic_corpus", "write_synthetic_imagenet",
]
