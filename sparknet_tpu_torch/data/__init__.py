"""Host data pipeline of the port: the CIFAR loader, the window sampler
and the pipelined round feed (own copies of ``sparknet_tpu/data``'s)."""

from sparknet_tpu_torch.data.cifar import CifarLoader
from sparknet_tpu_torch.data.round_feed import RoundFeed, stack_windows
from sparknet_tpu_torch.data.sampler import MinibatchSampler

__all__ = ["CifarLoader", "MinibatchSampler", "RoundFeed", "stack_windows"]
