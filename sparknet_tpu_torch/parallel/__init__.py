"""Data-parallel training of the port: SparkNet's averaging trainer and
its comm plane, with the workers stacked on one device."""

from sparknet_tpu_torch.parallel.comm import LOSS_BAND, CommPlane
from sparknet_tpu_torch.parallel.trainers import ParameterAveragingTrainer

__all__ = ["CommPlane", "LOSS_BAND", "ParameterAveragingTrainer"]
