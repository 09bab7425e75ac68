"""Data-parallel training of the port: SparkNet's averaging trainer and
its comm plane, with the workers stacked on one device, and the
job-state helpers a resumed run puts back."""

from sparknet_tpu_torch.parallel.comm import LOSS_BAND, CommPlane
from sparknet_tpu_torch.parallel.trainers import (
    ParameterAveragingTrainer,
    export_worker_history,
    first_worker,
    restore_worker_history,
)

__all__ = ["CommPlane", "LOSS_BAND", "ParameterAveragingTrainer",
           "export_worker_history", "first_worker", "restore_worker_history"]
