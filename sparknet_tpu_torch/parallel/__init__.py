"""Data-parallel training of the port: SparkNet's averaging trainer and
its comm plane, Caffe's gradient all-reduce trainer on the global batch (workers stacked on a device, over one process or
several joined through ``torch.distributed``), the process mesh, the
sequence-parallel ring, the two-tier ``HierarchySpec``, and the
job-state helpers a resumed run puts back."""

from sparknet_tpu_torch.parallel.comm import LOSS_BAND, CommPlane
from sparknet_tpu_torch.parallel.hierarchy import HierarchySpec
from sparknet_tpu_torch.parallel.mesh import (
    initialize_distributed,
    local_device_count,
    local_worker_slice,
    make_mesh,
    process_count,
    process_index,
)
from sparknet_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_self_attention,
)
from sparknet_tpu_torch.parallel.trainers import (
    AllReduceTrainer,
    ParameterAveragingTrainer,
    export_worker_history,
    first_worker,
    restore_worker_history,
)

__all__ = ["AllReduceTrainer", "CommPlane", "HierarchySpec", "LOSS_BAND",
           "ParameterAveragingTrainer", "export_worker_history",
           "first_worker", "initialize_distributed", "local_device_count",
           "local_worker_slice", "make_mesh", "process_count",
           "process_index", "restore_worker_history", "ring_attention",
           "ring_self_attention"]
