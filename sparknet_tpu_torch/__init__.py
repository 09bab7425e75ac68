"""sparknet_tpu_torch — the PyTorch and CUDA port of ``sparknet_tpu``.

The JAX package beside it is the reference: this package keeps its
module paths and names, holds each module against its counterpart in
``tests/test_torch_*.py``, and replaces each Pallas kernel on a ported
path with a CUDA kernel written by hand for Hopper (``ops/csrc/``).
It imports torch, numpy and the standard library only — never JAX and
never ``sparknet_tpu``.

Ported so far: LM serving (``cli serve --generate``, with the flash and
decode attention kernels of ``ops.cuda_attention``), SparkNet's
tau-averaging loop on cifar10_full (``apps.cifar_app``, with the comm
epilogue kernels of ``ops.cuda_comm``) and LM training
(``apps.lm_app``, with the flash backward kernels).

Float32 matrix products stay float32 on the card: TF32 is switched off
here, for products and for cuDNN, so the card computes what the CPU
reference computes up to summation order.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
