"""sparknet_tpu_torch — the PyTorch and CUDA port of ``sparknet_tpu``.

The JAX package beside it is the reference: this package keeps its
module paths and names, holds each module against its counterpart in
``tests/test_torch_*.py``, and replaces each Pallas kernel on a ported
path with a CUDA kernel written by hand for Hopper (``ops/csrc/``).
It imports torch, numpy and the standard library only — never JAX and
never ``sparknet_tpu``.

This slice serves ``cli serve --generate``: ``models.transformer_lm``,
``serve.generate`` over the paged KV arena, continuous batching and the
chunked-NDJSON HTTP front end, with the flash-prefill and decode
attention kernels of ``ops.cuda_attention``.

Float32 matrix products stay float32 on the card: TF32 is switched off
here, for products and for cuDNN, so the card computes what the CPU
reference computes up to summation order.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
