"""Binary I/O of the port: the mean image (``mean.binaryproto``).

The rest of the JAX package's ``io/`` (``.caffemodel`` weights,
checkpoints, the journal) is not yet ported."""

from sparknet_tpu_torch.io.caffemodel import load_mean_image, save_mean_image

__all__ = ["load_mean_image", "save_mean_image"]
