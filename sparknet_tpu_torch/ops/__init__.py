"""Operators of the port: the layer zoo (``base``, ``vision``, ``common``,
``losses``, ``data_layers``), plain attention, and the CUDA kernels
with their plain versions (``cuda_attention``, ``cuda_comm``,
``cuda_lrn``, ``cuda_plp``; sources in ``csrc/``)."""
