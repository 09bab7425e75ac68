"""Alias of :mod:`sparknet_tpu_torch.obs.metrics` (the JAX package's
``serve.metrics`` shim): the serving instruments live in the shared
observability layer, and this name keeps them importable from here."""

from sparknet_tpu_torch.obs.metrics import *  # noqa: F401,F403
