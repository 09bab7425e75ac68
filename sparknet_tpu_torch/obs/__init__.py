"""Observability of the port: metrics, spans and request tracing.

Own copies of the parts of ``sparknet_tpu/obs/`` that the serving slice
uses; the training telemetry (health sentry, round profiler, fleet
shipper) comes with the training slices.  ``obs.span`` and
``obs.instant`` are ``obs/trace.py``'s, re-exported as the JAX
package's ``obs`` does: the data plane, publish and delivery call them.
"""

from sparknet_tpu_torch.obs.trace import instant, span  # noqa: F401
