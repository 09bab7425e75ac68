"""Observability of the port: metrics, spans and request tracing.

Own copies of the parts of ``sparknet_tpu/obs/`` that the serving slice
uses; the training telemetry (health sentry, round profiler, fleet
shipper) comes with the training slices.
"""
