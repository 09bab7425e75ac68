"""Counters, gauges and histograms, rendered as Prometheus text.

The port's own copy of ``sparknet_tpu/obs/metrics.py``, cut to what
the serving slice registers and renders, plus ``TrainingMetrics``: the
training series of the averaging trainer.  Stdlib only: each metric is
a small lock-guarded accumulator, and ``MetricsRegistry.render()``
emits the Prometheus text exposition format (``# HELP``/``# TYPE`` +
samples).  Histograms keep cumulative buckets (the ``le`` convention)
plus a bounded reservoir of recent observations for p50/p95/p99.

Labels: ``registry.counter(name, labels=("cause",))`` returns a
family; ``family.labels("kv_reserve")`` returns the child for that
label value (created once, cached).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# default latency buckets (seconds): 1 ms .. 30 s, roughly log-spaced
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers print bare, floats as repr."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _sample_name(name: str, labelstr: str) -> str:
    return f"{name}{{{labelstr}}}" if labelstr else name


class Counter:
    """Monotonic counter (``requests_total`` style)."""

    TYPE = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.labelstr = ""  # e.g. 'cause="kv_reserve"' for family children
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(_sample_name(self.name, self.labelstr), self.value)]


class Gauge:
    """Set-to-current-value metric; ``fn`` makes it a callback gauge
    sampled at render time."""

    TYPE = "gauge"

    def __init__(self, name: str, help: str = "", fn=None):
        self.name, self.help = name, help
        self.labelstr = ""
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(_sample_name(self.name, self.labelstr), self.value)]


class Histogram:
    """Cumulative-bucket histogram + a ring of the last ``reservoir``
    observations for quantiles (steady-state p99, not all-time)."""

    TYPE = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
        reservoir: int = 4096,
    ):
        self.name, self.help = name, help
        self.labelstr = ""
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        self._ring: List[float] = []
        self._ring_cap = int(reservoir)
        self._ring_pos = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = len(self.buckets)
            for j, le in enumerate(self.buckets):
                if v <= le:
                    i = j
                    break
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if len(self._ring) < self._ring_cap:
                self._ring.append(v)
            else:
                self._ring[self._ring_pos] = v
                self._ring_pos = (self._ring_pos + 1) % self._ring_cap

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """q in [0, 1], nearest rank over the reservoir (0.0 empty)."""
        with self._lock:
            window = sorted(self._ring)
        if not window:
            return 0.0
        return window[min(len(window) - 1, max(0, int(q * len(window))))]

    def samples(self) -> List[Tuple[str, float]]:
        with self._lock:
            counts, total, s = list(self._counts), self._count, self._sum
        pre = f"{self.labelstr}," if self.labelstr else ""
        out: List[Tuple[str, float]] = []
        cum = 0
        for le, c in zip(self.buckets, counts):
            cum += c
            out.append((f'{self.name}_bucket{{{pre}le="{_fmt(le)}"}}', cum))
        out.append((f'{self.name}_bucket{{{pre}le="+Inf"}}', total))
        out.append((_sample_name(f"{self.name}_sum", self.labelstr), s))
        out.append((_sample_name(f"{self.name}_count", self.labelstr), total))
        return out


class MetricFamily:
    """A labeled family of one instrument class: ``labels(v1, ...)``
    returns the child for that label-value tuple (created on first use,
    cached), rendered under ONE ``# TYPE`` block."""

    def __init__(self, cls, name: str, help: str,
                 label_names: Sequence[str], **kwargs):
        if not label_names:
            raise ValueError("a MetricFamily needs at least one label name")
        self._cls = cls
        self.TYPE = cls.TYPE
        self.name, self.help = name, help
        self._label_names = tuple(label_names)
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values):
        key = tuple(str(v) for v in values)
        if len(key) != len(self._label_names):
            raise ValueError(
                f"{self.name}: expected labels {self._label_names}, "
                f"got {len(key)} value(s)"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._cls(self.name, self.help, **self._kwargs)
                child.labelstr = ",".join(
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(self._label_names, key)
                )
                self._children[key] = child
        return child

    def samples(self) -> List[Tuple[str, float]]:
        with self._lock:
            children = list(self._children.values())
        out: List[Tuple[str, float]] = []
        for child in children:
            out.extend(child.samples())
        return out


class MetricsRegistry:
    """Holds a process's metrics and renders the /metrics payload."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def register(self, metric):
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name!r}")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labels: Optional[Sequence[str]] = None):
        if labels:
            return self.register(MetricFamily(Counter, name, help, labels))
        return self.register(Counter(name, help))

    def gauge(self, name: str, help: str = "", fn=None,
              labels: Optional[Sequence[str]] = None):
        if labels:
            if fn is not None:
                # one callback cannot tell children apart
                raise ValueError(
                    f"{name}: callback gauges cannot be labeled — "
                    "use set() on labels(...) children instead"
                )
            return self.register(MetricFamily(Gauge, name, help, labels))
        return self.register(Gauge(name, help, fn=fn))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  labels: Optional[Sequence[str]] = None):
        if labels:
            return self.register(
                MetricFamily(Histogram, name, help, labels, buckets=buckets)
            )
        return self.register(Histogram(name, help, buckets=buckets))

    def render(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            for sample_name, value in m.samples():
                lines.append(f"{sample_name} {_fmt(value)}")
        return "\n".join(lines) + "\n"


class TrainingMetrics:
    """The training series of the averaging trainer and its comm plane,
    under the JAX package's names (``sparknet_tpu/obs/__init__.py``),
    registered on ``registry`` (a fresh one by default).  The trainer
    and the comm plane record into the object they are handed; there is
    no process-wide instance."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self.rounds = r.counter(
            "sparknet_rounds_total",
            "training rounds completed (rate() gives rounds/s)",
        )
        self.iters = r.counter(
            "sparknet_iters_total", "solver iterations completed"
        )
        self.collective_bytes = r.counter(
            "sparknet_collective_bytes_total",
            "modeled interconnect payload bytes moved by the parameter-"
            "averaging collective (ring factor x compressed payload), "
            "by compression mode",
            labels=("compress",),
        )
        self.kernel_fused_chunks = r.counter(
            "sparknet_kernel_fused_chunks_total",
            "averaging-epilogue kernel launches by the comm plane (one per "
            "comm chunk per stage per round; stage=encode|apply — "
            "ops/cuda_comm.py)",
            labels=("stage",),
        )
        self.quant_error = r.gauge(
            "sparknet_quant_error_max_abs",
            "last round's max |delta - dequant(delta)| quantization error "
            "of the compressed averaging, by compression mode",
            labels=("compress",),
        )
        self.kernel_path = r.gauge(
            "sparknet_kernel_path",
            "1 when the op runs the port's hand-written kernel on this "
            "run, 0 when it runs a plain PyTorch reference, by kernel "
            "family (kernel=attention: the LM's flash kernels)",
            labels=("kernel",),
        )
        self.lm_tokens = r.counter(
            "sparknet_lm_tokens_total",
            "tokens trained by the transformer-LM workload (workers x "
            "tau x batch x seq_len per round)",
        )
        self.quant_snr_db = r.gauge(
            "sparknet_quant_snr_db",
            "last round's delta-vs-quantization-error SNR in dB "
            "(10*log10(|delta|^2/|err|^2); 300 when the error is 0), by "
            "compression mode",
            labels=("compress",),
        )
