"""Timestamped phase log — the driver's experiment record.

The port's own copy of ``sparknet_tpu/utils/trainlog.py``.

Reference: ``CifarApp.scala:36-46`` writes elapsed-seconds structured lines
per phase per iteration to ``training_log_<timestamp>.txt``; that file is
the primary experiment record (SURVEY §5).  Format preserved.

Lifecycle: ``TrainingLog`` is a context manager with an idempotent
``close()`` (no leaked file handles; every line is flushed as written,
so a crash loses nothing).  Destination, most specific wins: an
explicit ``path``, else ``directory``, else ``$SPARKNET_LOG_DIR``, else
the CWD — tests and apps point logs at tmpdirs instead of littering the
repo root.

When a tracer is installed (``obs/trace.py``), every line is mirrored
as a structured instant event into its JSONL run log.
"""

from __future__ import annotations

import os
import time
from typing import Optional, TextIO

from sparknet_tpu_torch.obs import trace


class TrainingLog:
    def __init__(
        self,
        directory: Optional[str] = None,
        tag: str = "",
        echo: bool = True,
        path: Optional[str] = None,
    ):
        if path is None:
            directory = directory or os.environ.get(
                "SPARKNET_LOG_DIR", "."
            )
            os.makedirs(directory, exist_ok=True)
            ts = int(time.time() * 1000)
            suffix = f"_{tag}" if tag else ""
            path = os.path.join(
                directory, f"training_log_{ts}{suffix}.txt"
            )
        else:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self.path = path
        self._f: Optional[TextIO] = open(self.path, "a")
        self._t0 = time.time()
        self._echo = echo

    def elapsed(self) -> float:
        """Seconds since the log was opened."""
        return time.time() - self._t0

    def log(self, message: str, i: int = -1,
            elapsed: Optional[float] = None):
        """Reference line formats (ImageNetApp.scala:47-53): with a round
        index, ``<elapsed>, i = <i>: <message>``; else ``<elapsed>: <msg>``.
        ``elapsed`` stamps the line with that time instead of now: the
        lines of one test pass share one stamp, which is what makes
        ``parse_log`` merge them into one row."""
        if elapsed is None:
            elapsed = self.elapsed()
        if i >= 0:
            line = f"{elapsed:.3f}, i = {i}: {message}"
        else:
            line = f"{elapsed:.3f}: {message}"
        if self._f is None:
            raise ValueError(f"TrainingLog {self.path} is closed")
        self._f.write(line + "\n")
        self._f.flush()  # crash-durable per line
        # structured mirror: rides the JSONL run log when tracing is on
        trace.instant("log", cat="log", msg=message, i=i,
                    elapsed=round(elapsed, 3))
        if self._echo:
            print(line)

    def close(self):
        """Idempotent: safe to call from both a ``with`` exit and an
        explicit app ``finally``."""
        if self._f is not None:
            self._f.close()
            self._f = None

    @property
    def closed(self) -> bool:
        return self._f is None

    def __enter__(self) -> "TrainingLog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
