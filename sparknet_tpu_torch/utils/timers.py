"""Timers (reference: ``include/caffe/util/benchmark.hpp:10-46``).

The port of ``sparknet_tpu/utils/timers.py``.  ``CPUTimer`` is the wall
clock; ``Timer`` times the device the way the reference's cudaEvent
timer does: a CUDA event pair on the current stream of the caller's
device, ``stop()`` waiting for the end event.  On a CPU device it is the
wall clock.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


class CPUTimer:
    def __init__(self):
        self._start: Optional[float] = None
        self._elapsed = 0.0
        self.has_run_at_least_once = False

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self):
        if self._start is not None:
            self._elapsed = time.perf_counter() - self._start
            self.has_run_at_least_once = True
            self._start = None
        return self

    def milli_seconds(self) -> float:
        return self._elapsed * 1e3

    def micro_seconds(self) -> float:
        return self._elapsed * 1e6

    def seconds(self) -> float:
        return self._elapsed


class Timer(CPUTimer):
    """Device timer: CUDA events on ``device``'s current stream (the
    wall clock for a CPU device)."""

    def __init__(self, device=None):
        super().__init__()
        dev = torch.device(device) if device is not None else torch.device("cpu")
        self._cuda = dev.type == "cuda"
        self._device = dev
        self._ev0 = self._ev1 = None

    def start(self):
        if not self._cuda:
            return super().start()
        with torch.cuda.device(self._device):
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev1 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        return self

    def stop(self):
        if not self._cuda:
            return super().stop()
        if self._ev0 is not None:
            with torch.cuda.device(self._device):
                self._ev1.record()
            # sparknet: sync-ok(device-synchronized timer: the sync IS the contract, cudaEvent-style)
            self._ev1.synchronize()
            self._elapsed = self._ev0.elapsed_time(self._ev1) / 1e3
            self.has_run_at_least_once = True
            self._ev0 = None
        return self
