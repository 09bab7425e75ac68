"""The dynamic half of the hot-path gate: every sync the card reports,
held to an annotated site.

``torch.cuda.set_sync_debug_mode("warn")`` makes torch warn at each
synchronizing CUDA call it knows of (``.item()``, a D2H copy, a stream
synchronize, a pageable H2D copy, ``nonzero``); it fires only on a real
card, as the JAX package's transfer guard (``bench.py --mode=sanitize``)
fires on the device-to-host lane only on a real chip.  ``SyncRecorder``
arms it for a window and records the Python stack of every such warning,
on whatever thread it is raised (the RoundFeed producer and the comm
plane's thread warn on their own).  ``classify`` maps each recorded sync
to the innermost frame of the port on its stack and splits the sites
into those that lie on a call the lint lists as ``sync-ok`` and those
that do not: a steady round with any of the second kind has a sync
nobody annotated.

The debug mode does not see every sync: ``torch.cuda.synchronize`` and
``Event.synchronize`` wait on the card without its check.  So an armed
recorder also wraps those two for the window and records each call the
same way (``WAITS``).  Whatever else it misses stays unseen, so the
recorded set is held as a subset of the annotated sites, not as equal to
them.  ``chip_smoke.py`` phase 23 runs it over steady int8 rounds.
"""

from __future__ import annotations

import os
import threading
import traceback
import warnings
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

SYNC_WARNING = "called a synchronizing CUDA operation"
PACKAGE = "sparknet_tpu_torch"
# the host waits the debug mode does not report, wrapped while armed:
# (module or class path under torch, attribute)
WAITS = (("cuda", "synchronize"), ("cuda.Event", "synchronize"))
# a site: (repo-relative path, line, function or lint scope)
Site = Tuple[str, int, str]


def port_relpath(filename: str) -> Optional[str]:
    """``sparknet_tpu_torch/...`` for a file of the port (wherever the
    checkout lies), else None."""
    parts = os.path.normpath(filename).split(os.sep)
    if PACKAGE not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index(PACKAGE)
    return "/".join(parts[i:])


def innermost_port_frame(stack: Iterable[traceback.FrameSummary]
                         ) -> Optional[Site]:
    """The innermost frame of the port on ``stack`` (outermost first, as
    ``traceback.extract_stack`` gives it), this module's own excluded."""
    found = None
    for fr in stack:
        rel = port_relpath(fr.filename)
        if rel is not None and rel != f"{PACKAGE}/analysis/sanitize.py":
            found = (rel, fr.lineno, fr.name)
    return found


class SyncRecorder:
    """Arm the sync debug mode for a window and record each sync
    warning's stack (``events``: ``(thread name, stack)``), and each call
    of the wrapped waits (``waits``: ``(owner, attribute)`` pairs; the
    armed default ``WAITS``).  Other warnings go on to the previous
    ``showwarning``.  One locked hook serves every thread; the filter is
    ``always`` for the window, since the default shows a location once.
    ``arm=False`` records without touching the card (the synthetic
    warnings of the tests).  Arming raises where the mode cannot be set:
    there is no fallback."""

    def __init__(self, arm: bool = True, waits=None):
        self.arm = arm
        self.waits = waits
        self.events: List[Tuple[str, List[traceback.FrameSummary]]] = []
        self._lock = threading.Lock()
        self._ctx = None
        self._show = None
        self._wrapped: list = []

    def _record(self) -> None:
        stack = traceback.extract_stack()[:-2]  # the recorder's frames off
        while stack and os.path.basename(stack[-1].filename) == "warnings.py":
            stack.pop()  # the warnings machinery that called the hook
        with self._lock:
            self.events.append((threading.current_thread().name, stack))

    def _hook(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_WARNING not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        self._record()

    def _wrap(self, owner, attr) -> None:
        orig = getattr(owner, attr)

        def wait(*args, **kwargs):
            self._record()
            return orig(*args, **kwargs)

        setattr(owner, attr, wait)
        self._wrapped.append((owner, attr, orig))

    def __enter__(self) -> "SyncRecorder":
        # the filters and hook are module globals, so every thread's
        # warnings reach the hook; catch_warnings restores both on exit
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        try:
            waits = self.waits
            if self.arm:
                import torch

                torch.cuda.set_sync_debug_mode("warn")
                if torch.cuda.get_sync_debug_mode() != 1:
                    raise RuntimeError(
                        "torch.cuda.set_sync_debug_mode('warn') did not "
                        f"take: mode {torch.cuda.get_sync_debug_mode()}")
                if waits is None:
                    waits = [(_torch_attr(torch, path), attr)
                             for path, attr in WAITS]
            for owner, attr in waits or ():
                self._wrap(owner, attr)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc) -> None:
        try:
            for owner, attr, orig in reversed(self._wrapped):
                setattr(owner, attr, orig)
            self._wrapped.clear()
            if self.arm:
                import torch

                torch.cuda.set_sync_debug_mode("default")
        finally:
            self._ctx.__exit__(*exc)

    def snapshot(self) -> List[Tuple[str, List[traceback.FrameSummary]]]:
        with self._lock:
            return list(self.events)


def _torch_attr(torch, path: str):
    obj = torch
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def annotated_spans(suppressed) -> List[Tuple[str, int, int, str]]:
    """``(path, first line, last line, scope)`` of every ``sync-ok``
    call the lint lists (``Report.suppressed`` or its ``as_dict()``
    rows)."""
    out = []
    for s in suppressed:
        d = s if isinstance(s, dict) else s.as_dict()
        if d["checker"] == "sync-in-hot-path":
            out.append((d["path"], d["line"], d.get("end_line") or d["line"],
                        d["scope"]))
    return out


def classify(events, suppressed) -> Tuple[Dict[Site, int], Dict[Site, int]]:
    """Split recorded syncs into ``(annotated, unannotated)`` site
    counts.  An annotated site is the lint's ``(path, line, scope)`` of
    the ``sync-ok`` call whose lines hold the sync's innermost port
    frame; any other sync is unannotated under its innermost port frame,
    or under its innermost frame when no port frame is on its stack."""
    spans = annotated_spans(suppressed)
    ok: Counter = Counter()
    bad: Counter = Counter()
    for _thread, stack in events:
        site = innermost_port_frame(stack)
        if site is None:
            fr = stack[-1] if stack else None
            bad[("<outside the port>: " + (fr.filename if fr else "?"),
                 fr.lineno if fr else 0, fr.name if fr else "?")] += 1
            continue
        path, line, _ = site
        hit = next(((p, lo, scope) for p, lo, hi, scope in spans
                    if p == path and lo <= line <= hi), None)
        if hit is not None:
            ok[hit] += 1
        else:
            bad[site] += 1
    return dict(ok), dict(bad)
