"""Training-log parser — the ``tools/extra/parse_log.py`` role.

The port's own copy of ``sparknet_tpu/tools/parse_log.py``.

Parses BOTH experiment-record formats into train/test row tables and
CSV files, so training curves plot without ad-hoc grepping — the same
workflow the reference's parse_log.py + plot_training_log.py serve for
glog output:

- the flat ``training_log_<ts>*.txt`` format (elapsed seconds +
  structured phase messages, ``utils/trainlog.py``), and
- the structured JSONL run log the round-span tracer streams
  (``obs/trace.py``; one JSON object per line) — ``TrainingLog`` lines
  ride in it as ``{"kind": "instant", "name": "log", ...}`` records,
  which are recognized with the SAME line matchers.  Span/other records
  are skipped.

Recognized lines:

- ``<sec>: round <r> trained, smoothed_loss <v>``   (app loops)
- ``<sec>: iter <i> smoothed_loss <v>``             (cli train)
- ``<sec>: test output <name> = <v>``               (test phases)
- ``<sec>, i = <r>: <message ...>``                 (round-indexed)
"""

from __future__ import annotations

import csv
import json
import re
from typing import Dict, Iterable, Iterator, List, Tuple

_TRAIN_ROUND = re.compile(
    r"^([\d.]+):\s+round\s+(\d+)\s+trained,\s+smoothed_loss\s+([-\d.eE]+)"
)
_TRAIN_ITER = re.compile(
    r"^([\d.]+):\s+iter\s+(\d+)\s+smoothed_loss\s+([-\d.eE]+)"
)
_TEST_OUT = re.compile(
    r"^([\d.]+):\s+test output\s+(\S+)\s+=\s+([-\d.eE]+)"
)
_ROUND_SCORE = re.compile(
    r"^([\d.]+):\s+round\s+(\d+),\s+(\w+)\s+([-\d.eE]+)"
)


def is_jsonl_log(path: str) -> bool:
    """Structured-run-log sniff: the first non-blank line is a JSON
    object (the flat format always starts ``<seconds>:``)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                return line.startswith("{")
    return False


def _jsonl_to_lines(f: Iterable[str]) -> Iterator[str]:
    """Reconstruct flat-format lines from JSONL ``log`` records (other
    record kinds — spans, faults, retries — carry no train/test rows
    and are skipped so they cannot split a pending test-row merge)."""
    for raw in f:
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw)
        except ValueError:
            continue
        if rec.get("name") != "log":
            continue
        args = rec.get("args") or {}
        msg = args.get("msg", "")
        sec = args.get("elapsed", rec.get("ts_s", 0.0))
        i = args.get("i", -1)
        if isinstance(i, (int, float)) and i >= 0:
            yield f"{sec}, i = {int(i)}: {msg}"
        else:
            yield f"{sec}: {msg}"


def _parse_lines(lines: Iterable[str]) -> Tuple[List[dict], List[dict]]:
    train: List[dict] = []
    test: List[dict] = []
    pending: Dict[str, float] = {}
    pending_sec = None

    def flush():
        nonlocal pending, pending_sec
        if pending:
            test.append({"seconds": pending_sec, **pending})
        pending, pending_sec = {}, None

    for line in lines:
        line = line.strip()
        m = _TEST_OUT.match(line)
        if m:
            sec = float(m.group(1))
            if pending_sec is not None and sec != pending_sec:
                flush()
            pending_sec = sec
            pending[m.group(2)] = float(m.group(3))
            continue
        m = _TRAIN_ROUND.match(line) or _TRAIN_ITER.match(line)
        if m:
            flush()
            train.append(
                {
                    "seconds": float(m.group(1)),
                    "round_or_iter": int(m.group(2)),
                    "smoothed_loss": float(m.group(3)),
                }
            )
            continue
        m = _ROUND_SCORE.match(line)
        if m:
            # "round R, accuracy A" annotates the pending test row
            if pending_sec is None:
                pending_sec = float(m.group(1))
            pending.setdefault("round", int(m.group(2)))
            pending[m.group(3)] = float(m.group(4))
            continue
        flush()
    flush()
    return train, test


def parse_log(path: str) -> Tuple[List[dict], List[dict]]:
    """-> (train_rows, test_rows); auto-detects flat vs JSONL.

    train rows: {seconds, round_or_iter, smoothed_loss};
    test rows: {seconds, <output name>: value, ...} — consecutive
    ``test output`` lines at one timestamp merge into one row."""
    jsonl = is_jsonl_log(path)
    with open(path) as f:
        lines = _jsonl_to_lines(f) if jsonl else f
        return _parse_lines(lines)


def write_csvs(train: List[dict], test: List[dict], prefix: str) -> List[str]:
    paths = []
    for rows, kind in ((train, "train"), (test, "test")):
        if not rows:
            continue
        path = f"{prefix}.{kind}.csv"
        keys: List[str] = []
        for row in rows:
            for k in row:
                if k not in keys:
                    keys.append(k)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        paths.append(path)
    return paths
