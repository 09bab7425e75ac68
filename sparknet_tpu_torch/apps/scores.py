"""Test-score selection shared by the app drivers (the port's own copy of
``sparknet_tpu/apps/scores.py``).

The reference logs every named test-net output (``solver.cpp:397-410``) and
the apps then report "accuracy" from the blob of that name
(``CifarApp.scala:113-115``).  Nets whose accuracy tops are named
differently (GoogLeNet aux heads emit ``loss1/top-1``-style names,
``caffe/models/bvlc_googlenet/train_val.prototxt``) must not silently score
0 — accuracy-like outputs are recognized by name pattern instead.
"""

from __future__ import annotations

from typing import Dict


def accuracy_keys(scores: Dict[str, float]):
    """Score names that are accuracies: 'accuracy', '*top-1', '*top-5',
    '*/accuracy*' — the zoo's naming conventions."""
    out = []
    for name in sorted(scores):
        low = name.lower()
        if "accuracy" in low or "top-1" in low or "top-5" in low:
            out.append(name)
    return out


def primary_accuracy(scores: Dict[str, float]) -> float:
    """The single headline accuracy: exact 'accuracy' if present, else the
    top-1-like output of the FINAL head (GoogLeNet's loss3), else the last
    accuracy-like name, else raise — never a silent 0.0."""
    if "accuracy" in scores:
        return scores["accuracy"]
    keys = accuracy_keys(scores)
    if not keys:
        raise KeyError(
            f"no accuracy-like test output among {sorted(scores)}; "
            "name one 'accuracy' or '*top-1'"
        )
    top1 = [k for k in keys if "top-5" not in k.lower()]
    return scores[(top1 or keys)[-1]]
