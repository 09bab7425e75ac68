"""Training-side snapshot publisher: the train half of train-to-serve.

The port of ``sparknet_tpu/serve/publish.py``.  ``publish_snapshot``
writes a solver's state where a serving fleet's delivery watcher
(``serve/delivery.py``) looks: a normal CRC-manifested snapshot
(``io/checkpoint.py`` — same wire formats, same atomic manifest-last
publish) with the training-health verdict ATTACHED to the manifest.
The gate is hard: ``publish_snapshot()`` refuses a verdict that is not
passing (halted sentry, anomaly inside the cooldown window), so a
diverged run can never hand its weights to serving — and the delivery
watcher independently re-checks the verdict AND the CRCs before any
canary sees traffic (the canary itself is the last line).  The
trainer's ``--publish_to`` flag, which implies the health sentry, comes
with the sentry; ``verdict_from_sentry`` reads any object with the
sentry's attributes.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

from sparknet_tpu_torch import obs
from sparknet_tpu_torch.io import checkpoint

# a publish is refused while the sentry's last anomaly is closer than
# this many rounds behind — "it recovered one round ago" is not health
VERDICT_COOLDOWN_ROUNDS = 2


class PublishRefused(RuntimeError):
    """The attached health verdict is not passing — nothing published."""


def verdict_from_sentry(sentry) -> Dict:
    """Fold a ``HealthSentry`` (or None) into the publishable verdict.

    Passing requires: a sentry actually watched the run, it never
    halted, and any anomaly is at least ``VERDICT_COOLDOWN_ROUNDS``
    rounds cold.  No sentry -> not passing (an unaudited run has no
    health evidence to attach)."""
    if sentry is None:
        return {
            "passing": False,
            "reason": "no health sentry watched this run "
            "(--publish_to implies --health)",
        }
    state = sentry.state_dict()
    if sentry.halted:
        passing, reason = False, f"sentry halted: {sentry.halt_reason}"
    elif sentry.rounds_observed < 1:
        passing, reason = False, "sentry observed no rounds"
    elif sentry.last_anomaly_round is not None and (
        sentry.last_round is None
        or sentry.last_round - sentry.last_anomaly_round
        < VERDICT_COOLDOWN_ROUNDS
    ):
        passing, reason = False, (
            "anomaly at round %s is inside the %d-round cooldown"
            % (sentry.last_anomaly_round, VERDICT_COOLDOWN_ROUNDS)
        )
    else:
        passing, reason = True, "sentry clean"
    return {
        "passing": bool(passing),
        "reason": reason,
        "rounds_observed": int(sentry.rounds_observed),
        "sentry": state,
    }


def _as_local_dir(publish_to: str) -> str:
    """The publisher writes LOCAL directories (optionally ``file://``);
    remote publish roots are the watcher's side of the contract (it
    reads through any object store)."""
    if publish_to.startswith("file://"):
        return publish_to[len("file://"):]
    if "://" in publish_to:
        raise ValueError(
            f"publish_to {publish_to!r}: the publisher writes local "
            "directories (file:// ok); point serving's --watch at the "
            "store that fronts it"
        )
    return publish_to


def attach_verdict(manifest_path: str, verdict: Dict) -> None:
    """Fold the verdict into an already-published manifest (atomic
    rewrite — the manifest stays the last file to change)."""
    manifest = checkpoint.read_manifest(manifest_path)
    manifest["verdict"] = verdict

    def _dump(tmp):
        with open(tmp, "w") as f:
            f.write(json.dumps(manifest))

    checkpoint._atomic(_dump, manifest_path)


def publish_snapshot(
    solver,
    state,
    publish_to: str,
    verdict: Dict,
    fmt: Optional[str] = None,
    require_passing: bool = True,
) -> Tuple[str, str]:
    """Publish ``state`` as ``<publish_to>/published_iter_<N>.*`` with
    ``verdict`` attached to the manifest.  Refuses (raises
    ``PublishRefused``, writes NOTHING) unless the verdict is passing.
    Returns the published (model_path, state_path)."""
    if require_passing and not verdict.get("passing"):
        raise PublishRefused(
            "refusing to publish: verdict not passing "
            f"({verdict.get('reason', 'no reason recorded')})"
        )
    root = _as_local_dir(publish_to)
    os.makedirs(root, exist_ok=True)
    # snapshot into a HIDDEN staging dir (same filesystem), attach the
    # verdict there, then rename into the watched root manifest-LAST:
    # the first manifest a polling watcher can ever see already carries
    # the verdict — no window where a verdict-less publish is visible
    # (the watcher would reject + quarantine it mid-flight).  Watchers
    # skip dot-prefixed path components by contract.
    stage = tempfile.mkdtemp(prefix=".publish-", dir=root)
    try:
        paths = checkpoint.snapshot(
            solver, state, os.path.join(stage, "published"), fmt=fmt
        )
        mpath = checkpoint.manifest_path_for(paths[1])
        attach_verdict(mpath, verdict)
        final = []
        for p in paths:
            dst = os.path.join(root, os.path.basename(p))
            os.replace(p, dst)
            final.append(dst)
        os.replace(mpath, os.path.join(root, os.path.basename(mpath)))
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    obs.instant(
        "publish", cat="delivery",
        snapshot=os.path.basename(final[0]),
        passing=bool(verdict.get("passing")),
    )
    return tuple(final)
