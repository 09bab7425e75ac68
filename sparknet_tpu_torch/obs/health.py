"""Training health: the numerics audit, the in-round worker mask's
inputs, and the divergence sentry.

The port of ``sparknet_tpu/obs/health.py``:

- **audit** (device tensors, inside the solver's step): per iteration
  the raw global grad L2 norm (the reduction ``clip_gradients`` pays,
  computed once and shared), per param group the param norm and the
  update/param ratio, and the non-finite counts of grads, params and
  loss.  ``Solver(audit=True)`` turns it on; the stats are pure
  readouts, so a trajectory is bit-identical with the audit on or off.
  Each iteration's stats are one packed float64 vector (``pack``); a
  round's stack of them is unpacked into the JAX package's stats tree
  as views (``unpack``), and ``stats_to_host`` pulls the whole tree and
  the losses to the host in one copy.
- **HealthSentry** (numpy on the host): a loss EMA with z-score spikes,
  the metrics, the flight recorder's verdicts, and the policy —
  ``warn`` logs, ``halt`` dumps a flight bundle and raises
  ``SentryHalt``, ``rollback`` restores the newest verified snapshot and
  continues with the next round's data (after ``max_rollbacks`` it
  halts).  Given the same stats sequence it gives the JAX sentry's
  verdicts.

The audit costs a few passes an iteration (the non-finite counts of the
grads and the new params, multi-tensor norm passes over the grads, the
params and the update, a group sum), no flat copy of a large leaf, and
the sentry one device-to-host copy a round.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparknet_tpu_torch.utils.tree import tree_leaves, tree_unflatten

POLICIES = ("warn", "halt", "rollback")

# packed per-iteration stats: these scalars, then param_norm and
# update_ratio, one entry a param group each
_SCALARS = ("grad_norm", "nonfinite_grads", "nonfinite_params",
            "nonfinite_loss")
_COUNTS = ("nonfinite_grads", "nonfinite_params", "nonfinite_loss")


class SentryHalt(RuntimeError):
    """The divergence sentry halted the run (policy ``halt``, or
    ``rollback`` with no restore point or its budget spent)."""

    def __init__(self, round_index: int, reason: str):
        super().__init__(f"sentry halt at round {round_index}: {reason}")
        self.round_index = round_index
        self.reason = reason


# ----------------------------------------------------------------------
# the audit (device tensors)


# a leaf this large is marked and counted in place; smaller ones are
# gathered into one flat copy first (a launch costs about what copying
# 1 M floats does)
_IN_PLACE_NUMEL = 1 << 20
# a float32 count of at most 2^24 ones is exact
_EXACT_COUNT = 1 << 24


def nonfinite_count(tree) -> torch.Tensor:
    """int32 count of non-finite values across a tree (0 if empty).
    ``x * 0`` is 0 where ``x`` is finite and NaN where it is not: one
    multi-tensor pass marks the large leaves where they lie (the small
    ones gathered), and an L0 norm of each piece of at most 2^24 marks
    counts its NaNs exactly."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.int32)
    # half-width counts are not exact: such leaves are widened
    leaves = [l.float() if l.element_size() < 4 else l for l in leaves]
    todo = [l for l in leaves if l.numel() >= _IN_PLACE_NUMEL]
    small = [l.reshape(-1) for l in leaves if l.numel() < _IN_PLACE_NUMEL]
    if small:
        todo.append(torch.cat(small))
    pieces = [p for m in torch._foreach_mul(todo, 0.0)
              for p in m.reshape(-1).split(_EXACT_COUNT)]
    counts = torch.stack(torch._foreach_norm(pieces, 0))
    return counts.to(torch.int64).sum().to(torch.int32)


def grad_norm(grads) -> torch.Tensor:
    """The raw global L2 of a grads tree in one multi-tensor norm pass:
    the audit's grad norm when ClipGradients is off (the grads are only
    read)."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tree_leaves(grads))))


_GROUP_INDEX: Dict[tuple, torch.Tensor] = {}


def _group_index(sizes: Tuple[int, ...], device) -> torch.Tensor:
    """(groups, largest group) leaf indices, padded with the index of a
    trailing zero: one gather and one row sum give every group's total
    (a 0/1 matrix product would turn an inf leaf into NaN everywhere)."""
    key = (sizes, str(device))
    idx = _GROUP_INDEX.get(key)
    if idx is None:
        pad = sum(sizes)
        idx = torch.full((len(sizes), max(sizes)), pad, dtype=torch.long)
        start = 0
        for g, n in enumerate(sizes):
            idx[g, :n] = torch.arange(start, start + n)
            start += n
        idx = _GROUP_INDEX.setdefault(key, idx.to(device))
    return idx


def _group_sums(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    padded = torch.cat([values, values.new_zeros(1)])
    return padded[idx].sum(dim=1)


def pack(grads, params, new_params, loss, grad_norm) -> torch.Tensor:
    """One iteration's audit stats as a packed float64 vector
    ``[grad_norm, nonfinite_grads, nonfinite_params, nonfinite_loss,
    param_norm (groups), update_ratio (groups)]``, groups in
    ``new_params`` order.  Nothing here feeds back into training.

    The update/param ratio is 0 (not NaN) where a group's param norm is
    zero."""
    sizes, new, old = [], [], []
    for key, blobs in new_params.items():
        sizes.append(len(blobs))
        for w_new, w_old in zip(blobs, params[key]):
            new.append(w_new.float())
            old.append(w_old.float())
    psq = torch.stack(torch._foreach_norm(new)).square_()
    usq = torch.stack(torch._foreach_norm(torch._foreach_sub(new, old))).square_()
    idx = _group_index(tuple(sizes), psq.device)
    pnorm = _group_sums(psq, idx).sqrt_()
    unorm = _group_sums(usq, idx).sqrt_()
    ratio = torch.where(pnorm > 0.0, unorm / pnorm.clamp_min(1e-12),
                        torch.zeros_like(pnorm))
    counts = torch.stack([
        nonfinite_count(grads), nonfinite_count(new_params),
        torch.isfinite(loss).logical_not().sum().to(torch.int32),
    ])
    return torch.cat([
        grad_norm.reshape(1).to(torch.float64), counts.to(torch.float64),
        pnorm.to(torch.float64), ratio.to(torch.float64),
    ])


def unpack(packed: torch.Tensor, groups) -> Dict:
    """The JAX package's stats tree over a packed ``(..., n)`` tensor,
    each leaf a view ``(...)`` of it: the scalars, and ``param_norm`` /
    ``update_ratio`` keyed by group."""
    g = len(groups)
    out = {k: packed[..., i] for i, k in enumerate(_SCALARS)}
    base = len(_SCALARS)
    out["param_norm"] = {k: packed[..., base + i] for i, k in enumerate(groups)}
    out["update_ratio"] = {k: packed[..., base + g + i]
                           for i, k in enumerate(groups)}
    return out


def audit_iteration(grads, params, new_params, loss, grad_norm) -> Dict:
    """One iteration's stats tree (the JAX function's): ``grad_norm``
    float32, the non-finite counts int32, ``param_norm`` and
    ``update_ratio`` float32 per group."""
    tree = unpack(pack(grads, params, new_params, loss, grad_norm),
                  list(new_params.keys()))
    out = {k: (tree[k].to(torch.int32) if k in _COUNTS
               else tree[k].to(torch.float32)) for k in _SCALARS}
    for k in ("param_norm", "update_ratio"):
        out[k] = {g: v.to(torch.float32) for g, v in tree[k].items()}
    return out


def bad_workers(stats) -> torch.Tensor:
    """(W,) bool on the device: the workers whose window produced a
    non-finite grad or param (stats leaves (W, tau))."""
    nf = stats["nonfinite_grads"] + stats["nonfinite_params"]
    return nf.reshape(nf.shape[0], -1).sum(dim=1) > 0


def stats_to_host(stats, *extra) -> Tuple[Dict, list]:
    """``(stats tree as numpy, [each of extra as numpy])`` from ONE
    device-to-host copy (every leaf and tensor flattened into one
    float64 buffer on the device first)."""
    leaves = tree_leaves(stats)
    tensors = leaves + list(extra)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        # host values already (a stats tree built on the host)
        out = [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t) for t in tensors]
    else:
        flat = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in tensors]).cpu()
        out, off = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[off:off + n].numpy().reshape(tuple(t.shape)))
            off += n
    return tree_unflatten(stats, out[:len(leaves)]), out[len(leaves):]


# ----------------------------------------------------------------------
# host side: verdicts + the sentry


class HealthVerdict:
    """One round's health readout (host floats; ``as_dict`` is
    JSON-safe)."""

    def __init__(self, round_index: int, loss: float, zscore: float,
                 grad_norm: float, nonfinite_grads: int, nonfinite_params: int,
                 nonfinite_loss: int, per_worker_nonfinite: Optional[List[int]],
                 masked_workers: List[int], reasons: List[str]):
        self.round_index = round_index
        self.loss = loss
        self.zscore = zscore
        self.grad_norm = grad_norm
        self.nonfinite_grads = nonfinite_grads
        self.nonfinite_params = nonfinite_params
        self.nonfinite_loss = nonfinite_loss
        self.per_worker_nonfinite = per_worker_nonfinite
        self.masked_workers = masked_workers
        self.reasons = list(reasons)
        self.action = "none"  # none|warn|masked|rollback|halt

    @property
    def nonfinite_total(self) -> int:
        return self.nonfinite_grads + self.nonfinite_params + self.nonfinite_loss

    @property
    def ok(self) -> bool:
        return not self.reasons

    def as_dict(self) -> Dict:
        return {
            "round": self.round_index,
            "loss": self.loss,
            "zscore": round(self.zscore, 3),
            "grad_norm": self.grad_norm,
            "nonfinite": self.nonfinite_total,
            "nonfinite_grads": self.nonfinite_grads,
            "nonfinite_params": self.nonfinite_params,
            "nonfinite_loss": self.nonfinite_loss,
            "per_worker_nonfinite": self.per_worker_nonfinite,
            "masked_workers": self.masked_workers,
            "ok": self.ok,
            "reasons": self.reasons,
            "action": self.action,
        }


class HealthSentry:
    """Consumes each round's audit stats, classifies and acts per policy.

    ``guarded_round(trainer, state, batches)`` and ``guarded_step(solver,
    state, batches)`` return the plain ``(state, losses)``;
    ``observe(r, losses, stats)`` is the lower-level entry.  ``metrics``
    (a ``TrainingMetrics``) receives the health series."""

    def __init__(self, policy: str = "warn", *, z_threshold: float = 6.0,
                 ema_beta: float = 0.9, warmup_rounds: int = 3,
                 cooldown_rounds: int = 3, max_rollbacks: int = 3,
                 restore_fn: Optional[Callable[[], Tuple[object, str]]] = None,
                 echo=None, metrics=None):
        if policy not in POLICIES:
            raise ValueError(f"health policy {policy!r} not in {'|'.join(POLICIES)}")
        self.policy = policy
        self.z_threshold = float(z_threshold)
        self.ema_beta = float(ema_beta)
        self.warmup_rounds = int(warmup_rounds)
        self.cooldown_rounds = int(cooldown_rounds)
        self.max_rollbacks = int(max_rollbacks)
        # restore_fn() -> (ready-to-train state, snapshot path); None
        # degrades rollback to halt
        self.restore_fn = restore_fn
        self.metrics = metrics
        self._echo = echo
        self._ema: Optional[float] = None
        self._emvar = 0.0
        self._seen = 0
        self._cooldown = 0
        # per-round EMA snapshots (the lens a late arrival is judged at;
        # journaled for the JAX package's state format)
        self._ema_ring: "OrderedDict[int, Tuple[Optional[float], float, int]]" = \
            OrderedDict()
        self.last_anomaly_round: Optional[int] = None
        self.last_round: Optional[int] = None
        self.rounds_observed = 0
        self.anomalies = 0
        self.rollbacks = 0
        self.halted = False
        self.halt_reason: Optional[str] = None
        self.verdicts: List[HealthVerdict] = []

    def _say(self, msg: str) -> None:
        if self._echo is not None:
            self._echo("health: " + msg)

    def state_dict(self) -> Dict:
        """The sentry block a health endpoint exports."""
        last = self.last_anomaly_round
        return {
            "policy": self.policy,
            "last_anomaly_round": last,
            "rounds_since_anomaly": (
                None if last is None or self.last_round is None
                else max(0, self.last_round - last)
            ),
            "anomalies": self.anomalies,
            "rollbacks": self.rollbacks,
            "halted": self.halted,
            "halt_reason": self.halt_reason,
        }

    # --- full job state: the carried scalars a resume puts back --------
    def export_state(self) -> Dict:
        return {
            "ema": self._ema,
            "emvar": self._emvar,
            "seen": self._seen,
            "cooldown": self._cooldown,
            "ema_ring": {str(r): [v[0], v[1], v[2]]
                         for r, v in self._ema_ring.items()},
            "last_anomaly_round": self.last_anomaly_round,
            "last_round": self.last_round,
            "rounds_observed": self.rounds_observed,
            "anomalies": self.anomalies,
            "rollbacks": self.rollbacks,
        }

    def load_state(self, d: Dict) -> None:
        self._ema = None if d.get("ema") is None else float(d["ema"])
        self._emvar = float(d.get("emvar", 0.0))
        self._seen = int(d.get("seen", 0))
        self._cooldown = int(d.get("cooldown", 0))
        self._ema_ring = OrderedDict(
            (int(r), (None if v[0] is None else float(v[0]), float(v[1]),
                      int(v[2])))
            for r, v in sorted((d.get("ema_ring") or {}).items(),
                               key=lambda kv: int(kv[0]))
        )
        lar = d.get("last_anomaly_round")
        self.last_anomaly_round = None if lar is None else int(lar)
        lr = d.get("last_round")
        self.last_round = None if lr is None else int(lr)
        self.rounds_observed = int(d.get("rounds_observed", 0))
        self.anomalies = int(d.get("anomalies", 0))
        self.rollbacks = int(d.get("rollbacks", 0))

    # --- z-score machinery (host floats) --------------------------------
    def _spike(self, z: float) -> bool:
        return z > self.z_threshold  # strictly above flags

    def _zscore(self, loss: float) -> float:
        return self._zscore_at(loss, (self._ema, self._emvar, self._seen))

    def _zscore_at(self, loss: float, lens) -> float:
        """The z-score of ``loss`` against an EMA lens ``(ema, emvar,
        seen)``: the live one, or a past round's from ``_ema_ring``
        (a bounded-staleness arrival is judged at its own round)."""
        if lens is None:
            return 0.0
        ema, emvar, seen = lens
        if ema is None or seen < self.warmup_rounds:
            return 0.0
        # variance floor at 5% of the loss scale: a near-constant loss
        # collapses the EMA variance and raw z would flag noise
        sigma = math.sqrt(max(0.0, emvar))
        denom = max(sigma, 0.05 * abs(ema) + 1e-8)
        return (loss - ema) / denom

    def _update_ema(self, loss: float) -> None:
        if not math.isfinite(loss):
            return  # never seed the EMA with poison
        if self._ema is None:
            self._ema = loss
            self._emvar = 0.0
        else:
            d = loss - self._ema
            self._ema += (1.0 - self.ema_beta) * d
            self._emvar = self.ema_beta * (
                self._emvar + (1.0 - self.ema_beta) * d * d)
        self._seen += 1

    def _reset_ema(self) -> None:
        self._ema = None
        self._emvar = 0.0
        self._seen = 0

    # ------------------------------------------------------------------
    def observe(self, round_index: int, losses, stats, *, arrived=None,
                worker_rounds=None) -> HealthVerdict:
        """Classify one round from its losses and audit stats tree: one
        device-to-host copy of both (``stats_to_host``).

        Bounded-staleness boundaries (``parallel/stale.py``) pass
        ``arrived`` (W bools: whose window folded in; the others' losses
        and stats are zeroed and must not drag the EMA) and
        ``worker_rounds`` (W ints: the absolute round each folded window
        belongs to).  The round's loss is the mean over the current
        round's arrivals; each stale arrival is judged against the EMA
        lens at its own round (``_ema_ring``), so a lagging worker's
        legitimately higher loss trips no spike and a divergent one
        still does."""
        from sparknet_tpu_torch import obs as _obs
        from sparknet_tpu_torch.obs import flight as _flight

        host, (loss_arr,) = stats_to_host(stats if stats is not None else {},
                                          losses)
        loss_arr = np.asarray(loss_arr, np.float64)
        stale_z = 0.0
        if (arrived is not None and loss_arr.ndim >= 2
                and np.asarray(arrived).reshape(-1).shape[0]
                == loss_arr.shape[0]):
            arr_mask = np.asarray(arrived, bool).reshape(-1)
            wr = (None if worker_rounds is None
                  else np.asarray(worker_rounds, np.int64).reshape(-1))
            fresh = arr_mask if wr is None else arr_mask & (wr >= round_index)
            base = fresh if fresh.any() else arr_mask
            sel = loss_arr[base] if base.any() else loss_arr[arr_mask]
            loss = float(np.mean(sel)) if sel.size else float("nan")
            if wr is not None:
                for w in np.nonzero(arr_mask & (wr < round_index))[0]:
                    zw = self._zscore_at(float(np.mean(loss_arr[w])),
                                         self._ema_ring.get(int(wr[w])))
                    stale_z = max(stale_z, zw)
        else:
            loss = float(np.mean(loss_arr)) if loss_arr.size else float("nan")

        def total(name) -> int:
            return int(np.sum(np.asarray(host.get(name, 0))))

        nf_grads = total("nonfinite_grads")
        nf_params = total("nonfinite_params")
        # max(), not +: the audit and this recount see the same losses
        nf_loss = max(total("nonfinite_loss"), int(np.sum(~np.isfinite(loss_arr))))
        per_worker = None
        nf_w = np.asarray(host.get("nonfinite_grads", 0)) + np.asarray(
            host.get("nonfinite_params", 0))
        if nf_w.ndim == 2:
            per_worker = [int(v) for v in nf_w.sum(axis=1)]
        masked = []
        if "masked" in host:
            m = np.asarray(host["masked"]).reshape(-1)
            masked = [int(w) for w in np.nonzero(m > 0)[0]]

        z = self._zscore(loss)
        reasons = []
        if nf_grads or nf_params or nf_loss:
            reasons.append("nonfinite")
        if self._cooldown > 0:
            self._cooldown -= 1
        elif self._spike(z) or self._spike(stale_z):
            # z: the current round's arrivals against the live EMA;
            # stale_z: each stale arrival against its own round's lens
            reasons.append("loss_spike")
        v = HealthVerdict(
            round_index, loss, z, self._last_scalar(host, "grad_norm"),
            nf_grads, nf_params, nf_loss, per_worker, masked, reasons,
        )
        self._ema_ring[int(round_index)] = (self._ema, self._emvar, self._seen)
        while len(self._ema_ring) > 128:
            self._ema_ring.popitem(last=False)
        self._update_ema(loss)
        self.last_round = round_index
        self.rounds_observed += 1
        self.verdicts.append(v)
        if len(self.verdicts) > 4096:
            del self.verdicts[:2048]

        tm = self.metrics
        if tm is not None:
            tm.grad_norm.set(v.grad_norm)
            if v.nonfinite_total:
                tm.nonfinite.inc(v.nonfinite_total)
            for group in host.get("update_ratio") or {}:
                tm.update_ratio.labels(group).set(
                    self._last_scalar(host["update_ratio"], group))
        _obs.instant("health", cat="health", **v.as_dict())
        _flight.record_verdict(v.as_dict())
        _flight.record_sample("loss", loss, round=round_index)
        _flight.record_sample("grad_norm", v.grad_norm, round=round_index)
        if not v.ok:
            self.anomalies += 1
            self.last_anomaly_round = round_index
            if tm is not None:
                for kind in v.reasons:
                    tm.health_anomalies.labels(kind).inc()
            _obs.instant("health_anomaly", cat="health", round=round_index,
                         reasons=v.reasons)
            self._say("round %d ANOMALY (%s): loss %.4g z %.2f nonfinite %d "
                      "masked %s" % (round_index, ",".join(v.reasons), loss, z,
                                     v.nonfinite_total, masked))
        return v

    @staticmethod
    def _last_scalar(host: Dict, name: str) -> float:
        arr = np.asarray(host.get(name, np.nan), np.float64).reshape(-1)
        return float(arr[-1]) if arr.size else float("nan")

    # ------------------------------------------------------------------
    def _act(self, v: HealthVerdict, state):
        """Apply the policy to an anomalous verdict; returns the state to
        continue with (restored on rollback)."""
        from sparknet_tpu_torch import obs as _obs
        from sparknet_tpu_torch.obs import flight as _flight

        absorbed = (
            v.masked_workers
            and v.per_worker_nonfinite is not None
            and len(v.masked_workers) < len(v.per_worker_nonfinite)
            and "loss_spike" not in v.reasons
        )
        if absorbed:
            # the in-round mask kept the poisoned worker(s) out of the
            # average: the weights are healthy, no escalation
            v.action = "masked"
            _flight.record_verdict(v.as_dict())
            self._say("round %d: poisoned worker(s) %s masked out of the "
                      "average; training continues"
                      % (v.round_index, v.masked_workers))
            return state
        if self.policy == "warn":
            v.action = "warn"
            _flight.record_verdict(v.as_dict())
            return state
        if self.policy == "rollback":
            if self.restore_fn is not None and self.rollbacks < self.max_rollbacks:
                try:
                    state, used = self.restore_fn()
                except (FileNotFoundError, RuntimeError) as e:
                    # no snapshot, or every candidate corrupt
                    self._halt(v, f"rollback restore failed ({e})")
                self.rollbacks += 1
                self._cooldown = self.cooldown_rounds
                self._reset_ema()
                if self.metrics is not None:
                    self.metrics.health_rollbacks.inc()
                v.action = "rollback"
                _flight.record_verdict(v.as_dict())
                _obs.instant("health_rollback", cat="health",
                             round=v.round_index,
                             snapshot=os.path.basename(str(used)))
                _flight.dump_if_active("sentry_rollback",
                                       extra={"round": v.round_index})
                self._say("round %d: rolled back to %s; skipping the poisoned "
                          "window (LR schedule replays from the restore point)"
                          % (v.round_index, os.path.basename(str(used))))
                return state
            why = ("rollback budget exhausted (%d)" % self.max_rollbacks
                   if self.restore_fn is not None
                   else "no restore point wired for rollback")
            self._halt(v, why)
        self._halt(v, "policy=halt")

    def _halt(self, v: HealthVerdict, why: str):
        from sparknet_tpu_torch import obs as _obs
        from sparknet_tpu_torch.obs import flight as _flight

        v.action = "halt"
        _flight.record_verdict(v.as_dict())  # refreshed BEFORE the dump
        self.halted = True
        self.halt_reason = f"{','.join(v.reasons)} at round {v.round_index}"
        _obs.report_unhealthy("sentry_halt: " + self.halt_reason)
        _flight.dump_if_active("sentry_halt",
                               extra={"round": v.round_index, "why": why})
        self._say(f"HALT at round {v.round_index}: {why}")
        raise SentryHalt(v.round_index, why)

    # ------------------------------------------------------------------
    def guarded_round(self, trainer, state, batches, *, live_mask=None,
                      round_index: Optional[int] = None):
        """One ``ParameterAveragingTrainer.round`` under the sentry."""
        r = self.rounds_observed if round_index is None else round_index
        state, losses, stats = trainer.round(
            state, batches, live_mask=live_mask, round_index=round_index)
        v = self.observe(r, losses, stats)
        if not v.ok:
            state = self._act(v, state)
        return state, losses

    def guarded_step(self, stepper, state, batches, *, rng=None,
                     round_index: Optional[int] = None):
        """One ``Solver.step`` window under the sentry."""
        r = self.rounds_observed if round_index is None else round_index
        state, losses, stats = stepper.step(state, batches, rng=rng)
        v = self.observe(r, losses, stats)
        if not v.ok:
            state = self._act(v, state)
        return state, losses


# ----------------------------------------------------------------------
# wiring helpers (the --health/--health_policy CLI surface)


def sentry_from_args(args, solver, restore_fn=None, echo=None, metrics=None):
    """Build (or skip) the sentry from parsed CLI args and turn the
    solver's audit on."""
    policy = getattr(args, "health_policy", None) or getattr(args, "health", None)
    if policy is None:
        return None
    from sparknet_tpu_torch import obs as _obs

    solver.audit = True
    sentry = HealthSentry(policy=policy, restore_fn=restore_fn, echo=echo,
                          metrics=metrics)
    _obs.set_sentry(sentry)
    return sentry


def make_restore_fn(solver, prefix: str, trainer=None, metrics=None):
    """A ``restore_fn`` for rollback: the newest VERIFIED snapshot under
    ``prefix`` (corrupt ones quarantined), broadcast onto the trainer's
    workers, or as it is for a single-replica solver."""
    from sparknet_tpu_torch.io import checkpoint

    def restore():
        st, used = checkpoint.restore_newest_valid(solver, prefix,
                                                   metrics=metrics)
        if trainer is not None:
            st = trainer.broadcast_state(st)
        return st, used

    return restore
