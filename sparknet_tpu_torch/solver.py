"""Solver family: Caffe-exact update rules over parameter dicts.

The port of ``sparknet_tpu/solver.py`` (reference: ``sgd_solver.cpp``,
``solvers/*.cpp``): ``TrainState``, the 7 LR policies
(``learning_rate``), the 6 update rules (``_compute_update``) and
``Solver`` — ``_apply_update`` with weight decay (L1/L2),
``lr_mult``/``decay_mult``, ``iter_size`` and ``clip_gradients``,
``_step_tau`` (tau iterations) under ``step`` and ``step_repeat``, the
smoothed loss and ``test_and_store_result``.  Where the JAX solver
scans a jitted step, this one loops eagerly: gradients from
``torch.autograd``, updates out of place (a new tensor per blob), so a
state handed in is never modified.  ``audit=True`` adds the numerics
audit (``obs/health.py``): each window then also returns its stats
tree, read from values the update produced, so a trajectory is bit for
bit the same with the audit on or off.  ``debug_info`` is not ported.

Randomness follows the JAX solver's key structure (``utils.rngs``):
``_step_tau`` takes a key, each iteration folds in its ``iter``, the
train transform draws from ``fold_in(key, 0x7F)`` and the net's layers
from the iteration key.  ``train_transform(batch, key)`` and
``test_transform(batch)`` (``data/transforms.py``) run on the device
before each micro-batch's forward and each test forward.

Semantics of the reference: momentum ``v = m*v + local_lr*(grad +
decay*w); w -= v`` (decay inside the gradient, before momentum),
clip_gradients on the raw accumulated grads before normalization.
Scalar schedule math (rate, Adam's bias correction) is done in float32
as the JAX package does it; ``iter`` is a CPU integer tensor, so the
schedule never waits on the card.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from sparknet_tpu_torch.config import resolve_solver_net
from sparknet_tpu_torch.config.schema import (
    NetParameter,
    SolverParameter,
    solver_method,
)
from sparknet_tpu_torch.net import Params, Stats, TorchNet
from sparknet_tpu_torch.obs import health as _health
from sparknet_tpu_torch.obs import profile as _profile
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.utils import rngs
from sparknet_tpu_torch.utils.devices import resolve_device
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    """Everything the reference snapshots: params + SolverState (iter,
    history) + stat blobs."""

    params: Params
    stats: Stats
    history: Any  # per-method dict(s) shaped like params
    iter: torch.Tensor  # int64 on the CPU: () one worker, (W,) stacked


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def learning_rate(p: SolverParameter, it) -> torch.Tensor:
    """Rate at iteration ``it`` as a 0-dim float32 tensor (reference:
    sgd_solver.cpp:27-64)."""
    it = _f32(float(it))
    policy = p.lr_policy
    base = p.base_lr
    if policy == "fixed":
        return _f32(base)
    if policy == "step":
        return base * torch.pow(_f32(p.gamma), torch.floor(it / p.stepsize))
    if policy == "exp":
        return base * torch.pow(_f32(p.gamma), it)
    if policy == "inv":
        return base * torch.pow(1.0 + p.gamma * it, -p.power)
    if policy == "multistep":
        sv = _f32(p.stepvalue or [float("inf")])
        current_step = (it >= sv).sum().to(torch.float32)
        return base * torch.pow(_f32(p.gamma), current_step)
    if policy == "poly":
        return base * torch.pow(1.0 - it / max(1, p.max_iter), p.power)
    if policy == "sigmoid":
        return base / (1.0 + torch.exp(-p.gamma * (it - p.stepsize)))
    raise ValueError(f"unknown lr_policy {policy!r}")


def _init_history(method: str, params):
    zeros = tree_map(torch.zeros_like, params)
    if method in ("SGD", "NESTEROV", "ADAGRAD", "RMSPROP"):
        return zeros
    if method in ("ADADELTA", "ADAM"):
        return (zeros, tree_map(torch.zeros_like, params))
    raise ValueError(f"unknown solver method {method!r}")


def _compute_update(method, p: SolverParameter, g, w, hist, local_rate: float,
                    it: int):
    """Per-blob update value + new history, as each reference solver's
    ComputeUpdateValue."""
    if method == "SGD":
        v = p.momentum * hist + local_rate * g
        return v, v
    if method == "NESTEROV":
        v = p.momentum * hist + local_rate * g
        return (1.0 + p.momentum) * v - p.momentum * hist, v
    if method == "ADAGRAD":
        acc = hist + g * g
        return local_rate * g / (torch.sqrt(acc) + p.delta), acc
    if method == "RMSPROP":
        acc = p.rms_decay * hist + (1.0 - p.rms_decay) * g * g
        return local_rate * g / (torch.sqrt(acc) + p.delta), acc
    if method == "ADADELTA":
        acc_g, acc_x = hist
        m = p.momentum
        acc_g = m * acc_g + (1.0 - m) * g * g
        upd = g * torch.sqrt((acc_x + p.delta) / (acc_g + p.delta))
        acc_x = m * acc_x + (1.0 - m) * upd * upd
        return local_rate * upd, (acc_g, acc_x)
    if method == "ADAM":
        m_t, v_t = hist
        b1, b2 = p.momentum, p.momentum2
        t = _f32(float(it)) + 1.0
        corr = torch.sqrt(1.0 - torch.pow(_f32(b2), t)) / (
            1.0 - torch.pow(_f32(b1), t)
        )
        m_t = b1 * m_t + (1.0 - b1) * g
        v_t = b2 * v_t + (1.0 - b2) * g * g
        rate_corr = float(_f32(local_rate) * corr)
        return rate_corr * m_t / (torch.sqrt(v_t) + p.delta), (m_t, v_t)
    raise ValueError(f"unknown solver method {method!r}")


class Solver:
    """Driver-facing solver (the reference's ``CaffeNet`` + ``Solver``).

    Typical use::

        solver = Solver(solver_param, device="cpu")
        state = solver.init_state(seed=0)
        state, losses = solver.step(state, stacked_batches)  # tau iters

    ``device`` defaults to the card (``utils.devices.resolve_device``).
    ``net`` trains a net object instead of a prototxt net: anything with
    ``init(seed, device) -> (params, stats)``, ``loss_fn(params, stats,
    batch, train)``, ``param_multipliers()`` and ``feed_blobs``
    (``models.transformer_lm.TransformerLMNet`` is one); the update
    rules and the trainers are generic over its params dict.
    ``audit`` turns on the numerics audit (and a trainer's in-round
    worker mask, which reads it each round).
    ``train_transform`` / ``test_transform`` are the per-phase batch
    preprocessing of JAX ``Solver`` (``data/transforms.py``)."""

    def __init__(
        self,
        param: SolverParameter,
        net_param: Optional[NetParameter] = None,
        device=None,
        net=None,
        train_transform=None,
        test_transform=None,
        audit: bool = False,
    ):
        if param.debug_info:
            raise NotImplementedError(
                "solver debug_info is not yet ported to sparknet_tpu_torch"
            )
        self.device = resolve_device(device)
        self.audit = bool(audit)
        self._audit_groups: List[str] = []
        self.train_transform = train_transform
        self.test_transform = test_transform
        self.param = param
        self.method = solver_method(param)
        if net is not None:
            if net_param is not None:
                raise ValueError("pass net= or net_param=, not both")
            self.net_param = None
            self.net = net
        else:
            netp = net_param if net_param is not None else resolve_solver_net(param)
            self.net_param = netp
            self.net = TorchNet(netp, phase="TRAIN")
        self._test_net: Optional[TorchNet] = None
        self._lr_mults, self._decay_mults = self.net.param_multipliers()
        self._loss_window = collections.deque(maxlen=max(1, param.average_loss))
        # per-window loss tensors not yet pulled to the host:
        # smoothed_loss reads them, so the training loop never waits on
        # the card for a loss
        self._pending_losses: list = []

    @property
    def test_net(self) -> TorchNet:
        """TEST-phase view sharing the train weights, built lazily."""
        if self._test_net is None:
            if self.net_param is None:
                raise ValueError(
                    "this solver wraps a net object (net=...) with no "
                    "prototxt TEST view — score through the net's own "
                    "forward/loss_fn instead"
                )
            self._test_net = TorchNet(self.net_param, phase="TEST")
        return self._test_net

    def init_state(self, seed: int = 0) -> TrainState:
        if self.param.random_seed >= 0:
            seed = self.param.random_seed
        params, stats = self.net.init(seed, self.device)
        return TrainState(
            params=params,
            stats=stats,
            history=_init_history(self.method, params),
            iter=torch.tensor(0, dtype=torch.int64),
        )

    # ------------------------------------------------------------------
    # One iteration: iter_size microbatches -> grads -> update
    # ------------------------------------------------------------------
    def _grads(self, params, stats, batch, rng: int):
        """``(grads, loss, new_stats)``; with ``iter_size > 1`` every blob
        of ``batch`` has a leading micro-batch axis and the grads sum.
        ``rng`` is the iteration's key; micro-batch ``i`` of several
        draws from ``fold_in(rng, i)``, as the JAX scan does."""
        leaves = tree_leaves(params)
        n = self.param.iter_size
        micro = [(batch, rng)] if n == 1 else [
            ({k: v[i] for k, v in batch.items()}, rngs.fold_in(rng, i))
            for i in range(n)
        ]
        acc, losses = None, []
        for mb, mrng in micro:
            if self.train_transform is not None:
                mb = self.train_transform(mb, rngs.fold_in(mrng, 0x7F))
            req = [p.detach().requires_grad_(True) for p in leaves]
            loss, (_, stats) = self.net.loss_fn(
                tree_unflatten(params, req), stats, mb, True, rng=mrng
            )
            gs = torch.autograd.grad(loss, req, allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g for p, g in zip(req, gs)]
            acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
            losses.append(loss.detach())
        loss = losses[0] if n == 1 else torch.stack(losses).mean()
        stats = tree_map(lambda s: s.detach(), stats)
        return tree_unflatten(params, acc), loss, stats

    @torch.no_grad()
    def _apply_update(self, params, history, grads, it: int):
        """``(new_params, new_history, grad_norm)``; ``grad_norm``, the raw
        global L2 ClipGradients reduces (sgd_solver.cpp:84-100), is
        computed once when clipping or the audit needs it (else None):
        with clipping in ClipGradients' own sum of squares, for the audit
        alone in one multi-tensor pass."""
        p = self.param
        grad_norm = None
        if p.clip_gradients > 0:
            sumsq = sum((g * g).sum() for g in tree_leaves(grads))
            grad_norm = torch.sqrt(sumsq)
        elif self.audit:
            grad_norm = _health.grad_norm(grads)
        if p.clip_gradients > 0:
            # ClipGradients on the raw accumulated grads
            norm = grad_norm
            scale = torch.where(norm > p.clip_gradients,
                                p.clip_gradients / norm, torch.ones_like(norm))
            grads = tree_map(lambda g: g * scale, grads)
        rate = learning_rate(p, it)
        inv_iter_size = 1.0 / max(1, p.iter_size)
        two = self.method in ("ADADELTA", "ADAM")
        new_params: Params = {}
        new_hist: List[Dict[str, list]] = [{}, {}] if two else [{}]
        for key, blobs in params.items():
            new_params[key] = []
            for h in new_hist:
                h[key] = []
            for idx, w in enumerate(blobs):
                g = grads[key][idx] * inv_iter_size  # Normalize
                decay = p.weight_decay * self._decay_mults[key][idx]
                if decay:
                    if p.regularization_type == "L1":
                        g = g + decay * torch.sign(w)
                    else:
                        g = g + decay * w
                hist = (
                    (history[0][key][idx], history[1][key][idx]) if two
                    else history[key][idx]
                )
                local_rate = float(rate * self._lr_mults[key][idx])
                update, new_h = _compute_update(
                    self.method, p, g, w, hist, local_rate, it
                )
                for h, v in zip(new_hist, new_h if two else (new_h,)):
                    h[key].append(v)
                new_params[key].append(w - update)  # Net::Update
        return new_params, (tuple(new_hist) if two else new_hist[0]), grad_norm

    def _one_iter(self, st: TrainState, batch, rng: int):
        """One iteration: ``(state, loss, packed audit stats or None)``."""
        grads, loss, new_stats = self._grads(
            st.params, st.stats, batch, rngs.fold_in(rng, int(st.iter))
        )
        new_params, new_history, grad_norm = self._apply_update(
            st.params, st.history, grads, int(st.iter)
        )
        packed = None
        if self.audit:
            self._audit_groups = list(new_params.keys())
            with torch.no_grad():
                packed = _health.pack(grads, st.params, new_params, loss,
                                      grad_norm)
        new_st = TrainState(new_params, new_stats, new_history, st.iter + 1)
        return new_st, loss, packed

    def audit_groups(self) -> List[str]:
        """The param groups of the audit's stats, in packed order (the
        params dict's, recorded by the last audited iteration)."""
        return self._audit_groups

    def _run_tau(self, state: TrainState, batches, rng):
        """tau iterations: ``(state, losses (tau,), packed (tau, n) or
        None)``."""
        tau = next(iter(batches.values())).shape[0]
        losses, packed = [], []
        for t in range(tau):
            state, loss, pk = self._one_iter(
                state, {k: v[t] for k, v in batches.items()}, rng
            )
            losses.append(loss)
            packed.append(pk)
        return (state, torch.stack(losses),
                torch.stack(packed) if self.audit else None)

    def _step_tau(self, state: TrainState, batches: Dict[str, torch.Tensor],
                  rng: Optional[int] = None):
        """tau iterations over ``batches`` (every blob stacked on axis 0)
        under the key ``rng`` (default ``rngs.train_key(0)``, as JAX's
        ``default_train_key(0)``).  Returns ``(state, losses (tau,))``, or
        ``(state, losses, stats)`` with the audit on (stats leaves
        (tau,)); everything stays on the device."""
        rng = rngs.train_key(0) if rng is None else rng
        state, losses, packed = self._run_tau(state, batches, rng)
        if self.audit:
            return state, losses, _health.unpack(packed, self.audit_groups())
        return state, losses

    def _to_device(self, batches) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batches.items()}

    def step(self, state: TrainState, batches, rng: Optional[int] = None):
        """Run tau iterations, tau being the leading axis of every entry
        of ``batches`` (numpy arrays or tensors; the ``solver_step(state,
        tau)`` analog, ccaffe.cpp:230-233).  Returns ``(state, per-iter
        losses (tau,))``; the losses feed ``smoothed_loss``."""
        with span("execute"):
            out = self._step_tau(state, self._to_device(batches), rng)
        self.note_losses(out[1])
        _profile.observe_round_if_active(out[1])  # --profile round mark
        return out

    def step_repeat(self, state: TrainState, batch, tau: int,
                    rng: Optional[int] = None):
        """Run ``tau`` iterations on the SAME batch (every blob without a
        tau axis) — the throughput and single-batch overfit path.
        Returns ``(state, losses (tau,))``."""
        rng = rngs.train_key(0) if rng is None else rng
        batch = self._to_device(batch)
        losses, packed = [], []
        with span("execute"):
            for _ in range(int(tau)):
                state, loss, pk = self._one_iter(state, batch, rng)
                losses.append(loss)
                packed.append(pk)
        losses = torch.stack(losses)
        self.note_losses(losses)
        if self.audit:
            return state, losses, _health.unpack(torch.stack(packed),
                                                 self.audit_groups())
        return state, losses

    # ------------------------------------------------------------------
    # Smoothed loss (solver.cpp:225-234)
    # ------------------------------------------------------------------
    def note_losses(self, losses: torch.Tensor) -> None:
        """Record a tau-window's per-iter losses — (tau,) or (workers, tau)
        — for ``smoothed_loss`` without a device-to-host transfer."""
        self._pending_losses.append(losses)
        excess = len(self._pending_losses) - self._loss_window.maxlen
        if excess > 0:
            del self._pending_losses[:excess]

    def _drain_losses(self) -> None:
        pending, self._pending_losses = self._pending_losses, []
        for arr in pending:
            vals = arr.detach().cpu().numpy()
            if vals.ndim == 2:  # trainer rounds: the worker-mean per iter
                vals = np.mean(vals, axis=0)
            for v in vals.reshape(-1):
                self._loss_window.append(float(v))

    def export_loss_window(self) -> np.ndarray:
        """The ``average_loss`` window as float64 values (oldest first),
        for a job-state snapshot: a resumed run that loads it logs the
        uninterrupted run's smoothed losses."""
        self._drain_losses()
        return np.asarray(self._loss_window, np.float64)

    def restore_loss_window(self, values) -> None:
        """Replace the window with ``export_loss_window``'s values."""
        self._pending_losses = []
        self._loss_window.clear()
        self._loss_window.extend(float(v) for v in np.asarray(values).reshape(-1))

    @property
    def smoothed_loss(self) -> float:
        """Windowed average (``average_loss``); the read that waits for the
        pending loss tensors."""
        self._drain_losses()
        if not self._loss_window:
            return float("nan")
        return sum(self._loss_window) / len(self._loss_window)

    # ------------------------------------------------------------------
    # Test (TestAndStoreResult semantics)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward_test(self, params, stats, batches, count: Optional[int] = None):
        """Sum each test output over the leading batch axis; with ``count``
        (partitions padded to a common length) only the first ``count``
        batches score."""
        nb = next(iter(batches.values())).shape[0]
        n = nb if count is None else min(int(count), nb)
        names = self._test_output_names()
        outs: Dict[str, list] = {k: [] for k in names}
        for i in range(n):
            batch = {k: v[i] for k, v in batches.items()}
            if self.test_transform is not None:
                batch = self.test_transform(batch)
            blobs = self.test_net.forward(params, stats, batch)
            for k in names:
                outs[k].append(blobs[k].sum())
        return {
            k: (torch.stack(v).sum() if v else torch.zeros((), device=self.device))
            for k, v in outs.items()
        }

    def _test_output_names(self) -> List[str]:
        produced, consumed = set(), set()
        for layer in self.test_net.layers:
            produced.update(layer.lp.top)
            consumed.update(layer.lp.bottom)
        return sorted(produced - consumed - set(self.test_net.feed_blobs))

    def test_and_store_result(self, state: TrainState,
                              batches: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Per-output accumulated scores over the leading batch axis — the
        driver divides by the batch count (solver.cpp:413-444)."""
        out = self._forward_test(state.params, state.stats, batches)
        return {k: float(v) for k, v in out.items()}
