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
bit the same with the audit on or off.  ``compute_dtype`` (e.g.
``"bfloat16"``) runs the TRAIN net and its TEST view in that dtype, as
JAX ``Solver(compute_dtype=...)`` does: the casts sit inside the graph
(``TorchNet``), so parameters, history, gradients and the update stay
float32.  ``param.debug_info`` logs the reference's ``[Forward]`` /
``[Backward]`` / ``[Update]`` lines once a window (``debug_info_pass``).

Randomness follows the JAX solver's key structure (``utils.rngs``):
``_step_tau`` takes a key, each iteration folds in its ``iter``, the
train transform draws from ``fold_in(key, 0x7F)`` and the net's layers
from the iteration key.  ``train_transform(batch, key)`` and
``test_transform(batch)`` (``data/transforms.py``) run on the device
before each micro-batch's forward and each test forward.

Across processes (JAX ``grad_reduce_axes`` / ``_reduce_grads``):
``grad_groups`` names the ``torch.distributed`` groups over which each
rank's gradients are partial — the sp group of the LM's sequence ring,
the dp group of ``AllReduceTrainer`` — and an iteration sums its grads
over each, between ``_grads`` and ``_apply_update``, as one flat buffer
a dtype a group (``mesh.all_reduce_sum``: ``all_reduce(SUM)``, the same
bits on every rank, so every rank's params, history and loss stay
bit-identical, and clipping and the audit read the summed grads).  With
``batch_shard`` (``utils/dp.py``) the forward runs on this rank's rows of
a global batch: the shard is active around each micro-batch's transform
and forward, and the loss, this rank's share of the global loss, rides
the shard group's buffer, so the loss each rank reports is the global
one.

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
from sparknet_tpu_torch import obs as _obs
from sparknet_tpu_torch.net import Params, Stats, TorchNet
from sparknet_tpu_torch.obs import health as _health
from sparknet_tpu_torch.obs import profile as _profile
from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.utils import dp, rngs
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
    worker mask, which reads it each round).  ``compute_dtype`` (None,
    a ``torch.dtype`` or its name) is the dtype the prototxt net's
    layers compute in; the master copies stay float32.
    ``train_transform`` / ``test_transform`` are the per-phase batch
    preprocessing of JAX ``Solver`` (``data/transforms.py``).
    ``grad_groups`` are the process groups each iteration's grads sum
    over (``grad_reduce_bytes`` counts what this rank sent into them);
    ``batch_shard``, set by ``AllReduceTrainer``, is this rank's place in
    a global batch."""

    def __init__(
        self,
        param: SolverParameter,
        net_param: Optional[NetParameter] = None,
        device=None,
        net=None,
        train_transform=None,
        test_transform=None,
        audit: bool = False,
        compute_dtype=None,
        grad_groups=(),
    ):
        self.device = resolve_device(device)
        self.grad_groups = tuple(grad_groups or ())
        self.batch_shard: Optional[dp.BatchShard] = None
        self.grad_reduce_bytes = 0
        self.compute_dtype = compute_dtype
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
            self.net = TorchNet(netp, phase="TRAIN",
                                compute_dtype=compute_dtype)
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
            self._test_net = TorchNet(self.net_param, phase="TEST",
                                      compute_dtype=self.compute_dtype)
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
            with dp.active(self.batch_shard):
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
        if self.grad_groups:
            acc, loss = self._reduce_grads(acc, loss)
        return tree_unflatten(params, acc), loss, stats

    @torch.no_grad()
    def _reduce_grads(self, grads: List[torch.Tensor], loss: torch.Tensor):
        """Sum the partial ``grads`` over each of ``grad_groups``: one flat
        buffer a dtype a group.  The loss joins the batch shard's group's
        buffer (its rows' share of the global loss); a loss that is
        global already (the LM's sp ring) stays as it is."""
        shard_group = (self.batch_shard.group if self.batch_shard is not None
                       else None)
        from sparknet_tpu_torch.parallel import mesh

        for group in self.grad_groups:
            items = list(grads) + ([loss] if group is shard_group else [])
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for i, t in enumerate(items):
                by_dtype.setdefault(t.dtype, []).append(i)
            for idx in by_dtype.values():
                flat = torch.cat([items[i].reshape(-1) for i in idx])
                self.grad_reduce_bytes += flat.numel() * flat.element_size()
                flat = mesh.all_reduce_sum(flat, group)
                off = 0
                for i in idx:
                    k = items[i].numel()
                    items[i] = flat[off:off + k].view_as(items[i])
                    off += k
            grads = items[:len(grads)]
            if group is shard_group:
                loss = items[-1]
        return grads, loss

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
        losses (tau,))``; the losses feed ``smoothed_loss``.  With
        ``param.debug_info`` the window's first batch is traced first
        (``debug_info_pass``)."""
        if self.param.debug_info:
            self.debug_info_pass(state, {k: v[0] for k, v in batches.items()},
                                 rng=rng)
        with span("execute"):
            out = self._step_tau(state, self._to_device(batches), rng)
        self.note_losses(out[1])
        tm = _obs.training_metrics()
        if tm is not None:  # a window is a round of the installed metrics
            tm.rounds.inc()
            tm.iters.inc(int(out[1].shape[0]))
        _profile.observe_round_if_active(out[1])  # --profile round mark
        _obs.report_healthy()
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
    # debug_info (reference: net.cpp:648-735, gated by
    # SolverParameter.debug_info): per-blob mean |x| tracing
    # ------------------------------------------------------------------
    def debug_info_pass(self, state: TrainState, batch, rng=None, log=None):
        """Log every blob's data and diff mean absolute value in the
        reference's ``[Forward]`` / ``[Backward]`` / ``[Update]`` lines,
        in the JAX solver's order and with its names (``log``: a callable
        taking a line, default stderr).  One forward and one backward,
        outside the window, under the window's key ``rng`` as JAX's: the
        activation gradients come from hooks on every top the forward
        binds (``TorchNet.apply(on_top=)``; a fused-away intermediate is
        absent from the blob map and skipped, as in JAX), the parameter
        gradients from the same backward.  The parameters are not
        updated; ``[Update]`` reports their data and diff, as JAX's."""
        import sys

        log = log or (lambda line: print(line, file=sys.stderr))
        rng = rngs.train_key(0) if rng is None else rng
        net = self.net
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

        def asum(t) -> float:
            return float(t.detach().float().abs().mean())

        # every binding of a blob name is bound as an identity view with
        # a hook (a node of its own, so an aliased top, a Split's, sees
        # only its own consumers' gradient); a rebound name's diff sums
        # its bindings', as the JAX pass's one zero tap added at each
        # binding does
        diffs: Dict[str, torch.Tensor] = {}

        def add(name, g):
            diffs[name] = g if name not in diffs else diffs[name] + g

        def hook(name, t):
            if not t.requires_grad:
                return t
            v = t.view_as(t)
            v.register_hook(lambda g: add(name, g.float()))
            return v

        leaves = tree_leaves(state.params)
        req = [p.detach().requires_grad_(True) for p in leaves]
        with dp.active(self.batch_shard):
            out = net.apply(tree_unflatten(state.params, req), state.stats,
                            batch, train=True, rng=rng, on_top=hook)
            grads = torch.autograd.grad(out.loss, req, allow_unused=True)
        grads = tree_unflatten(state.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(req, grads)])
        for b in net.feed_blobs:
            log(f"    [Forward] Input {b} data: {asum(batch[b]):.6g}")
        for layer in net.layers:
            for top in layer.lp.top:
                if top not in out.blobs:
                    continue  # fused-away intermediate (SPARKNET_FUSION)
                log(f"    [Forward] Layer {layer.name}, top blob {top} "
                    f"data: {asum(out.blobs[top]):.6g}")
            for pi, blob in enumerate(state.params.get(layer.name, [])):
                log(f"    [Forward] Layer {layer.name}, param blob {pi} "
                    f"data: {asum(blob):.6g}")
        taps = {name for name in net.blob_shapes
                if name not in net.feed_blobs and name in out.blobs}
        for layer in reversed(net.layers):
            for bot in layer.lp.bottom:
                if bot in taps:
                    g = diffs.get(bot)
                    log(f"    [Backward] Layer {layer.name}, bottom blob "
                        f"{bot} diff: {0.0 if g is None else asum(g):.6g}")
            for pi, g in enumerate(grads.get(layer.name, [])):
                log(f"    [Backward] Layer {layer.name}, param blob {pi} "
                    f"diff: {asum(g):.6g}")
        for layer in net.layers:
            for pi, blob in enumerate(state.params.get(layer.name, [])):
                log(f"    [Update] Layer {layer.name}, param {pi} "
                    f"data: {asum(blob):.6g}; "
                    f"diff: {asum(grads[layer.name][pi]):.6g}")

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
