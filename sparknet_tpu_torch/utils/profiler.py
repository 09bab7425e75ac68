"""Per-layer forward/backward profiler: the ``caffe time`` analog.

The port of ``sparknet_tpu/utils/profiler.py`` (reference:
``tools/caffe.cpp:290-376``): after a warm-up, the whole net's forward
and forward+backward, then each layer alone on its real activations,
forward and backward, averaged over ``iterations`` and timed by
``utils/timers.Timer`` (CUDA events on the card).  The per-layer numbers
time one layer in isolation: they show relative cost and do not add up
to the whole net's.  A layer's backward is timed as its forward plus
the gradient of its tops' sum with respect to its floating inputs and
parameters, as the JAX package's ``jax.grad`` of the layer does; a
layer none of whose tops depends differentiably on those (Accuracy, an
argmax) reports ``nan``.  ``profile_trace(path)`` is a ``torch.profiler``
context that writes a Chrome trace.
"""

from __future__ import annotations

from typing import Dict

import torch

from sparknet_tpu_torch.ops import data_layers
from sparknet_tpu_torch.utils import rngs
from sparknet_tpu_torch.utils.timers import Timer


def _time_fn(fn, iters: int, device, warmup: int = 1) -> float:
    """Seconds a call of ``fn`` takes, averaged over ``iters``."""
    for _ in range(warmup):
        fn()
    t = Timer(device).start()
    for _ in range(iters):
        fn()
    return t.stop().seconds() / iters


def _leaf(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.requires_grad_(True) if t.is_floating_point() else t


def profile_net(net, params, stats, batch, iterations: int = 10,
                rng=None) -> Dict[str, object]:
    """``{layers: {name: {forward_ms, backward_ms}}, total_forward_ms,
    total_fwdbwd_ms}``, ``caffe time``'s table, for a ``TorchNet`` with
    ``params``/``stats`` and a host-fed ``batch`` of tensors on the
    device."""
    rng = rngs.train_key(0) if rng is None else rng
    device = next(iter(batch.values())).device
    flat = [p for blobs in params.values() for p in blobs]

    def fwd():
        with torch.no_grad():
            return net.apply(params, stats, batch, train=True, rng=rng).loss

    req = [p.detach().requires_grad_(True) for p in flat]
    it = iter(req)
    gparams = {k: [next(it) for _ in v] for k, v in params.items()}

    def fwdbwd():
        loss = net.apply(gparams, stats, batch, train=True, rng=rng).loss
        return torch.autograd.grad(loss, req, allow_unused=True)

    total_fwd = _time_fn(fwd, iterations, device)
    # a net with no parameter the loss depends on has no backward
    total_fwdbwd = (_time_fn(fwdbwd, iterations, device) if req
                    and net.apply(gparams, stats, batch, train=True,
                                  rng=rng).loss.requires_grad
                    else float("nan"))

    # per layer, on the real activations of one forward
    with torch.no_grad():
        blobs = {k: v.detach() for k, v in
                 net.apply(params, stats, batch, train=True, rng=rng).blobs.items()}
    per_layer: Dict[str, Dict[str, float]] = {}
    for li, layer in enumerate(net.layers):
        if isinstance(layer, data_layers._HostFed):
            continue
        lblobs = net._gather_blobs(layer.name, params, stats)
        bottoms = [blobs[b] for b in layer.lp.bottom]
        lrng = rngs.fold_in(rng, li)

        def run(lb=lblobs, bt=bottoms, layer=layer, lrng=lrng):
            with torch.no_grad():
                return layer.apply(list(lb), list(bt), lrng, True)[0]

        f_ms = _time_fn(run, iterations, device) * 1e3
        g_lb = [_leaf(b) for b in lblobs]
        g_bt = [_leaf(b) for b in bottoms]
        inputs = [x for x in g_lb + g_bt if x.requires_grad]
        tops = layer.apply(list(g_lb), list(g_bt), lrng, True)[0] if inputs else []
        # the check: a top that depends differentiably on an input
        if any(t.requires_grad for t in tops):

            def grad(g_lb=g_lb, g_bt=g_bt, inputs=inputs, layer=layer,
                     lrng=lrng):
                ts = layer.apply(list(g_lb), list(g_bt), lrng, True)[0]
                total = sum(t.sum() for t in ts if t.requires_grad)
                return torch.autograd.grad(total, inputs, allow_unused=True)

            b_ms = _time_fn(grad, iterations, device) * 1e3
        else:
            b_ms = float("nan")
        per_layer[layer.name] = {"forward_ms": f_ms, "backward_ms": b_ms}
    return {
        "layers": per_layer,
        "total_forward_ms": total_fwd * 1e3,
        "total_fwdbwd_ms": total_fwdbwd * 1e3,
    }


def format_profile(result: Dict[str, object]) -> str:
    """The ``caffe time``-style report (the JAX package's layout)."""
    lines = ["%-20s %14s %14s" % ("layer", "forward (ms)", "backward (ms)")]
    for name, t in result["layers"].items():
        lines.append("%-20s %14.3f %14.3f"
                     % (name, t["forward_ms"], t["backward_ms"]))
    lines.append("fused whole-net: forward %.3f ms, forward+backward %.3f ms"
                 % (result["total_forward_ms"], result["total_fwdbwd_ms"]))
    return "\n".join(lines)


def profile_trace(path: str):
    """A ``torch.profiler`` context (CPU and, where there is one, CUDA
    activity) that writes a Chrome trace to ``path`` when it exits."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)

    def save(prof):
        prof.export_chrome_trace(path)

    return profile(activities=acts, on_trace_ready=save)
