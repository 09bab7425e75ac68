"""The port's solver against the JAX package's, iteration by iteration.

The same toy net (``tests/test_parallel.py``'s, with lr/decay
multipliers on its first layer), the same carried weights and the same
seeded batches go through ``sparknet_tpu.solver.Solver.step`` (a jitted
scan) and the port's ``Solver._step_tau`` (an eager loop) for a few
iterations, for every LR policy and update rule, with ``iter_size``,
``clip_gradients`` and L1 regularization.  Float32 on the CPU on both
sides; XLA fuses the update arithmetic (FMA contraction) where PyTorch
rounds each op, hence rtol 2e-5 on params and history.
"""

import numpy as np
import pytest
import jax
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu import solver as jsolver
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch import solver as tsolver
from sparknet_tpu_torch.utils.tree import tree_leaves

NET = """
name: "toy"
layer { name: "data" type: "HostData" top: "x" top: "label"
  java_data_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
  param { lr_mult: 2 decay_mult: 0.5 } param { lr_mult: 1 decay_mult: 0 }
  inner_product_param { num_output: 16 weight_filler { type: "xavier" }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu" type: "ReLU" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "logits"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""

POLICIES = {
    "fixed": "",
    "step": "gamma: 0.5 stepsize: 2",
    "exp": "gamma: 0.9",
    "inv": "gamma: 0.1 power: 0.75",
    "multistep": "gamma: 0.5 stepvalue: 1 stepvalue: 3",
    "poly": "power: 0.5 max_iter: 10",
    "sigmoid": "gamma: -0.5 stepsize: 2",
}
METHODS = {
    "SGD": "momentum: 0.9",
    "NESTEROV": "momentum: 0.9",
    "ADAGRAD": "delta: 1e-6",
    "RMSPROP": "rms_decay: 0.95 delta: 1e-6",
    "ADADELTA": "momentum: 0.95 delta: 1e-6",
    "ADAM": "momentum: 0.9 momentum2: 0.999 delta: 1e-8",
}
TAU = 4


def _solvers(text):
    jsp = jconfig.parse_solver_prototxt(text)
    tsp = tconfig.parse_solver_prototxt(text)
    js = jsolver.Solver(jsp, net_param=jconfig.parse_net_prototxt(NET))
    ts = tsolver.Solver(tsp, net_param=tconfig.parse_net_prototxt(NET),
                        device="cpu")
    return js, ts


def _batches(iter_size=1, seed=0):
    rs = np.random.RandomState(seed)
    lead = (TAU,) if iter_size == 1 else (TAU, iter_size)
    return {"x": rs.randn(*lead, 8, 6).astype(np.float32),
            "label": rs.randint(0, 4, lead + (8,)).astype(np.float32)}


def _run(text, iter_size=1):
    js, ts = _solvers(text)
    jstate = js.init_state(0)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tparams, tstats = interop.net_params_from_jax(params, ts.net)
    tstate = tsolver.TrainState(
        tparams, tstats, tsolver._init_history(ts.method, tparams),
        torch.tensor(0),
    )
    b = _batches(iter_size)
    jstate, jl = js.step(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()})
    tstate, tl = ts._step_tau(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5)
    assert int(tstate.iter) == int(jstate.iter) == TAU
    for tree_t, tree_j in ((tstate.params, jstate.params),
                           (tstate.history, jstate.history)):
        for got, want in zip(tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
            _close(got.numpy(), np.asarray(want))
    return tstate


def _close(got, want):
    """rtol 2e-5, with an absolute floor of 1e-6 x the blob's scale for
    entries near 0."""
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_learning_rate_policies(policy):
    text = f'base_lr: 0.01 lr_policy: "{policy}" {POLICIES[policy]}'
    jp, tp = jconfig.parse_solver_prototxt(text), tconfig.parse_solver_prototxt(text)
    for it in range(0, 12):
        got = float(tsolver.learning_rate(tp, it))
        want = float(jsolver.learning_rate(jp, it))
        # past poly's max_iter both sides give NaN
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sgd_steps_under_each_policy(policy):
    _run(f'base_lr: 0.05 momentum: 0.9 weight_decay: 0.01 lr_policy: "{policy}" '
         f"{POLICIES[policy]}")


@pytest.mark.parametrize("method", sorted(METHODS))
def test_update_rules(method):
    _run(f'type: "{method}" base_lr: 0.02 weight_decay: 0.004 lr_policy: "step" '
         f"gamma: 0.5 stepsize: 2 {METHODS[method]}")


@pytest.mark.parametrize(
    "extra,iter_size",
    [("clip_gradients: 0.05", 1), ("iter_size: 2", 2),
     ('regularization_type: "L1" weight_decay: 0.01', 1),
     ("iter_size: 2 clip_gradients: 0.1", 2)],
    ids=["clip", "iter_size", "L1", "iter_size+clip"],
)
def test_clip_iter_size_and_l1(extra, iter_size):
    _run(f"base_lr: 0.05 momentum: 0.9 weight_decay: 0.004 {extra}", iter_size)


def test_lr_and_decay_multipliers_are_read():
    _, ts = _solvers("base_lr: 0.1")
    lr, decay = ts.net.param_multipliers()
    assert lr == {"ip1": [2.0, 1.0], "ip2": [1.0, 1.0]}
    assert decay == {"ip1": [0.5, 0.0], "ip2": [1.0, 1.0]}


def test_cifar10_full_multipliers():
    from sparknet_tpu_torch import models

    ts = tsolver.Solver(models.load_model_solver("cifar10_full"), device="cpu")
    lr, decay = ts.net.param_multipliers()
    assert decay["ip1"] == [250.0, 0.0]
    assert lr["conv1"] == [1.0, 2.0] and lr["conv3"] == [1.0, 1.0]


def test_smoothed_loss_windows_the_worker_mean():
    _, ts = _solvers("base_lr: 0.1 average_loss: 3")
    ts.note_losses(torch.tensor([[1.0, 2.0], [3.0, 4.0]]))  # (workers, tau)
    ts.note_losses(torch.tensor([[5.0, 6.0], [7.0, 8.0]]))
    assert ts.smoothed_loss == pytest.approx((3.0 + 6.0 + 7.0) / 3)


def test_test_and_store_result_matches():
    """Accumulated TEST-net outputs over a stack of batches, from the same
    carried weights."""
    js, ts = _solvers("base_lr: 0.1")
    jstate = js.init_state(0)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tparams, tstats = interop.net_params_from_jax(params, ts.net)
    tstate = tsolver.TrainState(tparams, tstats, None, torch.tensor(0))
    b = _batches(seed=4)
    want = js.test_and_store_result(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()})
    got = ts.test_and_store_result(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want) == {"loss"}
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)


# ----------------------------------------------------------------------
# debug_info: the reference's [Forward] / [Backward] / [Update] lines
# ----------------------------------------------------------------------
def _debug_lines(lines):
    """``(text before the value, value)`` of each line; an [Update] line
    carries two values."""
    out = []
    for line in lines:
        head, _, rest = line.rpartition(": ")
        if "; diff" in head:  # [Update] ... data: A; diff: B
            data_head, _, data = head.rpartition(": ")
            out.append((data_head + "; diff", (float(data.split(";")[0]),
                                               float(rest))))
        else:
            out.append((head, (float(rest),)))
    return out


def test_step_logs_debug_info_once_a_window(capsys):
    """``step`` with ``debug_info`` traces the window's first batch once,
    before the window, as the JAX solver's ``step`` does; the window's
    trajectory is the one without it."""
    from sparknet_tpu_torch import models as tmodels

    shapes = [(4, 3, 32, 32), (4,)]
    netp = tconfig.replace_data_layers(tmodels.load_model("cifar10_quick"),
                                       shapes, shapes)
    solvers = [tsolver.Solver(tconfig.parse_solver_prototxt(
        f"base_lr: 0.01 momentum: 0.9 debug_info: {flag}"), net_param=netp,
        device="cpu") for flag in ("true", "false")]
    state = solvers[0].init_state(0)
    rs = np.random.RandomState(11)
    batch = {"data": rs.randn(2, 4, 3, 32, 32).astype(np.float32),
             "label": rs.randint(0, 10, (2, 4)).astype(np.float32)}
    ref_state, ref_losses = solvers[1].step(state, batch)
    assert capsys.readouterr().err == ""
    got_state, losses = solvers[0].step(state, batch)
    err = capsys.readouterr().err.splitlines()
    n_params = sum(len(v) for v in state.params.values())
    assert sum("[Update]" in line for line in err) == n_params
    assert sum("[Forward] Input" in line for line in err) == 2
    assert torch.equal(losses, ref_losses)
    for a, b in zip(tree_leaves(got_state.params), tree_leaves(ref_state.params)):
        assert torch.equal(a, b)


LRN_POOL_NET = """
name: "lrn_pool"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 2 dim: 3 dim: 11 dim: 11 } shape { dim: 2 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.01 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 3 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip1" bottom: "label" top: "loss" }
"""


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_debug_info_lines_match_jax(monkeypatch, fusion):
    """``debug_info_pass`` logs the JAX pass's lines: the same names in
    the same order, every value within 1e-5 relative (float32 sums in
    another order).  The ReLU is in place, so conv1's diff sums its two
    bindings', as the JAX zero taps do.  Under ``SPARKNET_FUSION=1`` the
    LRN's top is fused away and neither package logs it (the JAX fused
    kernel in interpret mode)."""
    monkeypatch.setenv("SPARKNET_FUSION", fusion)
    text = "base_lr: 0.01 debug_info: true"
    js = jsolver.Solver(jconfig.parse_solver_prototxt(text),
                        net_param=jconfig.parse_net_prototxt(LRN_POOL_NET))
    ts = tsolver.Solver(tconfig.parse_solver_prototxt(text),
                        net_param=tconfig.parse_net_prototxt(LRN_POOL_NET),
                        device="cpu")
    assert bool(ts.net._plp_fused) == bool(js.net._plp_fused) == (fusion == "1")
    jstate = js.init_state(0)
    tparams, tstats = interop.net_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), ts.net)
    tstate = tsolver.TrainState(tparams, tstats, None, torch.tensor(0))
    rs = np.random.RandomState(3)
    batch = {"data": rs.randn(2, 3, 11, 11).astype(np.float32),
             "label": np.array([0, 2], np.float32)}
    want, got = [], []
    js.debug_info_pass(jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                       rng=jsolver.default_train_key(0), log=want.append)
    ts.debug_info_pass(tstate, batch, log=got.append)
    assert any("blob norm1 diff" in line for line in got) == (fusion == "0")
    w, g = _debug_lines(want), _debug_lines(got)
    assert [h for h, _ in g] == [h for h, _ in w]
    for (head, gv), (_, wv) in zip(g, w):
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-9, err_msg=head)
