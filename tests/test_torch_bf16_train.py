"""bf16 training through the port's Solver against the JAX package's.

- The bfloat16 plain versions of K6 (the LRN backward), K7 and K8 (the
  fused LRN + 3x3/2 max pool and its backward) take the same bf16 inputs
  as the JAX Pallas kernels in interpret mode and agree within one bf16
  ulp: both widen, compute in float32 and narrow once, in other
  libraries.  Each equals the float32 plain version on the widened
  inputs, narrowed once (what the CUDA kernels equal bit for bit on the
  card, ``tests/test_torch_cuda_kernels.py``).
- ``Solver(compute_dtype="bfloat16")`` keeps float32 masters, history and
  gradients (the JAX test ``test_bfloat16_compute_keeps_f32_masters``).
- A bf16 Solver window and a W=2 bf16 trainer round on a narrow LRN net,
  unfused and under ``SPARKNET_FUSION=1``, held to the JAX bf16 Solver
  and trainer by their distance from a float64 run of the same step:
  the port's distance is at most twice the JAX package's plus
  ``FLOOR`` (2^-8, one bf16 rounding) of the float64 step's own size.
  bf16 rounds at other places in the two packages (the port's LRN
  widens, the JAX net's XLA LRN computes in bf16), so neither bit
  equality nor a fixed tolerance would say which is right; the float64
  run does.  The float64 run is the port's (its float64 parity with the
  JAX package is ``tests/test_torch_deep_nets.py``'s).
- The bf16 TEST view's scores, by the same criterion.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu import config as jconfig
from sparknet_tpu.ops import pallas_lrn, pallas_plp
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu.parallel import make_mesh, shard_leading
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch.ops import cuda_lrn, cuda_plp
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map

HP = (5, 1e-2, 0.75, 1.0)  # a normaliser that matters at unit inputs
SHAPES = [(2, 16, 13, 13), (1, 7, 11, 13)]
# one bf16 rounding of the float64 step's size: the floor of the
# float64-relative criterion
FLOOR = 2.0 ** -8
B, W, TAU = 4, 2, 2

NET = """
name: "narrow_lrn"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 4 dim: 3 dim: 15 dim: 15 } shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.3 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.01 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  inner_product_param { num_output: 4 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip1" bottom: "label" top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "ip1" bottom: "label"
  top: "accuracy" include { phase: TEST } }
"""
SOLVER = 'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.0005'


def _bf16(a):
    """numpy float32 -> (the JAX bf16 array, the port's bf16 tensor) of
    the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _within_ulp(got: torch.Tensor, want) -> None:
    """``got`` (bf16) within one bf16 ulp of ``want`` (JAX bf16): a bf16
    ulp is at most 2^-7 of the magnitude."""
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    ulp = np.maximum(np.abs(w), np.abs(g)) * 2.0 ** -7
    assert np.all(np.abs(g - w) <= np.maximum(ulp, 1e-30))


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * 3).astype(np.float32), rs.randn(*shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_lrn_bwd_bf16_plain_version_matches_the_pallas_kernel(shape):
    x, dy = _inputs(shape, 1)
    (jx, tx), (jdy, tdy) = _bf16(x), _bf16(dy)
    _, vjp = jax.vjp(lambda v: pallas_lrn.lrn_across_channels(v, *HP, True), jx)
    want = vjp(jdy)[0]
    assert want.dtype == jnp.bfloat16
    got = cuda_lrn.lrn_bwd(tx, tdy, *HP)
    _within_ulp(got, want)
    assert torch.equal(got, cuda_lrn.lrn_across_bwd_reference(
        tx.float(), tdy.float(), *HP).to(torch.bfloat16))


@pytest.mark.parametrize("shape", SHAPES)
def test_lrn_pool_bf16_plain_versions_match_the_pallas_kernels(shape):
    x, _ = _inputs(shape, 2)
    jx, tx = _bf16(x)
    ph, pw = cuda_plp.pooled_hw(*shape[2:])
    dp = np.random.RandomState(3).randn(shape[0], shape[1], ph, pw).astype(
        np.float32)
    jdp, tdp = _bf16(dp)
    y, vjp = jax.vjp(lambda v: pallas_plp.lrn_maxpool(v, *HP, True), jx)
    dx = vjp(jdp)[0]
    assert y.dtype == dx.dtype == jnp.bfloat16
    got_y = cuda_plp.lrn_pool_fwd(tx, *HP)
    got_dx = cuda_plp.lrn_pool_bwd(tx, tdp, *HP)
    _within_ulp(got_y, y)
    _within_ulp(got_dx, dx)
    assert torch.equal(got_y, cuda_plp.lrn_maxpool_reference(
        tx.float(), *HP).to(torch.bfloat16))
    assert torch.equal(got_dx, cuda_plp.lrn_maxpool_bwd_reference(
        tx.float(), tdp.float(), *HP).to(torch.bfloat16))


@pytest.mark.parametrize("fused", [False, True])
def test_autograd_ops_keep_bf16(fused):
    """``_LRNAcross`` and ``_LRNMaxPool`` on bf16 CPU tensors: outputs and
    gradients are bf16, each the bf16 plain version's."""
    x, _ = _inputs((2, 8, 9, 9), 4)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    op = cuda_plp.lrn_maxpool if fused else cuda_lrn.lrn_across_channels
    y = op(tx, *HP)
    g = torch.from_numpy(np.random.RandomState(5).randn(*y.shape).astype(
        np.float32)).to(torch.bfloat16)
    (dx,) = torch.autograd.grad(y, tx, g)
    assert y.dtype == dx.dtype == torch.bfloat16
    xd = tx.detach()
    if fused:
        assert torch.equal(y, cuda_plp.lrn_maxpool_bf16_reference(xd, *HP))
        assert torch.equal(dx, cuda_plp.lrn_maxpool_bwd_bf16_reference(xd, g, *HP))
    else:
        assert torch.equal(y, cuda_lrn.lrn_fwd_bf16_reference(xd, *HP))
        assert torch.equal(dx, cuda_lrn.lrn_bwd_bf16_reference(xd, g, *HP))


REGRESS_NET = """
name: "regress"
layer { name: "data" type: "HostData" top: "x" top: "y"
  java_data_param { shape { dim: 4 dim: 3 } shape { dim: 4 dim: 2 } } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "pred"
  inner_product_param { num_output: 2 weight_filler { type: "constant" value: 0.1 } } }
layer { name: "loss" type: "EuclideanLoss" bottom: "pred" bottom: "y" top: "loss" }
"""


def test_bfloat16_compute_keeps_f32_masters():
    """The JAX test of the same name, restated: five bf16 windows keep
    float32 parameters and history, the net computes in bf16, and the
    regression still learns."""
    sp = tconfig.parse_solver_prototxt('base_lr: 0.1 lr_policy: "fixed" momentum: 0.9')
    s = TSolver(sp, net_param=tconfig.parse_net_prototxt(REGRESS_NET),
                device="cpu", compute_dtype="bfloat16")
    assert s.net.compute_dtype == torch.bfloat16
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3).astype(np.float32)
    w_true = np.array([[1.0, -2.0, 0.5], [0.3, 0.8, -1.2]], np.float32)
    batch = {"x": np.stack([x] * 5), "y": np.stack([x @ w_true.T] * 5)}
    st = s.init_state(0)
    for _ in range(5):
        st, losses = s.step(st, batch)
    assert st.params["ip"][0].dtype == torch.float32  # master weights
    assert st.history["ip"][0].dtype == torch.float32
    out = s.net.apply(st.params, st.stats, {k: torch.from_numpy(v[0]) for k, v in
                                           batch.items()})
    assert out.blobs["pred"].dtype == torch.bfloat16
    assert out.loss.dtype == torch.float32
    assert float(losses[-1]) < 1.0


def test_gradients_reach_the_master_dtype():
    """The casts sit inside the graph: the bf16 net computes its blobs in
    bf16, and its gradients arrive in float32, the update's dtype, with
    no cast after the fact."""
    sp = tconfig.parse_solver_prototxt(SOLVER)
    s = TSolver(sp, net_param=tconfig.parse_net_prototxt(NET), device="cpu",
                compute_dtype="bfloat16")
    st = s.init_state(0)
    out = s.net.apply(st.params, st.stats, _batch(0))
    assert out.blobs["norm1"].dtype == out.blobs["ip1"].dtype == torch.bfloat16
    grads, loss, _ = s._grads(st.params, st.stats, _batch(0), 0)
    assert loss.dtype == torch.float32
    assert {g.dtype for g in tree_leaves(grads)} == {torch.float32}


def _batch(seed, lead=()):
    rs = np.random.RandomState(seed)
    return {"data": torch.from_numpy(rs.randn(*lead, B, 3, 15, 15).astype(np.float32)),
            "label": torch.from_numpy(rs.randint(0, 4, lead + (B,)).astype(
                np.float32))}


def _solvers(monkeypatch, fusion):
    monkeypatch.setenv("SPARKNET_FUSION", fusion)
    jsp, tsp = jconfig.parse_solver_prototxt(SOLVER), tconfig.parse_solver_prototxt(SOLVER)
    js = JSolver(jsp, net_param=jconfig.parse_net_prototxt(NET),
                 compute_dtype="bfloat16")
    ts = TSolver(tsp, net_param=tconfig.parse_net_prototxt(NET), device="cpu",
                 compute_dtype="bfloat16")
    t64 = TSolver(tsp, net_param=tconfig.parse_net_prototxt(NET), device="cpu")
    assert bool(ts.net._plp_fused) == (fusion == "1")
    return js, ts, t64


def _carried(js, ts):
    """The JAX init as the port's float32 state, and as float64."""
    jstate = js.init_state(0)
    params, stats = interop.net_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), ts.net,
        jax.tree_util.tree_map(np.asarray, jstate.stats))
    st = TrainState(params, stats, _init_history(ts.method, params),
                    torch.tensor(0))
    st64 = TrainState(*(tree_map(lambda t: t.double(), f)
                        for f in (params, stats)),
                      tree_map(lambda t: t.double(), st.history), torch.tensor(0))
    return jstate, st, st64


def _dist(leaves, ref) -> float:
    return float(np.sqrt(sum(float(((np.asarray(a, np.float64) - r) ** 2).sum())
                             for a, r in zip(leaves, ref))))


def _hold(port, jax_, ref, start, what):
    """The float64-relative criterion on flat parameter lists."""
    ref = [np.asarray(r, np.float64) for r in ref]
    step = _dist(start, ref)
    d_port, d_jax = _dist(port, ref), _dist(jax_, ref)
    assert step > 0, what
    assert d_port <= 2 * d_jax + FLOOR * step, (what, d_port, d_jax, step)
    return d_port, d_jax, step


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_bf16_solver_window_matches_the_jax_solver(monkeypatch, fusion):
    """A tau=2 window of the bf16 Solver on the narrow LRN net against the
    JAX bf16 Solver (fused: its Pallas kernels in interpret mode), by the
    distance of each from the float64 window."""
    js, ts, t64 = _solvers(monkeypatch, fusion)
    jstate, st, st64 = _carried(js, ts)
    batches = _batch(7, (TAU,))
    jstate, jl = js.step(jstate, {k: jnp.asarray(v.numpy()) for k, v in
                                  batches.items()})
    st, tl = ts.step(st, batches)
    st64, l64 = t64.step(st64, {k: v.double() for k, v in batches.items()})
    assert {t.dtype for t in tree_leaves(st.params)} == {torch.float32}
    assert {t.dtype for t in tree_leaves(st.history)} == {torch.float32}
    start = [t.numpy() for t in tree_leaves(_carried(js, ts)[1].params)]
    _hold([t.numpy() for t in tree_leaves(st.params)],
          jax.tree_util.tree_leaves(jstate.params),
          [t.numpy() for t in tree_leaves(st64.params)], start, "params")
    l64 = l64.numpy()
    assert np.all(np.abs(tl.numpy() - l64) <= 2 * np.abs(np.asarray(jl) - l64)
                  + FLOOR * np.abs(l64))


# three sibling convolutions (one horizontal-conv group in both
# packages), BatchNorm with its stats and a Scale: the layers whose bf16
# handling the nets share beside the LRN
HCONV_BN_NET = """
name: "hconv_bn"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 4 dim: 3 dim: 9 dim: 9 } shape { dim: 4 } } }
layer { name: "a" type: "Convolution" bottom: "data" top: "a"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "b" type: "Convolution" bottom: "data" top: "b"
  convolution_param { num_output: 6 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "c" type: "Convolution" bottom: "data" top: "c"
  convolution_param { num_output: 2 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.3 } } }
layer { name: "cat" type: "Concat" bottom: "a" bottom: "b" bottom: "c" top: "cat" }
layer { name: "bn" type: "BatchNorm" bottom: "cat" top: "cat" }
layer { name: "sc" type: "Scale" bottom: "cat" top: "cat"
  scale_param { bias_term: true } }
layer { name: "relu" type: "ReLU" bottom: "cat" top: "cat" }
layer { name: "ip" type: "InnerProduct" bottom: "cat" top: "ip"
  inner_product_param { num_output: 4 weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" top: "loss" }
"""


def test_bf16_hconv_and_batchnorm_window_matches_the_jax_solver():
    """A tau=2 bf16 window through a horizontal-conv group, BatchNorm
    (its running stats written back at float32) and Scale, against the
    JAX bf16 Solver by the float64 criterion; the stats too."""
    jsp, tsp = jconfig.parse_solver_prototxt(SOLVER), tconfig.parse_solver_prototxt(SOLVER)
    js = JSolver(jsp, net_param=jconfig.parse_net_prototxt(HCONV_BN_NET),
                 compute_dtype="bfloat16")
    ts = TSolver(tsp, net_param=tconfig.parse_net_prototxt(HCONV_BN_NET),
                 device="cpu", compute_dtype="bfloat16")
    t64 = TSolver(tsp, net_param=tconfig.parse_net_prototxt(HCONV_BN_NET),
                  device="cpu")
    assert ts.net.hconv_groups == [["a", "b", "c"]] and js.net._hconv_groups
    jstate, st, st64 = _carried(js, ts)
    start = [t.numpy() for t in tree_leaves(st.params)]
    stats0 = [t.numpy() for t in tree_leaves(st.stats)]
    rs = np.random.RandomState(12)
    batches = {"data": torch.from_numpy(rs.randn(TAU, B, 3, 9, 9).astype(np.float32)),
               "label": torch.from_numpy(rs.randint(0, 4, (TAU, B)).astype(np.float32))}
    jstate, _ = js.step(jstate, {k: jnp.asarray(v.numpy()) for k, v in batches.items()})
    st, _ = ts.step(st, batches)
    st64, _ = t64.step(st64, {k: v.double() for k, v in batches.items()})
    assert {t.dtype for t in tree_leaves(st.stats)} == {torch.float32}
    _hold([t.numpy() for t in tree_leaves(st.params)],
          jax.tree_util.tree_leaves(jstate.params),
          [t.numpy() for t in tree_leaves(st64.params)], start, "params")
    _hold([t.numpy() for t in tree_leaves(st.stats)],
          jax.tree_util.tree_leaves(jstate.stats),
          [t.numpy() for t in tree_leaves(st64.stats)], stats0, "stats")


@pytest.mark.parametrize("fusion", ["0", "1"])
def test_bf16_trainer_round_matches_the_jax_trainer(monkeypatch, fusion):
    """A W=2 bf16 averaging round (tau 2) against the JAX bf16 trainer,
    by the distance of each from the port's float64 round.  The JAX
    trainer runs unfused either way (its shard_map refuses a pallas_call
    output, ``tests/test_torch_imagenet.py``); the port's fused round
    runs the fused plain versions in bf16.  Then the bf16 TEST view's
    scores from the round's params, by the same criterion."""
    js, ts, t64 = _solvers(monkeypatch, fusion)
    monkeypatch.setenv("SPARKNET_FUSION", "0")
    js = JSolver(jconfig.parse_solver_prototxt(SOLVER),
                 net_param=jconfig.parse_net_prototxt(NET), compute_dtype="bfloat16")
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    jt, tt, tt64 = JTrainer(js, mesh), TTrainer(ts, W), TTrainer(t64, W)
    jstate = jt.init_state(seed=0)
    _, st, st64 = _carried(js, ts)
    start = [t.numpy() for t in tree_leaves(st.params)]
    st, st64 = tt.broadcast_state(st), tt64.broadcast_state(st64)
    data = _batch(8, (W, TAU))
    jstate, jl = jt.round(jstate, shard_leading({k: v.numpy() for k, v in
                                                 data.items()}, mesh))
    st, tl = tt.round(st, data)
    st64, l64 = tt64.round(st64, {k: v.double() for k, v in data.items()})
    assert {t.dtype for t in tree_leaves(st.params)} == {torch.float32}
    first = lambda leaves: [np.asarray(x)[0] for x in leaves]  # noqa: E731
    _hold(first(t.numpy() for t in tree_leaves(st.params)),
          first(jax.tree_util.tree_leaves(jstate.params)),
          first(t.numpy() for t in tree_leaves(st64.params)), start, "params")
    l64 = l64.numpy()
    assert np.all(np.abs(tl.numpy() - l64) <= 2 * np.abs(np.asarray(jl) - l64)
                  + FLOOR * np.abs(l64))

    # the TEST view computes in bf16 and scores as JAX's
    assert ts.test_net.compute_dtype == torch.bfloat16
    test = _batch(9, (W, 2))
    jscores = jt.test_and_store_result(jstate, shard_leading(
        {k: v.numpy() for k, v in test.items()}, mesh))
    tscores = tt.test_and_store_result(st, test)
    s64 = tt64.test_and_store_result(st64, {k: v.double() for k, v in test.items()})
    assert set(tscores) == set(jscores) == {"accuracy", "loss"}
    for name in tscores:
        assert abs(tscores[name] - s64[name]) <= (
            2 * abs(jscores[name] - s64[name]) + FLOOR * abs(s64[name])), name


def test_bf16_accuracy_keeps_labels_above_256():
    """Accuracy is exempt from the compute dtype, so a bf16 net scores a
    1,000-class label as the float32 net does (bf16 would round 999 to
    1000; the JAX net casts the label and misses it)."""
    text = """
name: "acc"
layer { name: "data" type: "HostData" top: "x" top: "label"
  java_data_param { shape { dim: 4 dim: 1000 } shape { dim: 4 } } }
layer { name: "scale" type: "Power" bottom: "x" top: "y" }
layer { name: "accuracy" type: "Accuracy" bottom: "y" bottom: "label" top: "accuracy" }
"""
    from sparknet_tpu_torch.net import TorchNet

    labels = np.array([999, 300, 257, 5], np.float32)
    x = np.zeros((4, 1000), np.float32)
    x[np.arange(4), labels.astype(int)] = 1.0
    batch = {"x": torch.from_numpy(x), "label": torch.from_numpy(labels)}
    for dtype in (None, "bfloat16"):
        net = TorchNet(tconfig.parse_net_prototxt(text), "TEST", compute_dtype=dtype)
        out = net.apply({}, {}, batch)
        assert float(out.blobs["accuracy"]) == 1.0, dtype


CURVE_BATCH, CURVE_ITERS, CURVE_TAU = 25, 200, 20


def _cifar_curve(solver_cls, make_batch, rng_of, dtype, x, y, **kw):
    from sparknet_tpu import models as jmodels
    from sparknet_tpu_torch import models as tmodels

    shapes = [(CURVE_BATCH, 3, 32, 32), (CURVE_BATCH,)]
    models, cfg = ((tmodels, tconfig) if solver_cls is TSolver
                   else (jmodels, jconfig))
    sp = models.load_model_solver("cifar10_full")
    netp = cfg.replace_data_layers(models.load_model("cifar10_full"), shapes,
                                   shapes)
    solver = solver_cls(sp, net_param=netp, compute_dtype=dtype, **kw)
    st = solver.init_state(seed=0)
    losses = []
    for r in range(CURVE_ITERS // CURVE_TAU):
        idx = [(r * CURVE_TAU + t) % len(x) for t in range(CURVE_TAU)]
        st, ls = solver.step(st, make_batch(np.stack([x[i] for i in idx]),
                                            np.stack([y[i] for i in idx])),
                             rng=rng_of(r))
        losses.extend(float(v) for v in np.asarray(ls, np.float64))
    return np.asarray(losses)


@pytest.mark.slow
def test_bf16_f32_curve_tails_part_as_the_jax_solvers(tmp_path):
    """The JAX slow test's cifar10_full curve (batch 25, 200 iterations,
    tau 20; ``tests/test_solver.py::test_bf16_f32_train_curve_equivalence_cifar``)
    through both packages on the CPU, bf16 and float32 from one init on
    the same minibatches.  Prints each package's head and tail windows
    and its bf16/float32 tail gap; holds the port to the JAX test's own
    asserts, and its float32 curve's first half to the JAX package's."""
    from sparknet_tpu.data import CifarLoader
    from sparknet_tpu_torch.utils import rngs

    CifarLoader.write_synthetic(str(tmp_path), num_train=CURVE_BATCH * 10,
                                num_test=CURVE_BATCH)
    x, y = CifarLoader(str(tmp_path), seed=0).minibatches(CURVE_BATCH,
                                                          train=True)
    curves = {}
    for dtype in (None, "bfloat16"):
        curves["jax", dtype] = _cifar_curve(
            JSolver, lambda d, l: {"data": jnp.asarray(d), "label": jnp.asarray(l)},
            jax.random.PRNGKey, dtype, x, y)
        curves["port", dtype] = _cifar_curve(
            TSolver, lambda d, l: {"data": torch.from_numpy(d),
                                   "label": torch.from_numpy(l)},
            rngs.train_key, dtype, x, y, device="cpu")
    t = CURVE_TAU
    half = CURVE_ITERS // t // 2
    for pkg in ("jax", "port"):
        f32, b16 = curves[pkg, None], curves[pkg, "bfloat16"]
        head32, tail32 = f32[:t].mean(), f32[-t:].mean()
        head16, tail16 = b16[:t].mean(), b16[-t:].mean()
        first = max(abs(b16[w * t:(w + 1) * t].mean() - f32[w * t:(w + 1) * t].mean())
                    / f32[w * t:(w + 1) * t].mean() for w in range(half))
        print(f"{pkg}: float32 head {head32:.6f} tail {tail32:.6f}; bf16 head "
              f"{head16:.6f} tail {tail16:.6f}; tails "
              f"{abs(tail16 - tail32) / tail32:.2%} apart; first-half windows "
              f"at most {first:.2%} apart; windows float32 "
              + " ".join(f"{f32[w * t:(w + 1) * t].mean():.4f}"
                         for w in range(CURVE_ITERS // t))
              + "; bf16 " + " ".join(f"{b16[w * t:(w + 1) * t].mean():.4f}"
                                     for w in range(CURVE_ITERS // t)))
        if pkg == "port":  # the JAX test's asserts
            assert tail32 < 0.8 * head32 and tail16 < 0.8 * head16
            assert tail16 < 1.25 * tail32 + 0.05
            assert first < 0.10
    j, p = curves["jax", None], curves["port", None]
    gaps = [abs(p[w * t:(w + 1) * t].mean() - j[w * t:(w + 1) * t].mean())
            / j[w * t:(w + 1) * t].mean() for w in range(half)]
    print(f"float32 port vs JAX: first-half windows at most {max(gaps):.2%} apart")
    assert max(gaps) < 0.10
