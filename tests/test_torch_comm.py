"""The port's comm plane against the JAX package's.

Two layers:

- each plain version of ``ops/cuda_comm.py`` (what CPU tensors run, and
  what the CUDA kernels are held to bit for bit on the card) against the
  JAX package's Pallas kernels ``pallas_comm.fused_*`` in interpret
  mode, for fp32/bf16/int8 with the error readout, a NaN leaf, an
  all-zero leaf and a masked worker.  The target is bitwise: q, scales,
  residuals, params and anchors are compared with ``array_equal`` (NaN
  positions must match; bf16 NaN payloads are not compared).  The
  readout's max is exact, its sums rtol 1e-5 (summed in another order).
- a chunk of more leaves than one launch takes (33-131; ResNet-50's
  last chunk holds over 100) through the wrapper's per-group launches,
  bit for bit against one chain over the chunk, and ResNet-50's chunk
  slices against the JAX plane's.
- ``ParameterAveragingTrainer`` against the JAX trainer on the
  ``tests/test_parallel.py`` net at dp=4 for 3 rounds from carried init:
  none/fp32 within rtol 2e-5, atol 1e-6 (``test_comm.py:92``), bf16/int8
  within 5e-3 (``test_comm.py:107``), with and without overlap and with
  a dead worker; every slot equal after a barriered round.  Then one
  cifar10_full round at W=2, tau=1, batch 100 from carried init, losses
  and params within rtol 1e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu.ops import pallas_comm
from sparknet_tpu.parallel import (
    ParameterAveragingTrainer as JTrainer,
    make_mesh,
    shard_leading,
)
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import config as tconfig
from sparknet_tpu_torch import interop
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.obs.metrics import TrainingMetrics
from sparknet_tpu_torch.ops import cuda_comm
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.utils.tree import tree_leaves

from tests.test_parallel import NET, _data, _solver

W = 4
SHAPES = ((3, 5), (7,), (2, 2, 4))


def _leaves(seed, shapes=SHAPES, nan=False, zero=False):
    rs = np.random.RandomState(seed)
    out = [rs.randn(W, *s).astype(np.float32) for s in shapes]
    if nan:
        out[0][1, 2, 3] = np.nan  # worker 1 poisoned in leaf 0
    if zero:
        out[2][:] = 0.0
    return out


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy()
        w = want.view(np.int16)
        gn = np.isnan(got.float().numpy())
        wn = np.isnan(want.astype(np.float32))
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(g[~gn], w[~wn])
        return
    g = got.numpy()
    assert g.dtype == want.dtype, (g.dtype, want.dtype)
    np.testing.assert_array_equal(g, want)  # NaNs must sit in the same places


@pytest.mark.parametrize(
    "modes",
    [("fp32",) * 3, ("bf16",) * 3, ("int8",) * 3, ("int8", "fp32", "bf16")],
    ids=["fp32", "bf16", "int8", "mixed"],
)
@pytest.mark.parametrize("with_err", [False, True], ids=["", "err"])
@pytest.mark.parametrize("case", ["plain", "nan", "zero"])
def test_encode_matches_pallas_bitwise(modes, with_err, case):
    x = _leaves(0, nan=case == "nan", zero=case == "zero")
    a = _leaves(1, zero=case == "zero")
    r = _leaves(2, zero=case == "zero")
    jq, js, jr, jerr = pallas_comm.fused_encode(
        _j(x), _j(a), _j(r), modes, with_err, True
    )
    tq, ts, tr, terr = cuda_comm.encode(_t(x), _t(a), _t(r), modes, with_err)
    for got, want in zip(tq, jq):
        _bits_equal(got, want)
    for got, want in zip(ts, js):
        _bits_equal(got, want)
    for got, want in zip(tr, jr):
        _bits_equal(got, want)
    if case == "zero":
        assert float(ts[2].abs().max()) in (0.0, 1.0)
        assert not tr[2].any()
    if not with_err:
        assert terr is None and jerr is None
        return
    jerr = np.asarray(jerr)
    np.testing.assert_array_equal(terr[:, 0].numpy(), jerr[:, 0])
    np.testing.assert_allclose(terr[:, 1:].numpy(), jerr[:, 1:], rtol=1e-5)


def test_int8_scale_of_an_all_zero_leaf_is_one():
    zero = [np.zeros((W, 4, 4), np.float32)]
    q, s, r, _ = cuda_comm.encode(_t(zero), _t(zero), _t(zero), ("int8",), False)
    assert torch.equal(s[0], torch.ones(W)) and not q[0].any() and not r[0].any()
    q, s, _, _ = cuda_comm.encode(_t(zero), _t(zero), _t(zero), ("bf16",), False)
    assert torch.equal(s[0], torch.zeros(W))


@pytest.mark.parametrize(
    "alive,denom0",
    [([1, 1, 1, 1], 4.0), ([1, 0, 1, 1], 3.0), ([0, 0, 0, 0], 0.0)],
    ids=["all", "masked", "none_alive"],
)
def test_apply_barriered_matches_pallas_bitwise(alive, denom0):
    x, a, r = _leaves(3), _leaves(4), _leaves(5)
    means = [m[0] for m in _leaves(6)]
    alive_np = np.asarray(alive, np.float32)
    jx, jr = pallas_comm.fused_apply_barriered(
        _j(x), _j(a), _j(means), _j(r), jnp.asarray(alive_np),
        jnp.float32(denom0), True,
    )
    tx, tr = cuda_comm.apply_barriered(
        _t(x), _t(a), _t(means), _t(r), torch.from_numpy(alive_np),
        torch.tensor(denom0),
    )
    for got, want in zip(tx + tr, jx + jr):
        _bits_equal(got, want)
    if alive == [1, 0, 1, 1]:
        assert not tr[0][1].any() and tr[0][0].any()


@pytest.mark.parametrize("modes", [("fp32",) * 3, ("bf16",) * 3, ("int8",) * 3,
                                   ("int8", "fp32", "bf16")],
                         ids=["fp32", "bf16", "int8", "mixed"])
def test_apply_correction_matches_pallas_bitwise(modes):
    x, a = _leaves(7), _leaves(8)
    means = [m[0] for m in _leaves(9)]
    jq, js, _, _ = pallas_comm.fused_encode(
        _j(_leaves(10)), _j(_leaves(11)), _j(_leaves(12)), modes, False, True
    )
    jx, ja = pallas_comm.fused_apply_correction(
        _j(x), _j(a), jq, js, _j(means), modes, True
    )
    tq = tuple(
        torch.from_numpy(np.array(q).view(np.int16)).view(torch.bfloat16)
        if m == "bf16" else torch.from_numpy(np.array(q))
        for q, m in zip(jq, modes)
    )
    tx, ta = cuda_comm.apply_correction(
        _t(x), _t(a), tq, _t(js), _t(means), modes
    )
    for got, want in zip(tx + ta, jx + ja):
        _bits_equal(got, want)


# a leaf set with one slice of 300,001 floats a worker, more than any one
# tile of the kernels' tile map (csrc/comm_epilogue.cu), and worker slices
# that start off 16 bytes
LARGE_SHAPES = ((3, 5), (300_001,), (7,))


@pytest.mark.parametrize("modes", [("fp32",) * 3, ("bf16",) * 3, ("int8",) * 3],
                         ids=["fp32", "bf16", "int8"])
def test_encode_matches_pallas_bitwise_on_a_large_leaf(modes):
    x = _leaves(20, LARGE_SHAPES, nan=True)
    a, r = _leaves(21, LARGE_SHAPES), _leaves(22, LARGE_SHAPES)
    r = [t * np.float32(1e-3) for t in r]
    jq, js, jr, jerr = pallas_comm.fused_encode(
        _j(x), _j(a), _j(r), modes, True, True
    )
    tq, ts, tr, terr = cuda_comm.encode(_t(x), _t(a), _t(r), modes, True)
    for got, want in zip(tq + ts + tr, jq + js + jr):
        _bits_equal(got, want)
    jerr = np.asarray(jerr)
    np.testing.assert_array_equal(terr[:, 0].numpy(), jerr[:, 0])
    np.testing.assert_allclose(terr[:, 1:].numpy(), jerr[:, 1:], rtol=1e-5)


@pytest.mark.parametrize(
    "alive,denom0",
    [([1, 1, 1, 1], 4.0), ([1, 0, 1, 1], 3.0), ([0, 0, 0, 0], 0.0)],
    ids=["all", "masked", "none_alive"],
)
def test_apply_barriered_matches_pallas_bitwise_on_a_large_leaf(alive, denom0):
    x, a, r = (_leaves(s, LARGE_SHAPES) for s in (23, 24, 25))
    means = [m[0] for m in _leaves(26, LARGE_SHAPES)]
    alive_np = np.asarray(alive, np.float32)
    jx, jr = pallas_comm.fused_apply_barriered(
        _j(x), _j(a), _j(means), _j(r), jnp.asarray(alive_np),
        jnp.float32(denom0), True,
    )
    tx, tr = cuda_comm.apply_barriered(
        _t(x), _t(a), _t(means), _t(r), torch.from_numpy(alive_np),
        torch.tensor(denom0),
    )
    for got, want in zip(tx + tr, jx + jr):
        _bits_equal(got, want)


@pytest.mark.parametrize("modes", [("fp32",) * 3, ("bf16",) * 3, ("int8",) * 3],
                         ids=["fp32", "bf16", "int8"])
def test_apply_correction_matches_pallas_bitwise_on_a_large_leaf(modes):
    x, a = _leaves(27, LARGE_SHAPES), _leaves(28, LARGE_SHAPES)
    means = [m[0] for m in _leaves(29, LARGE_SHAPES)]
    jq, js, _, _ = pallas_comm.fused_encode(
        _j(_leaves(30, LARGE_SHAPES)), _j(_leaves(31, LARGE_SHAPES)),
        _j(_leaves(32, LARGE_SHAPES)), modes, False, True
    )
    jx, ja = pallas_comm.fused_apply_correction(
        _j(x), _j(a), jq, js, _j(means), modes, True
    )
    tq = tuple(
        torch.from_numpy(np.array(q).view(np.int16)).view(torch.bfloat16)
        if m == "bf16" else torch.from_numpy(np.array(q))
        for q, m in zip(jq, modes)
    )
    tx, ta = cuda_comm.apply_correction(
        _t(x), _t(a), tq, _t(js), _t(means), modes
    )
    for got, want in zip(tx + ta, jx + ja):
        _bits_equal(got, want)


def test_cpu_wrappers_launch_nothing():
    before = dict(cuda_comm.LAUNCHES)
    x = _leaves(0)
    cuda_comm.encode(_t(x), _t(x), _t(x), ("int8",) * 3, True)
    assert cuda_comm.LAUNCHES == before


# ----------------------------------------------------------------------
# chunks of more leaves than one launch takes (ResNet-50's)
# ----------------------------------------------------------------------
def _many_leaves(n, seed):
    """``n`` worker-stacked leaves of 1-3 small dims (shapes from ``n``,
    values from ``seed``)."""
    shapes = np.random.RandomState(n)
    shapes = [(W,) + tuple(shapes.randint(1, 6, shapes.randint(1, 4)))
              for _ in range(n)]
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("n", [33, 70, 131])
def test_leaf_groups_of_a_large_chunk_equal_one_chain_bitwise(n):
    """A chunk of ``n`` > MAX_LEAVES leaves, run as the card runs it —
    one launch a group of at most 32 consecutive leaves, outputs
    concatenated in leaf order (``cuda_comm._per_group``, each group
    taking the plain version here) — equals the unfused chain over the
    whole chunk bit for bit: q, scales, residuals, the error readout,
    both applies.  ``ceil(n / 32)`` launches."""
    x, a, r = (_many_leaves(n, s) for s in (1, 2, 3))
    means = [t[0] for t in _many_leaves(n, 4)]
    modes = tuple(("int8", "bf16", "fp32")[i % 3] for i in range(n))
    groups = cuda_comm._groups(n)
    assert len(groups) == -(-n // cuda_comm.MAX_LEAVES)
    assert [g.start for g in groups] == list(range(0, n, 32))

    def launch(*cols):
        q, s, nr, err = cuda_comm.encode_reference(*cols, True)
        return q, s, nr, (err,)

    got = cuda_comm._per_group(launch, n, x, a, r, modes)
    want = cuda_comm.encode_reference(x, a, r, modes, True)
    for g, w in zip(got[0] + got[1] + got[2], want[0] + want[1] + want[2]):
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the readout: per group, combined over the groups as the wrapper does
    err = torch.stack([e for e in got[3]])  # (groups, W, 3)
    combined = torch.stack([err[..., 0].amax(0), err[..., 1].sum(0),
                            err[..., 2].sum(0)], dim=1)
    assert torch.equal(combined[:, 0], want[3][:, 0])
    np.testing.assert_allclose(combined[:, 1:], want[3][:, 1:], rtol=1e-5)
    alive, d0 = torch.tensor([1.0, 0.0, 1.0, 1.0]), torch.tensor(3.0)
    got = cuda_comm._per_group(
        lambda *c: cuda_comm.apply_barriered_reference(*c, alive, d0), n,
        x, a, means, r)
    want = cuda_comm.apply_barriered_reference(x, a, means, r, alive, d0)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    q, s = cuda_comm.encode_reference(x, a, r, modes, False)[:2]
    got = cuda_comm._per_group(cuda_comm.apply_correction_reference, n,
                               x, a, q, s, means, modes)
    want = cuda_comm.apply_correction_reference(x, a, q, s, means, modes)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)


def test_resnet50_chunks_equal_jax():
    """The comm plane's chunking of ResNet-50's 320 comm leaves (161
    learnable, then 159 BatchNorm stat blobs) at W=2 equals the JAX
    plane's: byte-balanced ``min(4, leaves)`` slices, the last one well
    over 32 leaves (the stats are small and come last)."""
    from sparknet_tpu.solver import TrainState as JTrainState

    netp = tmodels.load_model("resnet50", batch=2, image=224)
    tsolver = TSolver(tconfig.parse_solver_prototxt("base_lr: 0.1"),
                      net_param=netp, device="cpu")
    meta = {c: {k: [torch.empty((2,) + s, device="meta") for s in v]
                for k, v in tsolver.net.blob_layout(c).items()}
            for c in ("params", "stats")}
    state = TrainState(meta["params"], meta["stats"], None, None)
    leaves, chunks = TTrainer(tsolver, 2, compress="int8")._comm.plan(state)
    assert len(leaves) == 320
    jsolver = JSolver(jconfig.parse_solver_prototxt("base_lr: 0.1"),
                      net_param=jmodels.load_model("resnet50", batch=2,
                                                   image=224))
    jt = JTrainer(jsolver, make_mesh({"dp": 2}, devices=jax.devices()[:2]),
                  compress="int8")
    shapes = {c: {k: [jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32)
                      for t in v] for k, v in meta[c].items()}
              for c in ("params", "stats")}
    jt._comm._setup(JTrainState(shapes["params"], shapes["stats"], None, None))
    assert chunks == jt._comm._chunk_slices
    assert len(chunks) == 4 and chunks[-1].stop - chunks[-1].start > 32
    groups = sum(-(-(sl.stop - sl.start) // cuda_comm.MAX_LEAVES)
                 for sl in chunks)
    assert groups > len(chunks)


# ----------------------------------------------------------------------
# the trainer against the JAX trainer
# ----------------------------------------------------------------------
def _tsolver():
    sp = tconfig.parse_solver_prototxt(
        'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9'
    )
    return TSolver(sp, net_param=tconfig.parse_net_prototxt(NET), device="cpu")


def _carry(jstate, tsolver):
    params = {k: [np.asarray(b[0]) for b in v] for k, v in jstate.params.items()}
    tparams, tstats = interop.net_params_from_jax(params, tsolver.net)
    return TrainState(tparams, tstats, _init_history(tsolver.method, tparams),
                      torch.tensor(0))


def _both(rounds, live_masks=None, **kw):
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    jt = JTrainer(_solver(), mesh, **kw)
    ts = _tsolver()
    metrics = TrainingMetrics()
    tt = TTrainer(ts, W, metrics=metrics, **kw)
    jstate = jt.init_state(seed=0)
    tstate = tt.broadcast_state(_carry(jstate, ts))
    data = _data(W, 3, seed=5)
    jlosses, tlosses = [], []
    for r in range(rounds):
        mask = None if live_masks is None else live_masks[r]
        jstate, jl = jt.round(jstate, shard_leading(data, mesh), live_mask=mask)
        tstate, tl = tt.round(
            tstate, {k: torch.from_numpy(v) for k, v in data.items()},
            live_mask=mask,
        )
        jlosses.append(np.asarray(jl))
        tlosses.append(tl.numpy())
    jstate = jt.finalize(jstate)
    tstate = tt.finalize(tstate)
    return jt, tt, jstate, tstate, jlosses, tlosses, metrics


@pytest.mark.parametrize(
    "compress,overlap,masks",
    [
        ("none", False, None), ("fp32", False, None), ("bf16", False, None),
        ("int8", False, None), ("fp32", True, None), ("bf16", True, None),
        ("int8", True, None),
        ("none", False, "dead"), ("int8", False, "dead"), ("bf16", True, "dead"),
    ],
)
def test_trainer_matches_jax(compress, overlap, masks):
    live = None
    if masks == "dead":
        dead = np.array([1, 1, 0, 1], np.float32)
        live = [np.ones(W, np.float32), dead, dead]
    jt, tt, js, ts, jl, tl, metrics = _both(
        3, live, compress=compress, overlap_avg=overlap
    )
    tight = compress in ("none", "fp32")
    for got, want in zip(tree_leaves(ts.params), jax.tree_util.tree_leaves(js.params)):
        if tight:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-5, atol=1e-6)
        else:
            assert np.max(np.abs(got.numpy() - np.asarray(want))) < 5e-3
    for got, want in zip(tl, jl):
        np.testing.assert_allclose(got, want, rtol=2e-5 if tight else 5e-3)
    if not overlap:  # barriered rounds end with every slot on the consensus
        for leaf in tree_leaves(ts.params):
            for w in range(1, W):
                assert torch.equal(leaf[w], leaf[0])
    if compress != "none" or overlap:
        assert tt._comm is not None and jt._comm is not None
        assert tt._comm.chunk_slices == jt._comm._chunk_slices
        assert metrics.collective_bytes.labels(tt._comm.compress).value == \
            3 * tt._comm.payload_bytes_per_round
    assert metrics.rounds.value == 3 and metrics.iters.value == 9


def test_overlap_leaves_pending_until_finalize():
    ts = _tsolver()
    tt = TTrainer(ts, W, compress="bf16", overlap_avg=True)
    st = tt.init_state(0)
    data = {k: torch.from_numpy(v) for k, v in _data(W, 3, seed=1).items()}
    st, _ = tt.round(st, data)
    assert tt._comm.has_pending
    st = tt.finalize(st)
    assert not tt._comm.has_pending
    # each slot is anchor + mean + its own error-feedback residual
    for leaf, resid in zip(tree_leaves(st.params), tt._comm._resid):
        assert resid.abs().max() > 0
        for w in range(1, W):
            torch.testing.assert_close(leaf[w] - resid[w], leaf[0] - resid[0],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_cifar10_full_round_matches_jax(compress):
    """One cifar10_full round at W=2, tau=1, batch 100 (the net's own
    batch) from carried init: the round's losses and params within rtol
    1e-5.  Under int8 a parameter may also sit one quantization step
    away: a local step that rounds its last bit otherwise can move an
    element across a rounding boundary of the int8 grid."""
    w = 2
    mesh = make_mesh({"dp": w}, devices=jax.devices()[:w])
    jsolver = JSolver(jmodels.load_model_solver("cifar10_full"))
    tsolver = TSolver(tmodels.load_model_solver("cifar10_full"), device="cpu")
    jt = JTrainer(jsolver, mesh, compress=compress)
    tt = TTrainer(tsolver, w, compress=compress)
    jstate = jt.init_state(seed=0)
    init = [np.asarray(x[0]) for x in jax.tree_util.tree_leaves(jstate.params)]
    tstate = tt.broadcast_state(_carry(jstate, tsolver))
    rs = np.random.RandomState(0)
    data = {
        "data": (rs.randint(0, 255, (w, 1, 100, 3, 32, 32)) - 120).astype(np.float32),
        "label": rs.randint(0, 10, (w, 1, 100)).astype(np.float32),
    }
    jstate, jl = jt.round(jstate, shard_leading(data, mesh))
    tstate, tl = tt.round(tstate, {k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for got, want, x0 in zip(tree_leaves(tstate.params),
                             jax.tree_util.tree_leaves(jstate.params), init):
        want = np.asarray(want)
        atol = 1e-6 * float(np.abs(want).max())
        if compress == "int8":  # one step of the int8 grid of the deltas
            atol += 2.0 * float(np.abs(want - x0).max()) / 127
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("compress,overlap", [("none", False), ("int8", False),
                                              ("bf16", True)])
def test_round_emits_the_phase_spans(compress, overlap):
    """``average`` wraps each round, ``execute`` its local steps; the comm
    plane adds ``quantize``, one ``allreduce`` per chunk and
    ``dequantize`` (barriered, correction or finalize)."""
    from sparknet_tpu_torch.obs import trace

    tt = TTrainer(_tsolver(), W, compress=compress, overlap_avg=overlap)
    st = tt.init_state(0)
    data = {k: torch.from_numpy(v) for k, v in _data(W, 3, seed=2).items()}
    tracer = trace.install_tracer(trace.Tracer())
    try:
        for _ in range(2):
            st, _ = tt.round(st, data)
        tt.finalize(st)
    finally:
        trace.uninstall_tracer()
    spans = [e for e in tracer.events() if e.get("ph") == "X"]
    names = [e["name"] for e in spans]
    assert names.count("average") == 2
    if compress == "none" and not overlap:
        assert set(names) == {"average", "execute"}
        return
    chunks = len(tt._comm.chunk_slices)
    assert names.count("quantize") == 2
    assert names.count("allreduce") == 2 * chunks
    stages = [e["args"]["stage"] for e in spans if e["name"] == "dequantize"]
    assert stages == (["correction", "finalize"] if overlap
                      else ["barriered", "barriered"])
    # overlap splits the second round's local steps around the correction
    assert names.count("execute") == (3 if overlap else 2)


def test_training_series_and_quant_readout():
    """The training series under the JAX package's names; the int8
    readout's max |err| is exactly the largest error-feedback residual
    (every worker live, so no residual was reset), landed one round late
    (or at finalize) as the JAX plane does."""
    metrics = TrainingMetrics()
    tt = TTrainer(_tsolver(), W, compress="int8", metrics=metrics)
    st = tt.init_state(0)
    data = {k: torch.from_numpy(v) for k, v in _data(W, 3, seed=3).items()}
    st, _ = tt.round(st, data)
    assert metrics.quant_error.labels("int8").value == 0.0  # not landed yet
    tt.finalize(st)
    resid_max = max(float(r.abs().max()) for r in tt._comm._resid)
    assert resid_max > 0
    assert metrics.quant_error.labels("int8").value == resid_max
    assert 0.0 < metrics.quant_snr_db.labels("int8").value < 300.0
    text = metrics.registry.render()
    for name in ("sparknet_rounds_total", "sparknet_iters_total",
                 "sparknet_collective_bytes_total", "sparknet_quant_error_max_abs",
                 "sparknet_quant_snr_db", "sparknet_kernel_fused_chunks_total"):
        assert f"# TYPE {name} " in text
    assert 'sparknet_collective_bytes_total{compress="int8"}' in text
