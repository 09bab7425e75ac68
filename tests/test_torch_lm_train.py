"""The port's LM training path against the JAX package's, on the CPU.

At the JAX LM tests' size (dim 32, depth 2, heads 2, T 32, B 4, tau 2,
DP 2; ``tests/test_lm.py``), with the JAX LM's seeded weights carried
across by ``interop.lm_params_from_jax``:

- the loss and every gradient of ``TransformerLMNet.loss_fn`` against
  ``jax.value_and_grad`` of the JAX LM, with attention "flash" (Pallas
  in interpret mode there, the port's autograd Function over the plain
  K1/K3/K4 versions here) and "dense": loss within 1e-5, grads within
  5e-5 (float32, summed in different orders);
- tau solver steps, then two rounds of the W=2 averaging trainer,
  against the JAX solver and ``ParameterAveragingTrainer`` on the
  2-device CPU mesh, both at their default attention ("auto": the JAX
  package's dense reference off-TPU, the port's flash wrappers here):
  losses and params within 5e-4, the JAX package's LM associativity
  tolerance (``bench.py`` BENCH_LM_TOL);
- the trainer and the comm plane over the depth-4 LM's 53 blobs;
- ``lm_app.main`` and ``cli train --lm`` end to end on the CPU, the
  flags not yet ported refusing and the telemetry flags running.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sparknet_tpu.config import parse_solver_prototxt as j_parse_solver
from sparknet_tpu.models.transformer_lm import TransformerLM as JaxLM
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch import models as tmodels
from sparknet_tpu_torch.apps import lm_app
from sparknet_tpu_torch.config import parse_solver_prototxt as t_parse_solver
from sparknet_tpu_torch.data import stack_windows
from sparknet_tpu_torch.data.text import TextWindowSampler, load_corpus
from sparknet_tpu_torch.data.text import write_synthetic_corpus
from sparknet_tpu_torch.interop import lm_params_from_jax
from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.parallel import ParameterAveragingTrainer as TTrainer
from sparknet_tpu_torch.solver import Solver as TSolver
from sparknet_tpu_torch.solver import TrainState, _init_history
from sparknet_tpu_torch.tools import cli
from sparknet_tpu_torch.utils.tree import tree_leaves

SOLVER_TXT = (
    'base_lr: 0.1 lr_policy: "fixed" momentum: 0.9 '
    "weight_decay: 0.0001 average_loss: 20"
)
GEOM = dict(dim=32, depth=2, heads=2, seq_len=32)
T, B, TAU, DP = 32, 4, 2, 2
LOSS_TOL, GRAD_TOL, TRAJ_TOL = 1e-5, 5e-5, 5e-4
APP = ["--device", "cpu", "--dim", "32", "--depth", "2", "--heads", "2",
       "--seq_len", "32", "--batch", "4", "--tau", "2", "--workers", "2"]


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_synthetic_corpus(str(d), num_docs=4, words_per_doc=200, seed=0)
    return load_corpus(str(d))


def _jax_params(jlm, seed=0):
    params, _ = jlm.init(seed)
    return {g: [np.asarray(b) for b in bs] for g, bs in params.items()}


def _t_batch(win):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in win.items()}


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_loss_and_grads_match_jax(docs, attention):
    jlm = JaxLM(**GEOM, attention=attention)
    params = _jax_params(jlm)
    tlm = TransformerLMNet(**GEOM, attention=attention)
    tparams = lm_params_from_jax(params, tlm)
    batch = TextWindowSampler(docs, T, B, seed=2).window_at(0)

    def jloss(p):
        return jlm.loss_fn(p, {}, batch)[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, params))
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tca.reset_launch_counts()
    loss, (aux, stats) = tlm.loss_fn(tparams, {}, _t_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert stats == {} and tuple(aux["logits"].shape) == (B, T, 256)
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=GRAD_TOL)
    assert all(v == 0 for v in tca.LAUNCHES.values())  # CPU: plain versions


def test_net_protocol_matches_jax_and_the_serving_module():
    jlm = JaxLM(**GEOM)
    tlm = tmodels.build_transformer_lm(**GEOM)
    assert isinstance(tlm, TransformerLMNet)
    assert tlm._blob_plan() == jlm._blob_plan()
    assert tlm.num_params() == jlm.num_params()
    assert tlm.param_multipliers() == jlm.param_multipliers()
    assert tuple(tlm.feed_blobs) == tuple(jlm.feed_blobs)
    # the net's seeded init draws the serving module's weights
    from sparknet_tpu_torch.models.transformer_lm import TransformerLM

    params, stats = tlm.init(3, torch.device("cpu"))
    module = TransformerLM(**GEOM).init(3)
    assert stats == {}
    for group, blobs in module.group_params().items():
        for got, want in zip(params[group], blobs):
            assert torch.equal(got, want.detach())
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, T)))
    torch.testing.assert_close(tlm.forward_logits(params, toks),
                               module.forward_logits(toks), rtol=0, atol=0)
    with pytest.raises(ValueError, match="attention"):
        TransformerLMNet(**GEOM, attention="ring")
    # the sequence ring is ported: sp=2 builds, a ragged split refuses
    assert TransformerLMNet(**GEOM, sp_size=2).local_seq == GEOM["seq_len"] // 2
    with pytest.raises(ValueError, match="not divisible by sp"):
        TransformerLMNet(**GEOM, sp_size=3)
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(_jax_params(jlm), TransformerLMNet(**dict(GEOM, dim=64)))


def test_solver_takes_a_net_object():
    tlm = TransformerLMNet(**GEOM)
    solver = TSolver(t_parse_solver(SOLVER_TXT), net=tlm, device="cpu")
    assert solver.net is tlm
    with pytest.raises(ValueError, match="net object"):
        solver.test_net
    with pytest.raises(ValueError, match="not both"):
        TSolver(t_parse_solver(SOLVER_TXT), net=tlm,
                net_param=tmodels.load_model("cifar10_full"), device="cpu")


def _carry(jparams, tlm, method):
    tparams = lm_params_from_jax(jparams, tlm)
    return TrainState(tparams, {}, _init_history(method, tparams),
                      torch.tensor(0))


def test_solver_steps_then_trainer_rounds_match_jax(docs):
    """tau solver steps from one carried init, then two W=2 rounds."""
    jlm, tlm = JaxLM(**GEOM), TransformerLMNet(**GEOM)
    jsolver = JSolver(j_parse_solver(SOLVER_TXT), net=jlm)
    tsolver = TSolver(t_parse_solver(SOLVER_TXT), net=tlm, device="cpu")
    sampler = TextWindowSampler(docs, T, B, seed=0)

    jstate = jsolver.init_state(seed=0)
    tstate = _carry(jax.tree_util.tree_map(np.asarray, jstate.params), tlm,
                    tsolver.method)
    for r in range(2):
        win = sampler.window_for_round(r, TAU)
        jstate, jl = jsolver.step(jstate, win)
        tstate, tl = tsolver._step_tau(tstate, _t_batch(win))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TRAJ_TOL)
    for got, want in zip(tree_leaves(tstate.params),
                         jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_TOL)

    mesh = make_mesh({"dp": DP}, devices=jax.devices()[:DP])
    jt = JTrainer(JSolver(j_parse_solver(SOLVER_TXT), net=jlm), mesh)
    tt = TTrainer(TSolver(t_parse_solver(SOLVER_TXT), net=tlm, device="cpu"), DP)
    jstate = jt.init_state(seed=0)
    jparams = {g: [np.asarray(b)[0] for b in bs] for g, bs in jstate.params.items()}
    tstate = tt.broadcast_state(_carry(jparams, tlm, tt.solver.method))
    samplers = [sampler.for_worker(w) for w in range(DP)]
    shard = NamedSharding(mesh, P("dp"))
    for r in range(2):
        host = stack_windows([s.window_for_round(r, TAU) for s in samplers])
        jstate, jl = jt.round(jstate, jax.device_put(host, {k: shard for k in host}),
                              round_index=r)
        tstate, tl = tt.round(tstate, _t_batch(host), round_index=r)
        assert tuple(tl.shape) == (DP, TAU)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TRAJ_TOL)
    for got, want in zip(tree_leaves(tstate.params),
                         jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_TOL)


@pytest.mark.parametrize("compress,overlap", [("none", False), ("int8", False),
                                              ("bf16", True)])
def test_trainer_and_comm_plane_take_the_depth4_lm(docs, compress, overlap):
    """The W-stacked trainer and the comm plane over the LM's params as
    they are: 53 blobs at depth 4, against the JAX trainer with the same
    compression (one round; under compression a parameter may sit one
    quantization step away, as ``test_torch_comm`` allows)."""
    geom = dict(dim=32, depth=4, heads=2, seq_len=16)
    jlm, tlm = JaxLM(**geom), TransformerLMNet(**geom)
    mesh = make_mesh({"dp": DP}, devices=jax.devices()[:DP])
    jt = JTrainer(JSolver(j_parse_solver(SOLVER_TXT), net=jlm), mesh,
                  compress=compress, overlap_avg=overlap)
    tt = TTrainer(TSolver(t_parse_solver(SOLVER_TXT), net=tlm, device="cpu"),
                  DP, compress=compress, overlap_avg=overlap)
    jstate = jt.init_state(seed=0)
    jparams = {g: [np.asarray(b)[0] for b in bs] for g, bs in jstate.params.items()}
    tstate = tt.broadcast_state(_carry(jparams, tlm, tt.solver.method))
    init = [x.numpy().copy() for x in tree_leaves(tstate.params)]
    assert len(init) == 53
    sampler = TextWindowSampler(docs, 16, B, seed=1)
    host = stack_windows([sampler.for_worker(w).window_for_round(0, TAU)
                          for w in range(DP)])
    shard = NamedSharding(mesh, P("dp"))
    jstate, jl = jt.round(jstate, jax.device_put(host, {k: shard for k in host}))
    tstate, tl = tt.round(tstate, _t_batch(host))
    jstate, tstate = jt.finalize(jstate), tt.finalize(tstate)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TRAJ_TOL)
    if compress != "none" or overlap:
        assert tt._comm.chunk_slices == jt._comm._chunk_slices
        assert sum(sl.stop - sl.start for sl in tt._comm.chunk_slices) == 53
    for got, want, x0 in zip(tree_leaves(tstate.params),
                             jax.tree_util.tree_leaves(jstate.params), init):
        want = np.asarray(want)
        tol = TRAJ_TOL
        if compress != "none":  # one step of the quantization grid
            tol += 2.0 * float(np.abs(want - x0).max()) / 127
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want, atol=tol)


def test_lm_app_end_to_end_on_the_cpu():
    """Both attention legs of ``lm_app.main`` from one seed: finite
    losses falling from ~ln 256, the legs within the LM tolerance of
    each other, the token counter and the kernel-path gauge."""
    legs = {}
    for leg, extra in (("flash", []), ("dense", ["--dense_attention"])):
        result = {}
        tca.reset_launch_counts()
        assert lm_app.main(APP + ["--rounds", "3"] + extra, result) == 0
        assert all(v == 0 for v in tca.LAUNCHES.values())
        losses = result["losses"]
        assert losses.shape == (3, 2, TAU) and np.isfinite(losses).all()
        assert abs(losses[0, :, 0].mean() - np.log(256)) < 0.3
        assert losses[-1].mean() < losses[0].mean()
        m = result["metrics"]
        assert m.lm_tokens.value == 3 * 2 * TAU * B * T
        assert m.kernel_path.labels("attention").value == (leg == "flash")
        assert len(result["round_seconds"]) == 3
        legs[leg] = result
    np.testing.assert_allclose(legs["flash"]["losses"], legs["dense"]["losses"],
                               atol=TRAJ_TOL)
    for a, b in zip(tree_leaves(legs["flash"]["state"].params),
                    tree_leaves(legs["dense"]["state"].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TRAJ_TOL)


@pytest.mark.parametrize(
    "flag",
    [["--sp", "2"], ["--trace_out", "/t"], ["--obs_port", "1"],
     ["--slo"], ["--ship_to", "http://h:1"], ["--host_id", "h"], ["--obs"]],
)
def test_lm_app_refuses_what_is_not_yet_ported(flag, monkeypatch, tmp_path):
    """``--sp`` runs in one process (``tests/test_torch_lm_sp.py``) and
    across processes one sequence shard a rank
    (``tests/test_torch_lm_multiprocess.py``): what is refused is a rank
    stacking several slots of the sp ring.  The telemetry flags once
    refused here run now (``tests/test_torch_obs_apps.py``
    ``flag_runs``)."""
    if flag[0] != "--sp":
        from tests.test_torch_obs_apps import flag_runs

        flag_runs(monkeypatch, tmp_path, lm_app.main,
                  APP + ["--rounds", "1"] + flag)
        return
    from sparknet_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setenv("SPARKNET_LOCAL_WORKERS", "2")
    with pytest.raises(SystemExit, match="not yet ported") as e:
        lm_app.main(APP + ["--rounds", "1"] + flag)
    assert flag[0] in str(e.value)


@pytest.fixture(scope="module")
def lm_sync_run():
    """The synchronous 2-round run the stale case is held to."""
    sync = {}
    assert lm_app.main(APP + ["--rounds", "2"], result=sync) == 0
    return sync


@pytest.mark.parametrize("flag", [["--stale_bound", "2"], ["--profile_out"],
                                  ["--profile"]])
def test_lm_app_runs_stale_and_profile(tmp_path, flag, lm_sync_run):
    """``--stale_bound 2``: the bounded-staleness trainer (every worker
    arrives: within 1e-5 of the synchronous run, as the JAX app);
    ``--profile`` / ``--profile_out``: each worker's text draw timed and
    the summary at the end (JSON for ``--profile_out``)."""
    import json

    if flag == ["--profile_out"]:
        flag = flag + [str(tmp_path / "p.json")]
    sync, got = lm_sync_run, {}
    assert lm_app.main(APP + ["--rounds", "2"] + flag, result=got) == 0
    if flag[0] == "--stale_bound":
        assert list(got["trainer"].worker_rounds) == [2, 2]
        for a, b in zip(tree_leaves(sync["state"].params),
                        tree_leaves(got["state"].params)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-6)
    else:
        s = got["profile"]
        assert s["rounds"] == 2
        assert {"assemble", "execute", "average"} <= set(s["phases"])
        assert s["worker_skew"] is not None
        if flag[0] == "--profile_out":
            assert json.load(open(flag[1])) == json.loads(json.dumps(s))


def test_cli_train_lm_dispatch(tmp_path):
    corpus = tmp_path / "corpus"
    write_synthetic_corpus(str(corpus), num_docs=4, seed=0)
    assert cli.main(["train", "--lm", "--rounds", "1", "--corpus", str(corpus)]
                    + APP) == 0
    # --profile with --devices runs now: on this card-less host the
    # dispatch reaches the device count
    assert cli.main(["train", "--solver", "solver.prototxt", "--devices", "2",
                     "--profile"]) == 1
    # an object-store corpus is read through the chunk cache
    assert cli.main(["train", "--lm", "--rounds", "1", "--corpus",
                     "file://" + str(corpus), "--cache_dir",
                     str(tmp_path / "cache")] + APP) == 0
    assert os.listdir(tmp_path / "cache" / "objects")
