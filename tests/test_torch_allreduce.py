"""Caffe's synchronous gradient all-reduce on the global batch, across OS
processes on the CPU over gloo (``parallel.AllReduceTrainer``).

The port of the JAX ``AllReduceTrainer`` tests
(``tests/test_parallel.py::test_allreduce_matches_single_device_global_batch``
and ``tests/test_recover.py::test_allreduce_kill_resume_bit_equivalent``).
This file is also its own rank script: four ranks run it as
``python test_torch_allreduce.py <pid> <store> <out>`` (no JAX there),
join once through a ``file://`` store, run the toy net over all four and
every scenario over a pair of them, and save what they read; the
references are made in the test process.

- The JAX test's toy net over 2 and 4 ranks against the JAX
  ``AllReduceTrainer`` on its 8-device CPU mesh, with the JAX test's
  tolerances (losses rtol 1e-5; params rtol 2e-4, atol 2e-6), and
  against the port ``Solver`` on the global batch; every rank's params
  bit-identical after every window (a digest gathered each window).
- In one process the trainer is ``Solver.step`` on the global batch,
  bit for bit.
- A BatchNorm + Dropout + crop/mirror net in float64 over 2 ranks: the
  same crops and dropout masks as the global-batch ``Solver``, and the
  BN moments, moving blobs, grads, losses and params within 1e-10; the
  same net without the draws against the JAX ``AllReduceTrainer`` in
  float64 within 1e-10.
- ``SoftmaxWithLoss`` normalized VALID with ``ignore_label`` rows placed
  unevenly over the ranks, float64, within 1e-10 of the global batch.
- A kill at a window boundary and ``restore_newest`` on both ranks
  (rank 0's choice), bit for bit the uninterrupted run; a poisoned
  window rolled back by the sentry on both ranks together.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank script
    sys.path.insert(0, REPO)

from sparknet_tpu_torch import config  # noqa: E402
from sparknet_tpu_torch.data.transforms import train_transform  # noqa: E402
from sparknet_tpu_torch.parallel import AllReduceTrainer  # noqa: E402
from sparknet_tpu_torch.solver import Solver  # noqa: E402
from sparknet_tpu_torch.utils import dp, rngs  # noqa: E402
from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

# the JAX test's net (tests/test_parallel.py:28-38)
TOY_NET = """
name: "toy"
layer { name: "data" type: "HostData" top: "x" top: "label"
  java_data_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
  inner_product_param { num_output: 16 weight_filler { type: "xavier" } } }
layer { name: "relu" type: "ReLU" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "logits"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""
TOY_SOLVER = 'base_lr: 0.05 lr_policy: "fixed" momentum: 0.9'
GLOBAL_B = 32  # the JAX test's global batch (8 devices x 4)

# BatchNorm + Dropout over a crop/mirror transform; float64
BN_NET = """
name: "bn"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: @B@ dim: 3 dim: 8 dim: 8 }
                    shape { dim: @B@ } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "bn" type: "BatchNorm" bottom: "conv" top: "conv" }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "drop" type: "Dropout" bottom: "conv" top: "drop"
  dropout_param { dropout_ratio: @P@ } }
layer { name: "ip" type: "InnerProduct" bottom: "drop" top: "logits"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label"
  top: "loss" @LOSS@ }
"""
BN_B = 8  # global batch
BN_FULL = 10  # the crop's source images are 10 x 10
F64_TOL = 1e-10
KEY = rngs.train_key(7)


def bn_net(batch=BN_B, dropout=0.5, loss_param=""):
    return (BN_NET.replace("@B@", str(batch)).replace("@P@", str(dropout))
            .replace("@LOSS@", loss_param))


def toy_solver(batch=GLOBAL_B):
    netp = config.parse_net_prototxt(TOY_NET.replace("dim: 8", f"dim: {batch}"))
    return Solver(config.parse_solver_prototxt(TOY_SOLVER), net_param=netp,
                  device="cpu")


def toy_windows(n=2, tau=2):
    """The JAX test's window (RandomState 8 / 9), then more of its kind."""
    out = []
    for i in range(n):
        out.append({
            "x": np.random.RandomState(8 + 10 * i).randn(
                tau, GLOBAL_B, 6).astype(np.float32),
            "label": np.random.RandomState(9 + 10 * i).randint(
                0, 4, (tau, GLOBAL_B)).astype(np.float32)})
    return out


def f64(tree):
    return tree_map(lambda x: x.double() if x.is_floating_point() else x, tree)


def bn_solver(net_text, transform=True):
    """A float64 solver over ``net_text`` with the crop (8 of 10) and
    mirror transform, its output widened to float64."""
    netp = config.parse_net_prototxt(net_text)
    solver = Solver(config.parse_solver_prototxt(
        'base_lr: 0.1 lr_policy: "fixed" momentum: 0.9 weight_decay: 0.001'),
        net_param=netp, device="cpu")
    if transform:
        crop = train_transform(None, 8, mirror=True)

        def widened(batch, key):
            out = crop(batch, key)
            return {**out, "data": out["data"].double()}

        solver.train_transform = widened
    return solver


def bn_windows(n=2, tau=2, full=BN_FULL, labels=None):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(n):
        data = (rng.randint(0, 256, (tau, BN_B, 3, full, full)).astype(np.uint8)
                if full != 8 else rng.randn(tau, BN_B, 3, 8, 8))
        lab = (rng.randint(0, 3, (tau, BN_B)) if labels is None
               else np.broadcast_to(labels, (tau, BN_B)))
        out.append({"data": data, "label": lab.astype(np.float64)})
    return out


def f64_state(solver):
    return f64(solver.init_state(0))


# ragged ignore_label placement: rank 0's rows mostly ignored
VALID_LABELS = np.array([2, 2, 2, 0, 1, 2, 0, 1])
VALID_LOSS = "loss_param { ignore_label: 2 normalization: VALID }"


def digest(state) -> str:
    h = hashlib.sha256()
    for x in tree_leaves(state):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def flat(state):
    return {f"p{i}": x.detach().cpu().numpy()
            for i, x in enumerate(tree_leaves(state))}


# ----------------------------------------------------------------------
# the ranks' side: every scenario returns a dict of arrays

def _gathered_digests(state, group):
    from sparknet_tpu_torch.parallel import mesh

    return mesh.all_gather_objects(digest(state), group)


def rank_toy(tr, out_dir):
    st = tr.init_state(0)
    losses, digests = [], []
    for w in toy_windows():
        st, l = tr.step(st, w)
        losses.append(l.numpy())
        digests.append(_gathered_digests(st, tr.group))
    return {"losses": np.stack(losses), "digests": digests, **flat(st.params)}


def rank_bn(tr, out_dir):
    """The float64 BN net: one forward's crops and dropout tops, one
    iteration's grads and stats, then two windows."""
    solver = tr.solver
    st = tr.shard_state(f64_state(solver))
    w = bn_windows()[0]
    rows = tr.local_rows(w)
    batch = {k: torch.as_tensor(v[0]) for k, v in rows.items()}
    with dp.active(solver.batch_shard):
        fed = solver.train_transform(batch, rngs.fold_in(KEY, 0x7F))
        blobs = solver.net.apply(st.params, st.stats, fed, train=True,
                                 rng=KEY).blobs
    grads, loss, stats = solver._grads(st.params, st.stats, batch, KEY)
    losses, digests = [], []
    for win in bn_windows():
        st, l = tr.step(st, win, rng=KEY)
        losses.append(l.numpy())
        digests.append(_gathered_digests(st, tr.group))
    return {"data": fed["data"].numpy(), "drop": blobs["drop"].detach().numpy(),
            "loss1": loss.numpy(), "losses": np.stack(losses),
            "digests": digests, **{f"g{k}": v for k, v in flat(grads).items()},
            **{f"s{k}": v for k, v in flat(stats).items()}, **flat(st.params)}


def rank_resume(tr, out_dir):
    """Kill at a window boundary: the live state dropped, the snapshot
    restored on every rank, the rest of the run replayed."""
    from sparknet_tpu_torch.io import checkpoint

    prefix = os.path.join(out_dir, "ar_ck")
    ws = toy_windows(4)
    st = tr.init_state(0)
    for w in ws[:2]:
        st, _ = tr.step(st, w)
    if tr.is_root:
        checkpoint.snapshot(tr.solver, st, prefix)
    control = st
    for w in ws[2:]:
        control, _ = tr.step(control, w)
    resumed, used = tr.restore_newest(prefix)
    assert int(resumed.iter) == 4, int(resumed.iter)
    for w in ws[2:]:
        resumed, _ = tr.step(resumed, w)
    return {"same": np.array([digest(control) == digest(resumed)]),
            "digests": [_gathered_digests(resumed, tr.group)],
            "used": np.array([os.path.basename(used)])}


def rank_rollback(tr, out_dir):
    """A NaN in rank 1's rows of window 1: the global loss is NaN on
    both ranks, both sentries roll back to the window-0 snapshot, and
    the run ends where windows 0 and 2 alone end."""
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.obs import health

    prefix = os.path.join(out_dir, "rb_ck")
    solver = tr.solver
    solver.audit = True
    sentry = health.HealthSentry(
        "rollback", restore_fn=health.make_restore_fn(solver, prefix,
                                                      trainer=tr))
    ws = toy_windows(3)
    ws[1]["x"][0, GLOBAL_B - 1, 0] = np.nan  # the last row: rank 1's
    st = tr.init_state(0)
    st, _ = sentry.guarded_step(tr, st, ws[0], round_index=0)
    if tr.is_root:
        checkpoint.snapshot(solver, st, prefix)
    for r in (1, 2):
        st, _ = sentry.guarded_step(tr, st, ws[r], round_index=r)
    solver.audit = False
    control = tr.init_state(0)
    for w in (ws[0], ws[2]):
        control, _ = tr.step(control, w)
    return {"rollbacks": np.array([sentry.rollbacks]),
            "same": np.array([digest(st.params) == digest(control.params)]),
            "digests": [_gathered_digests(st, tr.group)]}


def _rank_trainer(name, mesh):
    if name == "bn":
        solver = bn_solver(bn_net())
    elif name == "bn_plain":
        solver = bn_solver(bn_net(dropout=0.0), transform=False)
    elif name == "valid":
        solver = bn_solver(bn_net(dropout=0.0, loss_param=VALID_LOSS),
                           transform=False)
    else:
        solver = toy_solver()
    return AllReduceTrainer(solver, mesh)


def rank_plain(tr, labels=None):
    """Two windows without draws (float64): params, stats and losses."""
    st = tr.shard_state(f64_state(tr.solver))
    losses = []
    for w in bn_windows(full=8, labels=labels):
        st, l = tr.step(st, w, rng=KEY)
        losses.append(l.numpy())
    return {"losses": np.stack(losses), "digests": [], **flat(st.params),
            **{f"s{k}": v for k, v in flat(st.stats).items()}}


SCENARIOS = {"toy": rank_toy, "bn": rank_bn,
             "bn_plain": lambda tr, out_dir: rank_plain(tr),
             "valid": lambda tr, out_dir: rank_plain(tr, VALID_LABELS),
             "resume": rank_resume, "rollback": rank_rollback}


TWO_RANK = ["toy", "bn", "bn_plain", "valid", "resume", "rollback"]


def rank_main(argv):
    """Four ranks joined once: the toy net over all four (``dp`` 4),
    then every scenario over the pair of ranks 0 and 2 (``dp`` 2 x
    ``pair`` 2: ranks 1 and 3 hold the other pair, which idles).  Saves
    ``<out>.<n>.<scenario>.npz``, ``n`` the ranks of the world the
    scenario ran in, under the rank's place in it."""
    pid, address, out = int(argv[0]), argv[1], argv[2]
    from sparknet_tpu_torch.parallel import make_mesh, mesh

    mesh.initialize_distributed(address, 4, pid, device="cpu")
    worlds = [(4, make_mesh({"dp": 4}, workers_per_process=1), ["toy"]),
              (2, make_mesh({"dp": 2, "pair": 2}, workers_per_process=1),
               TWO_RANK)]
    for n, m, names in worlds:
        if m.coords.get("pair", slice(0, 1)).start != 0:
            continue  # the idle pair
        rank = m.coords["dp"].start
        for name in names:
            tr = _rank_trainer(name, m)
            res = SCENARIOS[name](tr, f"{os.path.dirname(out)}/{n}")
            digests = res.pop("digests")
            np.savez(f"{os.path.dirname(out)}/rank{rank}.{n}.{name}.npz",
                     digests=np.array(json.dumps(digests)), **res)
    mesh.shutdown()
    print(f"AR_OK p{pid}", flush=True)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
    sys.exit(0)


# ----------------------------------------------------------------------
# the test process: references, and the ranks' runs

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """This process's references on one thread, as each rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{world size: {scenario: [each rank's results]}}``."""
    from sparknet_tpu_torch.utils import procs

    tmp = str(tmp_path_factory.mktemp("ar"))
    for n in (2, 4):
        os.makedirs(os.path.join(tmp, str(n)))
    with open(__file__) as f:
        src = f.read()
    procs.run_worker_processes(
        src, "AR_OK", REPO, nprocs=4,
        per_rank_args=[[os.path.join(tmp, f"out{p}")] for p in range(4)],
        timeout=240, workdir=tmp)
    runs = {}
    for n, names in ((4, ["toy"]), (2, TWO_RANK)):
        runs[n] = {}
        for name in names:
            runs[n][name] = []
            for r in range(n):
                z = dict(np.load(os.path.join(tmp, f"rank{r}.{n}.{name}.npz")))
                z["digests"] = json.loads(str(z["digests"]))
                runs[n][name].append(z)
    return runs


@pytest.fixture(scope="module")
def two(ranks):
    return ranks[2]


@pytest.fixture(scope="module")
def jax_toy():
    """The JAX test's run: 8 devices, global batch 32, two windows."""
    import jax

    from sparknet_tpu import config as jconfig
    from sparknet_tpu.parallel import AllReduceTrainer as JTrainer
    from sparknet_tpu.parallel import make_mesh
    from sparknet_tpu.solver import Solver as JSolver

    netp = jconfig.parse_net_prototxt(TOY_NET.replace("dim: 8",
                                                      f"dim: {GLOBAL_B}"))
    tr = JTrainer(JSolver(jconfig.parse_solver_prototxt(TOY_SOLVER),
                          net_param=netp), make_mesh({"dp": 8}))
    st = tr.init_state(seed=0)
    losses = []
    for w in toy_windows():
        st, l = tr.step(st, w, rng=jax.random.PRNGKey(7))
        losses.append(np.asarray(l))
    return np.stack(losses), [np.asarray(x) for x in
                              jax.tree_util.tree_leaves(st.params)]


def _global_toy():
    solver = toy_solver()
    st = solver.init_state(0)
    losses = []
    for w in toy_windows():
        st, l = solver.step(st, w)
        losses.append(l.numpy())
    return np.stack(losses), st


def _params(run):
    return [run[k] for k in sorted((k for k in run if k.startswith("p")),
                                   key=lambda k: int(k[1:]))]


def _same_digests(ranks):
    for r in ranks:  # each window, every rank's digest the same
        for window in r["digests"]:
            assert len(set(window)) == 1, window
    assert ranks[0]["digests"] == ranks[-1]["digests"]


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_the_jax_allreduce_trainer(n, ranks, jax_toy):
    ranks = ranks[n]["toy"]
    _same_digests(ranks)
    jlosses, jparams = jax_toy
    glosses, gstate = _global_toy()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], glosses, rtol=1e-5)
        for got, want, port in zip(_params(r), jparams,
                                   tree_leaves(gstate.params)):
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-6)
            np.testing.assert_allclose(got, port.numpy(), rtol=2e-4,
                                       atol=2e-6)


def test_one_process_trainer_is_the_solver_on_the_global_batch():
    from sparknet_tpu_torch.parallel import make_mesh

    glosses, gstate = _global_toy()
    for mesh in (None, make_mesh({"dp": 1})):
        tr = AllReduceTrainer(toy_solver(), mesh)
        assert tr.group is None and tr.solver.batch_shard is None
        st = tr.init_state(0)
        losses = []
        for w in toy_windows():
            st, l = tr.step(st, w)
            losses.append(l.numpy())
        np.testing.assert_array_equal(np.stack(losses), glosses)
        assert digest(st) == digest(gstate)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        AllReduceTrainer(toy_solver(), None, mp_axis="mp")


def test_bn_dropout_crop_float64_match_the_global_batch(two):
    """Each rank's crops and dropout tops are the global run's rows; the
    BN moments and moving blobs (the stats after one iteration), the
    summed grads, the loss and two windows' params within 1e-10."""
    ranks = two["bn"]
    _same_digests(ranks)
    solver = bn_solver(bn_net())
    st = f64_state(solver)
    w = bn_windows()[0]
    batch = {k: torch.as_tensor(v[0]) for k, v in w.items()}
    fed = solver.train_transform(batch, rngs.fold_in(KEY, 0x7F))
    blobs = solver.net.apply(st.params, st.stats, fed, train=True,
                             rng=KEY).blobs
    grads, loss, stats = solver._grads(st.params, st.stats, batch, KEY)
    half = BN_B // 2
    for i, r in enumerate(ranks):
        rows = slice(i * half, (i + 1) * half)
        np.testing.assert_array_equal(r["data"], fed["data"][rows].numpy())
        # the same mask: zeros where the global run's are
        drop = blobs["drop"][rows].detach().numpy()
        np.testing.assert_array_equal(r["drop"] == 0, drop == 0)
        np.testing.assert_allclose(r["drop"], drop, rtol=0, atol=F64_TOL)
        np.testing.assert_allclose(r["loss1"], loss.numpy(), rtol=F64_TOL)
        for j, g in enumerate(tree_leaves(grads)):
            np.testing.assert_allclose(r[f"gp{j}"], g.numpy(), rtol=0,
                                       atol=F64_TOL)
        for j, s in enumerate(tree_leaves(stats)):
            np.testing.assert_allclose(r[f"sp{j}"], s.numpy(), rtol=0,
                                       atol=F64_TOL)
    losses = []
    for win in bn_windows():
        st, l = solver.step(st, win, rng=KEY)
        losses.append(l.numpy())
    for r in ranks:
        np.testing.assert_allclose(r["losses"], np.stack(losses),
                                   rtol=F64_TOL)
        for got, want in zip(_params(r), tree_leaves(st.params)):
            np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                       atol=F64_TOL)


def _jax_plain(net_text):
    """The JAX AllReduceTrainer in float64 over dp=2 on the net with no
    draws: losses, params and stats of two windows."""
    import jax
    import jax.numpy as jnp

    from sparknet_tpu import config as jconfig
    from sparknet_tpu.parallel import AllReduceTrainer as JTrainer
    from sparknet_tpu.parallel import make_mesh
    from sparknet_tpu.solver import Solver as JSolver

    with jax.enable_x64(True):
        solver = JSolver(jconfig.parse_solver_prototxt(
            'base_lr: 0.1 lr_policy: "fixed" momentum: 0.9 '
            'weight_decay: 0.001'),
            net_param=jconfig.parse_net_prototxt(net_text))
        tr = JTrainer(solver, make_mesh({"dp": 2},
                                        devices=jax.devices()[:2]))
        st = tr.shard_state(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            solver.init_state(0)))
        labels = VALID_LABELS if "ignore_label" in net_text else None
        losses = []
        for w in bn_windows(full=8, labels=labels):
            st, l = tr.step(st, w, rng=jax.random.PRNGKey(0))
            losses.append(np.asarray(l))
        return (np.stack(losses),
                [np.asarray(x) for x in jax.tree_util.tree_leaves(st.params)],
                [np.asarray(x) for x in jax.tree_util.tree_leaves(st.stats)])


@pytest.mark.parametrize("name", ["bn_plain", "valid"])
def test_bn_and_valid_loss_float64_match_global_and_jax(two, name):
    """BatchNorm with no draws, and a VALID loss whose ignored rows fall
    3:0 over the ranks (rank 0 holds 3 of its 4 rows ignored): two
    windows within 1e-10 of the port's global-batch Solver and of the
    JAX AllReduceTrainer, both in float64; the BN stats too."""
    net_text = (bn_net(dropout=0.0) if name == "bn_plain"
                else bn_net(dropout=0.0, loss_param=VALID_LOSS))
    solver = bn_solver(net_text, transform=False)
    st = f64_state(solver)
    labels = VALID_LABELS if name == "valid" else None
    losses = []
    for w in bn_windows(full=8, labels=labels):
        st, l = solver.step(st, w, rng=KEY)
        losses.append(l.numpy())
    jlosses, jparams, jstats = _jax_plain(net_text)
    for r in two[name]:
        for want_l, want_p, want_s in (
                (np.stack(losses), [x.numpy() for x in tree_leaves(st.params)],
                 [x.numpy() for x in tree_leaves(st.stats)]),
                (jlosses, jparams, jstats)):
            np.testing.assert_allclose(r["losses"], want_l, rtol=F64_TOL)
            for got, want in zip(_params(r), want_p):
                np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)
            for j, want in enumerate(want_s):
                np.testing.assert_allclose(r[f"sp{j}"], want, rtol=0,
                                           atol=F64_TOL)


@pytest.mark.parametrize("name", ["resume", "rollback"])
def test_resume_and_rollback_across_ranks(two, name):
    ranks = two[name]
    _same_digests(ranks)
    for r in ranks:
        assert bool(r["same"][0])
        if name == "rollback":
            assert int(r["rollbacks"][0]) == 1
        else:
            assert str(r["used"][0]) == "ar_ck_iter_4.solverstate.npz"
