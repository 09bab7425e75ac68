"""SparkNet's failure and straggler machinery across OS processes, on the
CPU over gloo: the two-tier schedule, elastic membership, bounded
staleness, the run journal and the round profiler, each through the
apps' round loop (``apps/guards.RoundGuards``, driven by
``utils/procs.run_machinery_spec`` on the toy net).

Two ranks join once through a ``file://`` store and run every spec; the
one-process stacked run of the same W, made in rank 0's process before
it joins, is the reference.

- Bit for bit against the stacked run: every rank's rows, every
  worker's losses, each round's live mask, view epoch and roster, the
  membership's transitions, W=4 as 2 ranks x 2 (slices aligned to the
  ranks) and W=6 as 2 x 3 with ``--slices 3`` (slice 1 = workers 2-3
  spans the boundary):
  - ``--slices --cross_slice_every 2 --compress int8``;
  - ``--elastic --rejoin_after 1`` with ``--compress int8``, the SIGTERM
    sent by ``os.kill`` to the one rank whose slice is preempted at
    round 1 (the stacked run gets ``note_preempt`` there);
  - ``--stale_bound 0`` (the sync trainer's bits) and ``--stale_bound 2``,
    flat and over slices;
  - ``--journal``: rank 0's records are the stacked run's, rank 1 keeps
    none;
  - ``--profile --profile_out``: W rows a table, written by rank 0.
- What crossed, in the two-tier int8 and the bounded-staleness runs: 0
  bytes on a rank-aligned intra-slice round; one row of the spanning
  slice at 2 x 3.
- A two-tier int8 run and an elastic run against the JAX package's
  one-process dp mesh, from carried weights, within the stacked parity
  tolerance (rtol 2e-5, atol 1e-6).
"""

import os

import jax
import numpy as np
import pytest

from sparknet_tpu import config as jconfig
from sparknet_tpu.parallel import ParameterAveragingTrainer as JTrainer
from sparknet_tpu.parallel import hierarchy as jhierarchy
from sparknet_tpu.parallel import make_mesh, shard_leading
from sparknet_tpu.runtime import membership as jmembership
from sparknet_tpu.solver import Solver as JSolver
from sparknet_tpu_torch.utils import procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ELASTIC = {"elastic": True, "preempt": [1, 1], "rounds": 4}
SPECS = {
    "tier-int8-2x2": {"workers": 4, "rounds": 3, "slices": 2,
                      "cross_slice_every": 2, "compress": "int8"},
    "tier-int8-2x3": {"workers": 6, "rounds": 3, "slices": 3,
                      "cross_slice_every": 2, "compress": "int8"},
    "elastic-2x2": {"workers": 4, "slices": 2, "compress": "int8", **ELASTIC},
    "elastic-2x3": {"workers": 6, "slices": 3, "compress": "int8", **ELASTIC},
    "sync-2x2": {"workers": 4, "rounds": 3},
    "stale0-2x2": {"workers": 4, "rounds": 3, "stale_bound": 0,
                   "journal": True},
    "stale2-2x2": {"workers": 4, "rounds": 3, "stale_bound": 2},
    "stale2-2x3": {"workers": 6, "rounds": 3, "stale_bound": 2, "slices": 3,
                   "cross_slice_every": 2},
    "stale2-tier-2x2": {"workers": 4, "rounds": 3, "stale_bound": 2,
                        "slices": 2, "cross_slice_every": 2},
    "journal-2x2": {"workers": 4, "slices": 2, "journal": True, **ELASTIC},
    "profile-2x2": {"workers": 4, "rounds": 2, "profile": True},
    "profile-2x3": {"workers": 6, "rounds": 2, "profile": True},
    "jax-tier": {"workers": 4, "rounds": 3, "slices": 2,
                 "cross_slice_every": 2, "compress": "int8"},
    "jax-elastic": {"workers": 4, "slices": 2, "compress": "int8", **ELASTIC},
}
BITS = [n for n in SPECS if not n.startswith("jax")]


def _jax_run(spec, init_path):
    """The JAX package's one-process dp=W run of ``spec``: the two-tier
    schedule, and under ``elastic`` the JAX membership controller fed
    the same notice, its AutoRejoin and survivor readmission."""
    spec = procs._spec(spec)
    W = spec["workers"]
    mesh = make_mesh({"dp": W}, devices=jax.devices()[:W])
    solver = JSolver(jconfig.parse_solver_prototxt(procs.TOY_SOLVER),
                     net_param=jconfig.parse_net_prototxt(procs.TOY_NET))
    hier = jhierarchy.HierarchySpec.grouped(W, spec["slices"],
                                            spec["cross_slice_every"])
    trainer = JTrainer(solver, mesh, compress=spec["compress"],
                       hierarchy=hier)
    state = trainer.init_state(seed=0)
    procs.save_weights(init_path, {k: [np.asarray(b)[0] for b in v]
                                   for k, v in state.params.items()})
    ctl = auto = None
    if spec["elastic"]:
        ctl = jmembership.MembershipController(hier)
        auto = jmembership.AutoRejoin(ctl, 1)
    losses, masks = [], []
    for r in range(spec["rounds"]):
        mask = None
        if ctl is not None:
            if r == spec["preempt"][0]:
                ctl.note_preempt(slice_index=spec["preempt"][1])
            ctl.advance(r)
            auto.on_round(r)
            if ctl.pending_joiners():
                state, _ = jmembership.readmit_from_survivors(
                    trainer, state, ctl, r)
            mask = ctl.live_mask()
        masks.append(None if mask is None else [float(v) for v in mask])
        state, l = trainer.round(
            state, shard_leading(procs.averaging_batches(spec, r), mesh),
            live_mask=mask, round_index=r)
        losses.append(np.asarray(l))
    rows = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.params)]
    return np.stack(losses), rows, masks


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax")
    out = {}
    for name in ("jax-tier", "jax-elastic"):
        init = str(d / f"{name}.npz")
        out[name] = (init,) + _jax_run(SPECS[name], init)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_runs):
    """Every spec over two gloo ranks joined once, and each spec's W
    stacked with no group in rank 0 before it joined."""
    d = tmp_path_factory.mktemp("mp")
    specs = dict(SPECS)
    for name, (init, *_) in jax_runs.items():
        specs[name] = dict(specs[name], init=init)
    names = list(specs)
    got, ref, logs = procs.run_averaging_processes(
        [specs[n] for n in names], REPO, nprocs=2, device="cpu",
        workdir=str(d), timeout=240, stacked_first=True)
    return {n: (got[i], ref[i]) for i, n in enumerate(names)}


def _same(ranks, ref, what):
    """Each rank's rows of every param, every worker's losses, and the
    membership's masks, epochs, rosters and transitions: the stacked
    run's bits."""
    for r in ranks:
        lo, hi = r["rows"]
        for got, want in zip(r["all_rows"], ref["all_rows"]):
            np.testing.assert_array_equal(got, want[lo:hi], err_msg=what)
        np.testing.assert_array_equal(r["losses"], np.stack(ref["losses"]),
                                      err_msg=what)
        for key in ("masks", "epochs", "states", "transitions", "tiers"):
            assert r.get(key) == ref.get(key), (what, key, r.get(key))


@pytest.mark.parametrize("name", BITS)
def test_joined_runs_are_the_stacked_runs_bit_for_bit(runs, name):
    ranks, ref = runs[name]
    W = procs._spec(SPECS[name])["workers"]
    assert [r["rows"] for r in ranks] == [[0, W // 2], [W // 2, W]]
    _same(ranks, ref, name)
    for r in ranks:
        for rows in r["all_rows"]:
            assert np.isfinite(rows).all()


@pytest.mark.parametrize("name,intra,cross", [
    # int8: each of the other rank's rows crosses as 1 B an element plus
    # one f32 scale a leaf; a rank-aligned intra round moves nothing
    ("tier-int8-2x2", [0], [2 * (83 + 4 * 4)]),
    # the spanning slice's one row a rank (83 params + its alive flag,
    # f32) on intra rounds; the other rank's 3 rows on cross rounds
    ("tier-int8-2x3", [(83 + 1) * 4], [3 * (83 + 4 * 4)]),
    # bounded staleness: the weighted mean gathers the same groups (f32
    # rows, the weights are known on every rank)
    ("stale2-tier-2x2", [0], [2 * 83 * 4]),
    ("stale2-2x3", [83 * 4], [3 * 83 * 4]),
])
def test_what_crosses_each_tier(runs, name, intra, cross):
    ranks, _ = runs[name]
    for r in ranks:
        assert r["tiers"] == ["intra", "cross", "intra"]
        by_tier = {t: [b[t == "cross"] for b, tt in zip(r["tier_bytes"],
                                                       r["tiers"]) if tt == t]
                   for t in ("intra", "cross")}
        assert set(by_tier["intra"]) == set(intra), by_tier
        assert set(by_tier["cross"]) == set(cross), by_tier
        assert r["group_bytes"] == [intra[0], cross[0], intra[0]]
        # K9 and K10 ran on the cross round only (plain versions here)
        assert (r["chunks"] > 0) == ("int8" in name)


@pytest.mark.parametrize("name", ["elastic-2x2", "elastic-2x3"])
def test_one_rank_sigterm_gives_every_rank_one_view(runs, name):
    """Round 1's SIGTERM reached one process; the agreed boundary puts
    slice 1 leaving on both, dead a boundary later, then joining and
    readmitted: epochs 0, 1, 2, 4 on every rank."""
    ranks, ref = runs[name]
    W = procs._spec(SPECS[name])["workers"]
    slice1 = (2, 3)
    for r in ranks:
        assert r["epochs"] == [0, 1, 2, 4]
        assert [s[slice1[0]] for s in r["states"]] == [
            "live", "leaving", "dead", "live"]
        assert r["masks"][1] == [0.0 if w in slice1 else 1.0
                                 for w in range(W)]
        assert [t[2] for t in r["transitions"]] == [
            "leave", "death", "join_request", "rejoin"]
        assert all(list(t[3]) == list(slice1) for t in r["transitions"])


def test_stale_bound_zero_is_the_sync_trainer(runs):
    sync, _ = runs["sync-2x2"]
    stale0, _ = runs["stale0-2x2"]
    for a, b in zip(sync, stale0):
        for x, y in zip(a["all_rows"], b["all_rows"]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a["losses"], b["losses"])


def test_journal_has_one_writer_with_the_stacked_records(runs):
    ranks, ref = runs["journal-2x2"]
    assert ranks[1]["journal"] is None  # rank 1 opens no ledger
    recs = ranks[0]["journal"]
    assert recs == ref["journal"]
    assert [(x["kind"], x["round"]) for x in recs] == [
        (k, r) for r in range(4) for k in ("intent", "commit")]
    assert [x["view_epoch"] for x in recs if x["kind"] == "intent"] == [
        0, 0, 1, 2]
    # the B=0 run's records carry its worker-round vector
    assert runs["stale0-2x2"][0][0]["journal"] == runs["stale0-2x2"][1][
        "journal"]


@pytest.mark.parametrize("name", ["profile-2x2", "profile-2x3"])
def test_profile_table_names_every_worker(runs, name):
    ranks, ref = runs[name]
    W = procs._spec(SPECS[name])["workers"]
    for r in ranks:
        p = r["profile"]
        assert p["rounds"] == 2
        assert len(p["execute_ms_p50"]) == W
        assert p["flops_per_round"] == ref["profile"]["flops_per_round"]
        lw = p["last_straggler_worker"]
        assert lw is None or 0 <= lw < W
    assert [r["profile"]["written"] for r in ranks] == [True, False]
    # both ranks hold the same gathered table
    assert ranks[0]["profile"]["execute_ms_p50"] == \
        ranks[1]["profile"]["execute_ms_p50"]


@pytest.mark.parametrize("name", ["jax-tier", "jax-elastic"])
def test_joined_runs_match_the_jax_dp_mesh(runs, jax_runs, name):
    ranks, ref = runs[name]
    _, jlosses, jrows, jmasks = jax_runs[name]
    _same(ranks, ref, name + " stacked")
    for r in ranks:
        assert r["masks"] == (jmasks if name == "jax-elastic"
                              else [None] * 3)
        np.testing.assert_allclose(r["losses"], jlosses, rtol=2e-5,
                                   atol=1e-6)
        lo, hi = r["rows"]
        for got, want in zip(r["all_rows"], jrows):
            np.testing.assert_allclose(got, want[lo:hi], rtol=2e-5,
                                       atol=1e-6)
