"""The sequence-parallel LM (``TransformerLMNet(sp_size=n)``, ``lm_app
--sp``) on the CPU: the port's counterparts of the JAX package's
``tests/test_lm.py`` sp tests.

The JAX sp LM tests are red on this jax build (the dense ring's
``fori_loop`` carry under autodiff), so — as the JAX tests themselves
assert — the port's sp=2 run is held to the port's sp=1 run, which
``tests/test_torch_lm_train.py`` holds to the JAX sp=1 run, and the
ring itself is held to JAX's ``ring_self_attention`` in
``tests/test_torch_ring_attention.py``.

- The dp=2/sp=2 trajectory reproduces dp=2/sp=1 within 5e-5 (losses
  and params, two rounds), through the flash steps and the dense
  recurrence.
- sp with the audit and the in-round worker mask: finite stats, a
  (W,) ``masked``, a poisoned worker left out of the average.
- sp with ``--compress int8`` and a two-slice hierarchy: finite,
  falling losses.
- The ring hop-bytes model, and ``lm_app --sp 2`` against ``--sp 1``.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.apps import lm_app
from sparknet_tpu_torch.config import parse_solver_prototxt
from sparknet_tpu_torch.data import stack_windows
from sparknet_tpu_torch.data.text import (
    TextWindowSampler,
    load_corpus,
    write_synthetic_corpus,
)
from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet
from sparknet_tpu_torch.parallel import HierarchySpec, ParameterAveragingTrainer
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.utils.tree import tree_leaves

SOLVER_TXT = ('base_lr: 0.1 lr_policy: "fixed" momentum: 0.9 '
              "weight_decay: 0.0001 average_loss: 20")
T, B, TAU, DP = 32, 4, 2, 2
SP_TOL = 5e-5  # the JAX test's bound (test_lm.py:286)


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    write_synthetic_corpus(str(d), num_docs=4, words_per_doc=200, seed=0)
    return load_corpus(str(d))


def _build(sp, attention="auto", audit=False):
    lm = TransformerLMNet(dim=32, depth=2, heads=2, seq_len=T, sp_size=sp,
                          attention=attention)
    return lm, Solver(parse_solver_prototxt(SOLVER_TXT), net=lm, device="cpu",
                      audit=audit)


def _windows(docs, r, poison=None):
    host = stack_windows([TextWindowSampler(docs, T, B, seed=0, worker=w)
                          .window_for_round(r, TAU) for w in range(DP)])
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in host.items()}
    return batch


def _run_rounds(sp, docs, rounds=2, attention="auto", **kw):
    _, solver = _build(sp, attention)
    trainer = ParameterAveragingTrainer(solver, DP, **kw)
    state = trainer.init_state(seed=0)
    losses = []
    for r in range(rounds):
        state, l = trainer.round(state, _windows(docs, r), round_index=r)
        losses.append(l.numpy())
    state = trainer.finalize(state)
    return state, np.stack(losses), trainer


@pytest.mark.parametrize("attention", ["auto", "dense"], ids=["flash", "dense"])
def test_sp_trajectory_matches_sp1(docs, attention):
    """dp=2/sp=2 ring rounds reproduce the dp=2/sp=1 rounds up to float
    associativity (same seeded init, same windows, same tau)."""
    st1, l1, _ = _run_rounds(1, docs, attention=attention)
    st2, l2, _ = _run_rounds(2, docs, attention=attention)
    assert np.max(np.abs(l1 - l2)) < SP_TOL
    for a, b in zip(tree_leaves(st1.params), tree_leaves(st2.params)):
        assert float((a - b).abs().max()) < SP_TOL


def test_sp_round_with_audit_and_mask(docs):
    """The audit composes onto the sp round: stats finite, a (W,)
    ``masked``; and a worker whose window is poisoned leaves the
    average, the survivor's params landing in both slots."""
    _, solver = _build(2, audit=True)
    trainer = ParameterAveragingTrainer(solver, DP)
    state = trainer.init_state(seed=0)
    state, losses, stats = trainer.round(
        state, _windows(docs, 0), live_mask=np.ones(DP, np.float32),
        round_index=0)
    assert torch.isfinite(stats["grad_norm"]).all()
    assert int(stats["nonfinite_grads"].sum()) == 0
    assert tuple(stats["masked"].shape) == (DP,)
    assert torch.isfinite(losses).all()
    # poison worker 1's embedding: its window goes non-finite
    state.params["embed"][0][1, :4] = float("nan")
    state, losses, stats = trainer.round(state, _windows(docs, 1),
                                         round_index=1)
    assert stats["masked"].tolist() == [0.0, 1.0]
    for x in tree_leaves(state.params):
        assert torch.isfinite(x).all()
        assert torch.equal(x[0], x[1])


def test_sp_composes_with_comm_and_hierarchy(docs):
    """int8 delta averaging and a two-slice K=2 hierarchy on the sp=2
    LM: the comm plane and the slice round take it; losses stay finite
    and fall."""
    spec = HierarchySpec.grouped(DP, 2, cross_slice_every=2)
    _, losses, trainer = _run_rounds(2, docs, rounds=4, compress="int8",
                                     hierarchy=spec)
    assert trainer._comm is not None and trainer._two_tier
    assert np.all(np.isfinite(losses))
    assert losses[-1].mean() < losses[0].mean()


def test_ring_hop_bytes_model():
    lm1 = TransformerLMNet(dim=32, depth=2, heads=2, seq_len=T)
    assert lm1.ring_hop_bytes_per_iter(B) == 0  # no ring at sp=1
    lm2 = lm1.with_sp(2)
    expect = 2 * 2 * (B * (T // 2) * 32 * 4) * (2 * 1) * 2
    assert lm2.ring_hop_bytes_per_iter(B) == expect
    assert lm2.local_seq == T // 2 and lm2.attention == lm1.attention


def test_lm_app_sp2_follows_sp1():
    """``lm_app --sp 2`` in one process: the same per-round losses and
    final params as ``--sp 1`` within 5e-5, the ring bytes counted, a
    ragged ``--seq_len`` refused."""
    argv = ["--device", "cpu", "--dim", "32", "--depth", "2", "--heads", "2",
            "--seq_len", str(T), "--batch", str(B), "--tau", str(TAU),
            "--workers", str(DP), "--rounds", "2"]
    a, b = {}, {}
    assert lm_app.main(argv, result=a) == 0
    assert lm_app.main(argv + ["--sp", "2"], result=b) == 0
    assert np.max(np.abs(a["losses"] - b["losses"])) < SP_TOL
    for x, y in zip(tree_leaves(a["state"].params), tree_leaves(b["state"].params)):
        assert float((x - y).abs().max()) < SP_TOL
    assert b["lm"].sp_size == 2
    hop = b["lm"].ring_hop_bytes_per_iter(B) * TAU * DP * 2
    assert b["metrics"].lm_ring_bytes.value == hop
    assert a["metrics"].lm_ring_bytes.value == 0
    with pytest.raises(SystemExit, match="must divide by --sp 3"):
        lm_app.main(argv + ["--sp", "3"])
