"""The port's TransformerLM against the JAX package's, on the CPU.

The JAX model's seeded parameters are carried across with
``sparknet_tpu_torch.interop``; the same numpy tokens then go through
both.  Tolerance 1e-4 absolute on logits and K/V: float32 through two
layers, summed in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models.transformer_lm import TransformerLM as JaxLM
from sparknet_tpu_torch.interop import lm_state_from_jax
from sparknet_tpu_torch.models.transformer_lm import TransformerLM

ATOL = 1e-4
GEOM = dict(dim=32, depth=2, heads=2, seq_len=32, vocab=64)


@pytest.fixture(scope="module")
def pair():
    jlm = JaxLM(**GEOM)
    params, _ = jlm.init(0)
    params = {g: [np.asarray(b) for b in blobs] for g, blobs in params.items()}
    tlm = TransformerLM(**GEOM)
    tlm.load_state_dict(lm_state_from_jax(params, tlm))
    return jlm, params, tlm


def test_blob_plan_and_counts_match(pair):
    jlm, _, tlm = pair
    assert tlm._blob_plan() == jlm._blob_plan()
    assert tlm.num_params() == jlm.num_params()
    assert tlm.num_params() == sum(p.numel() for p in tlm.parameters())
    assert tlm.param_multipliers() == jlm.param_multipliers()


def test_interop_is_a_copy_of_every_blob(pair):
    _, params, tlm = pair
    for group, blobs in tlm.group_params().items():
        for got, want in zip(blobs, params[group]):
            np.testing.assert_array_equal(got.detach().numpy(), want)


def test_interop_rejects_wrong_geometry(pair):
    _, params, _ = pair
    other = TransformerLM(**dict(GEOM, dim=64))
    with pytest.raises(ValueError, match="shape"):
        lm_state_from_jax(params, other)


def test_forward_logits_match(pair):
    jlm, params, tlm = pair
    toks = np.random.RandomState(0).randint(0, 64, size=(2, 32))
    want = np.asarray(jlm.forward_logits(params, toks))
    got = tlm.forward_logits(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("T", [8, 13, 32])
def test_prefill_with_kv_matches(pair, T):
    jlm, params, tlm = pair
    toks = np.random.RandomState(T).randint(0, 64, size=(1, T))
    lj, kj, vj = jlm.prefill_with_kv(params, toks)
    lt, kt, vt = tlm.prefill_with_kv(torch.from_numpy(toks))
    assert tuple(kt.shape) == (2, 1, T, 2, 16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=ATOL)


def test_decode_step_with_kv_matches(pair):
    """Ragged positions (1, 7, 31 cached) over a garbage-padded
    context: rows at or past each position are masked off."""
    jlm, params, tlm = pair
    r = np.random.RandomState(3)
    B, S = 3, 32
    toks = r.randint(0, 64, size=(B,))
    pos = np.array([1, 7, 31])
    k_ctx = r.randn(2, B, S, 2, 16).astype(np.float32)
    v_ctx = r.randn(2, B, S, 2, 16).astype(np.float32)
    lj, nkj, nvj = jlm.decode_step_with_kv(
        params, toks, pos, jnp.asarray(k_ctx), jnp.asarray(v_ctx)
    )
    lt, nkt, nvt = tlm.decode_step_with_kv(
        torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(k_ctx.copy()), torch.from_numpy(v_ctx.copy()),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    np.testing.assert_allclose(nkt.numpy(), np.asarray(nkj), atol=ATOL)
    np.testing.assert_allclose(nvt.numpy(), np.asarray(nvj), atol=ATOL)


def test_seeded_init_is_deterministic_and_refuses_sp():
    a = TransformerLM(**GEOM).init(5)
    b = TransformerLM(**GEOM).init(5)
    c = TransformerLM(**GEOM).init(6)
    for (n, pa), pb, pc in zip(
        a.named_parameters(), b.parameters(), c.parameters()
    ):
        assert torch.equal(pa, pb), n
        if pa.dim() == 2:
            assert not torch.equal(pa, pc), n
    assert float(a.blocks[0].ln1.weight.detach().min()) == 1.0
    with pytest.raises(ValueError, match="sp=1"):
        TransformerLM(**dict(GEOM, sp_size=2))
