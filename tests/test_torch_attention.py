"""The port's attention against the JAX package's, on the CPU.

Same inputs (numpy, seeded) through ``sparknet_tpu``'s functions — the
Pallas kernels in interpret mode, as ``tests/test_attention.py`` runs
them — and through ``sparknet_tpu_torch``'s plain versions, which are
what the port's kernel wrappers run on CPU tensors.  Tolerance 1e-5
absolute: float32 on both sides, summed in different orders.
"""

import numpy as np
import pytest
import torch

from sparknet_tpu.ops import pallas_attention as jpa
from sparknet_tpu.ops.attention import mha_reference as j_mha
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.ops.attention import mha_reference as t_mha

ATOL = 1e-5


def _rand(seed, *shapes):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(8, 8), (5, 12)])
def test_mha_reference_matches_jax(causal, tq, tk):
    q, k, v = _rand(0, (2, tq, 2, 8), (2, tk, 2, 8), (2, tk, 2, 8))
    want = np.asarray(j_mha(q, k, v, causal=causal))
    got = t_mha(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(16, 16), (13, 13), (8, 32)])
def test_flash_attention_matches_pallas_interpret(causal, tq, tk):
    """Ragged T_q (13 with block_q=8) and end-aligned T_q < T_k."""
    q, k, v = _rand(1, (2, tq, 2, 8), (2, tk, 2, 8), (2, tk, 2, 8))
    want = np.asarray(
        jpa.flash_attention(q, k, v, causal=causal, block_q=8,
                            interpret=True)
    )
    tq_, tk_, tv_ = _t(q, k, v)
    got_ref = tca.flash_attention_reference(tq_, tk_, tv_, causal).numpy()
    got = tca.flash_attention(tq_, tk_, tv_, causal=causal, block_q=8)
    np.testing.assert_allclose(got_ref, want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize(
    "q_off,k_off,causal",
    [(0, 0, True), (16, 0, True), (0, 8, True), (0, 0, False)],
)
def test_flash_core_o_lse_match_flash_attention_step(q_off, k_off, causal):
    """The (o, lse) core with absolute offsets — including (0, 8),
    where the first 8 query rows see no key and must come out
    (o=0, lse=-inf) — against the ring-step entry point."""
    q, k, v = _rand(2, (1, 12, 2, 8), (1, 16, 2, 8), (1, 16, 2, 8))
    o_j, lse_j = jpa.flash_attention_step(
        q, k, v, q_off, k_off, causal=causal, block_q=8, interpret=True
    )
    o_t, lse_t = tca._flash_core(*_t(q, k, v), q_off, k_off, causal)
    # JAX returns (B, H, T_q, D); the port keeps (B, T_q, H, D)
    np.testing.assert_allclose(
        o_t.permute(0, 2, 1, 3).numpy(), np.asarray(o_j), atol=ATOL
    )
    lse_j = np.asarray(lse_j)
    lse_t = lse_t.numpy()
    np.testing.assert_array_equal(np.isinf(lse_t), np.isinf(lse_j))
    fin = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t[fin], lse_j[fin], atol=ATOL)
    if (q_off, k_off) == (0, 8):
        assert np.isneginf(lse_t[:, :, :8]).all()
        assert (o_t[:, :8] == 0).all()


def test_flash_attention_rejects_empty_query():
    q, k, v = _t(*_rand(3, (1, 0, 2, 8), (1, 4, 2, 8), (1, 4, 2, 8)))
    with pytest.raises(ValueError, match="T_q=0"):
        tca.flash_attention(q, k, v)


@pytest.mark.parametrize("with_lengths", [True, False])
def test_decode_attention_matches_pallas_and_reference(with_lengths):
    q, k, v = _rand(4, (3, 1, 2, 8), (3, 16, 2, 8), (3, 16, 2, 8))
    lengths = np.array([3, 16, 9], np.int32) if with_lengths else None
    want_kernel = np.asarray(
        jpa.decode_attention(
            q, k, v,
            lengths if with_lengths else np.full((3,), 16, np.int32),
            interpret=True,
        )
    )
    want_ref = np.asarray(jpa._decode_reference(q, k, v, lengths))
    t_len = torch.from_numpy(lengths) if with_lengths else None
    got = tca.decode_attention(*_t(q, k, v), t_len).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, atol=ATOL)


def test_decode_attention_wants_one_query_position():
    q, k, v = _t(*_rand(5, (2, 2, 2, 8), (2, 12, 2, 8), (2, 12, 2, 8)))
    with pytest.raises(ValueError, match="q_len=1"):
        tca.decode_attention(q, k, v)
