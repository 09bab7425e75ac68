"""The port's paged decode (K2 over the KV arena) against the JAX package's
gathered decode, on the CPU.

The JAX engine gathers each decode step's context out of the arena
(``ak[:, index_map]``, ``sparknet_tpu/serve/generate.py``) and runs
``decode_attention`` on it; the port reads the same arena through a
block table.  Same seeded numpy arena, tables of shuffled, non-contiguous
blocks and lengths at a block edge and either side of it: the port's
paged plain version (what ``paged_decode_attention`` runs on CPU
tensors) against the JAX kernel in interpret mode and against its dense
reference, tolerance 1e-5 absolute (float32, summed in other orders).
Then the engine's paged decode step against ``decode_step_with_kv`` on
the context gathered from the same arena (logits within 1e-6, the arena
after the step bit-equal outside the trash block), and the wrapper's
validation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.ops import pallas_attention as jpa
from sparknet_tpu.serve.kv_cache import KVBlockPool as JaxPool
from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.ops import cuda_attention as tca
from sparknet_tpu_torch.serve import GenerationEngine, KVBlockPool

ATOL = 1e-5
S = 32  # context positions a slot can hold
LAYERS = 2


def _case(seed, h, d, bs, lengths, nblocks=24):
    """A two-layer arena, q, each slot's blocks (shuffled, non-contiguous)
    and the block table they make (trash block 0 past them)."""
    r = np.random.RandomState(seed)
    rows = (nblocks + 1) * bs
    ak, av = (r.randn(LAYERS, rows, h, d).astype(np.float32) for _ in range(2))
    q = r.randn(len(lengths), 1, h, d).astype(np.float32)
    width = -(-S // bs)
    blocks = [list(r.permutation(np.arange(1, nblocks + 1))[
        : min(-(-n // bs), width)]) for n in lengths]
    assert any(np.any(np.diff(b) != 1) for b in blocks if len(b) > 1)
    table = np.zeros((len(lengths), width), np.int32)
    for i, b in enumerate(blocks):
        table[i, : len(b)] = b
    return q, ak, av, blocks, table


@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("d", [8, 16, 40])
@pytest.mark.parametrize("bs", [4, 16])
def test_paged_plain_matches_jax_decode_on_the_gathered_arena(h, d, bs):
    lengths = [1, bs - 1, bs, bs + 1, S]
    q, ak, av, blocks, table = _case(h * 100 + d + bs, h, d, bs, lengths)
    index_map = np.stack([JaxPool(LAYERS, h, d, num_blocks=24, block_size=bs)
                          .index_row(b, S) for b in blocks])
    kc, vc = jnp.asarray(ak)[:, index_map], jnp.asarray(av)[:, index_map]
    lens = np.asarray(lengths, np.int32)
    for layer in range(LAYERS):
        want = np.asarray(jpa.decode_attention(q, kc[layer], vc[layer], lens,
                                               interpret=True))
        want_ref = np.asarray(jpa._decode_reference(q, kc[layer], vc[layer],
                                                    lens))
        got = tca.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(ak[layer]),
            torch.from_numpy(av[layer]), torch.from_numpy(table),
            torch.from_numpy(lens), bs).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(got, want_ref, atol=ATOL)


def test_paged_plain_reads_the_first_d_columns_and_gives_zero_at_length_0():
    """An arena kept at the kernel's head dim (48 for D=40, pad columns
    garbage here) gives the same o as the unpadded arena; a length of 0
    gives o = 0, and a length past the table's width reads up to it."""
    q, ak, av, _, table = _case(7, 2, 40, 4, [5, 0, 13, 1000])
    lens = torch.tensor([5, 0, 13, 1000], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (q, ak[0], av[0], table)]
    want = tca.paged_decode_attention(*args, lens, 4)
    pad = torch.randn(ak.shape[1], 2, 8)
    wide = [torch.cat([a, pad], dim=-1) for a in args[1:3]]
    got = tca.paged_decode_attention(args[0], *wide, args[3], lens, 4)
    assert torch.equal(got, want)
    assert bool((got[1] == 0).all())
    full = tca.paged_decode_attention(*args, torch.full_like(lens, S), 4)
    assert torch.equal(got[3], full[3])
    assert tca.arena_head_dim(40) == 48 and tca.arena_head_dim(64) == 64
    assert tca.arena_head_dim(8) == 16 and tca.arena_head_dim(200) == 224
    assert tca.arena_head_dim(272) == 272  # only the plain version takes it


GEOM = dict(dim=32, depth=2, heads=2, seq_len=S, vocab=64)
SERVE = dict(prefill_buckets=(8, S), max_streams=4, kv_blocks=30,
             kv_block_size=4)


def test_paged_step_matches_decode_step_with_kv_on_the_same_arena():
    """Three live slots (one at a block edge) and one idle: the engine's
    decode step (paged) against ``decode_step_with_kv`` on the context
    gathered from the same arena, with this step's K/V scattered back
    afterwards as the gathering engine did."""
    eng = GenerationEngine(TransformerLM(**GEOM), device="cpu", **SERVE)
    eng.warmup()
    for prompt in ([5, 9, 2, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [3]):
        eng.admit(prompt, 6)
    bs, live = eng.pool.block_size, [0, 1, 2]
    ak, av = eng.pool.k.clone(), eng.pool.v.clone()
    rows = np.stack([eng.pool.index_row(list(t[t > 0]), S)
                     for t in eng._block_table])
    pos = torch.from_numpy(eng._positions.copy())
    last = torch.from_numpy(eng._last.copy())
    write = torch.from_numpy(rows[np.arange(4), eng._positions])
    rows = torch.from_numpy(rows)
    logits, nk, nv = eng.lm.decode_step_with_kv(last, pos, ak[:, rows],
                                                av[:, rows])
    ak[:, write], av[:, write] = nk, nv
    # the paged step itself, on a copy of the arena
    pk, pv = eng.pool.k.clone(), eng.pool.v.clone()
    got = eng.lm.decode_step_paged(
        last, pos, pk, pv, torch.from_numpy(eng._block_table),
        write, (pos + 1).to(torch.int32), bs)
    torch.testing.assert_close(got[live], logits[live], atol=1e-6, rtol=0)
    # and the engine's step, which writes the pool in place
    nxt, lps = eng._decode()
    want = torch.log_softmax(logits[live], dim=-1)
    assert nxt[live].tolist() == want.argmax(-1).tolist()
    np.testing.assert_allclose(lps[live], want.max(-1).values.numpy(),
                               atol=1e-6)
    for arena, ref in ((eng.pool.k, ak), (eng.pool.v, av), (pk, ak), (pv, av)):
        assert torch.equal(arena[:, bs:], ref[:, bs:])


def test_engine_pool_rows_are_the_kernels_head_dim():
    """At head dim 40 the pool keeps 48 columns a head, the prefill and
    the decode step write the first 40 and the rest stay zero."""
    geom = dict(GEOM, dim=80)
    eng = GenerationEngine(TransformerLM(**geom), device="cpu", **SERVE)
    assert tuple(eng.pool.k.shape) == (2, 31 * 4, 2, 48)
    slot, _, _ = eng.admit([4, 8, 15, 16, 23], 5)
    for _ in range(4):
        eng.step()
    assert eng.pool.k[..., :40].any() and eng.pool.v[..., :40].any()
    assert not eng.pool.k[..., 40:].any() and not eng.pool.v[..., 40:].any()
    eng.finish(slot)
    assert not eng._block_table.any()


def test_kv_pool_table_row():
    pool = KVBlockPool(2, 2, 48, num_blocks=6, block_size=4, device="cpu")
    row = pool.table_row([3, 1], 4)
    assert row.dtype == np.int32 and row.tolist() == [3, 1, 0, 0]
    assert pool.table_row([5, 2, 6], 2).tolist() == [5, 2]


def _inputs(b=2, h=2, d=16, width=4):
    q = torch.zeros(b, 1, h, d)
    arena = torch.zeros(20, h, d)
    table = torch.zeros(b, width, dtype=torch.int32)
    lens = torch.ones(b, dtype=torch.int32)
    return q, arena, table, lens


@pytest.mark.parametrize("what,change,match", [
    ("dtype", lambda t: t.long(), "block_table"),
    ("shape", lambda t: t[:1], "block_table"),
    ("rank", lambda t: t[:, 0], "block_table"),
    ("device", lambda t: t.to("meta"), "block_table"),
])
def test_paged_wrapper_checks_the_table(what, change, match):
    q, arena, table, lens = _inputs()
    with pytest.raises(ValueError, match=match):
        tca.paged_decode_attention(q, arena, arena, change(table), lens, 4)


def test_paged_wrapper_checks_lengths_arenas_and_q():
    q, arena, table, lens = _inputs()
    with pytest.raises(ValueError, match="lengths"):
        tca.paged_decode_attention(q, arena, arena, table, lens.long(), 4)
    with pytest.raises(ValueError, match="arenas"):
        tca.paged_decode_attention(q, arena[..., :8], arena[..., :8], table,
                                   lens, 4)
    with pytest.raises(ValueError, match="q_len=1"):
        tca.paged_decode_attention(q.expand(2, 3, 2, 16), arena, arena, table,
                                   lens, 4)
    with pytest.raises(ValueError, match="block_size"):
        tca.paged_decode_attention(q, arena, arena, table, lens, 0)


def test_paged_wrapper_raises_above_the_head_dim_limit_on_the_card(
        monkeypatch):
    """As the gathered wrapper: on the card's route a head dim above 256
    raises, naming the limit, before anything is built or launched."""
    monkeypatch.setattr(tca, "_on_cpu", lambda t: False)
    q, arena, table, lens = _inputs(d=272)
    before = dict(tca.LAUNCHES)
    for call in (
        lambda: tca.paged_decode_attention(q, arena, arena, table, lens, 4),
        lambda: tca.decode_attention(q, arena[None].expand(2, 20, 2, 272),
                                     arena[None].expand(2, 20, 2, 272), lens),
    ):
        with pytest.raises(ValueError, match="head_dim 272 is above the "
                           "kernels' limit of 256"):
            call()
    assert tca.LAUNCHES == before
