"""The port's LM serving path against the JAX package's, on the CPU.

``GenerationEngine(device="cpu")`` with the JAX engine's seeded weights
carried across must give the same greedy tokens, with logprobs within
1e-4 (float32 through two layers, summed in another order), across
KV-block boundaries; plus exact KV accounting, the KV-budget 429,
continuous batching, and one ``/generate`` round trip over loopback.
"""

import http.client
import json

import numpy as np
import pytest

from sparknet_tpu.models.transformer_lm import TransformerLM as JaxLM
from sparknet_tpu.serve import GenerationEngine as JaxEngine
from sparknet_tpu_torch.interop import lm_state_from_jax
from sparknet_tpu_torch.models.transformer_lm import TransformerLM
from sparknet_tpu_torch.serve import (
    GenerationEngine,
    KVBlockPool,
    KVBudgetExceeded,
    QueueFull,
    ServeServer,
    StreamBatcher,
)

T = 32
GEOM = dict(dim=32, depth=2, heads=2, seq_len=T, vocab=64)
SERVE = dict(prefill_buckets=(8, T), max_streams=3, kv_blocks=30,
             kv_block_size=4)
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_engine():
    eng = JaxEngine(JaxLM(**GEOM), seed=0, **SERVE)
    eng.warmup()
    return eng


def _port_engine(jax_engine, **overrides):
    eng = GenerationEngine(TransformerLM(**GEOM), device="cpu",
                           **dict(SERVE, **overrides))
    params = {g: [np.asarray(b) for b in blobs]
              for g, blobs in jax_engine.params.items()}
    eng.lm.load_state_dict(lm_state_from_jax(params, eng.lm))
    return eng


@pytest.fixture(scope="module")
def engine(jax_engine):
    eng = _port_engine(jax_engine)
    eng.warmup()
    return eng


def _run_stream(engine, prompt, max_new):
    blocks = engine.reserve(len(prompt), max_new)
    slot, tok, lp = engine.admit(prompt, max_new, blocks=blocks)
    toks, lps = [tok], [lp]
    while len(toks) < max_new:
        out = engine.step()
        toks.append(out[slot][0])
        lps.append(out[slot][1])
    engine.finish(slot)
    return toks, lps


def test_warmup_leaves_real_blocks_untouched_and_counts_shapes(engine):
    """Warm-up prefills drop every (out-of-bounds) pad row and the
    decode step writes only the trash block."""
    bs = engine.pool.block_size
    assert engine.jit_cache_size() == len(engine.buckets) + 2
    fresh = _port_engine_like(engine)
    fresh.warmup()
    assert not fresh.pool.k[:, bs:].any() and not fresh.pool.v[:, bs:].any()


def _port_engine_like(engine):
    eng = GenerationEngine(TransformerLM(**GEOM), device="cpu", **SERVE)
    eng.lm.load_state_dict(engine.lm.state_dict())
    return eng


@pytest.mark.parametrize("prompt,max_new", [([5, 9, 2], 18), ([1], 7),
                                            (list(range(3, 14)), 9)])
def test_greedy_tokens_match_jax_engine(jax_engine, engine, prompt, max_new):
    """Identical greedy tokens, logprobs within 1e-4, across KV-block
    boundaries (block_size 4) and both prefill buckets."""
    want_toks, want_lps = _run_stream(jax_engine, prompt, max_new)
    got_toks, got_lps = _run_stream(engine, prompt, max_new)
    assert got_toks == want_toks
    np.testing.assert_allclose(got_lps, want_lps, atol=ATOL)
    assert engine.pool.used() == 0


def test_concurrent_slots_match_jax_engine(jax_engine, engine):
    """Three interleaved streams with ragged positions through one
    fixed-shape decode step, against the same schedule on JAX."""
    specs = [([5, 9, 2, 7], 10), ([1, 2], 6), ([30, 31, 32, 33, 34], 8)]

    def run(eng):
        slots, got = [], {}
        for p, n in specs:
            slot, tok, _ = eng.admit(p, n)
            slots.append(slot)
            got[slot] = [tok]
        need = {s: n for s, (_, n) in zip(slots, specs)}
        while any(len(got[s]) < need[s] for s in slots):
            for s, (tok, _) in eng.step().items():
                got[s].append(tok)
                if len(got[s]) >= need[s]:
                    eng.finish(s)
        return [got[s] for s in slots]

    assert run(engine) == run(jax_engine)
    assert engine.jit_cache_size() == len(engine.buckets) + 2


def test_evict_then_reprefill_continues_exactly(engine):
    prompt, max_new = [7, 3, 11], 12
    want, _ = _run_stream(engine, prompt, max_new)
    slot, tok, _ = engine.admit(prompt, max_new)
    toks = [tok]
    for _ in range(4):
        toks.append(engine.step()[slot][0])
    engine.evict(slot)
    assert engine.pool.used() == 0
    slot2, tok2, _ = engine.admit(prompt + toks, max_new - len(toks))
    toks.append(tok2)
    while len(toks) < max_new:
        toks.append(engine.step()[slot2][0])
    engine.finish(slot2)
    assert toks == want


def test_score_tokens_matches_jax(jax_engine, engine):
    prompt, toks = [3, 1, 4], [1, 5, 9, 2, 6]
    np.testing.assert_allclose(
        engine.score_tokens(prompt, toks),
        jax_engine.score_tokens(prompt, toks), atol=ATOL,
    )


def test_kv_pool_exact_accounting_and_double_free():
    pool = KVBlockPool(2, 2, 8, num_blocks=6, block_size=4, device="cpu")
    assert tuple(pool.k.shape) == (2, 7 * 4, 2, 8)
    a = pool.alloc(2)
    b = pool.alloc(3)
    assert pool.used() == 5 and pool.free_blocks() == 1
    with pytest.raises(KVBudgetExceeded):
        pool.alloc(2)  # all-or-nothing: 2 > 1 free
    assert pool.used() == 5
    pool.free(a)
    with pytest.raises(ValueError, match="double free"):
        pool.free(a)
    with pytest.raises(ValueError, match="trash"):
        pool.free([0])
    pool.free(b)
    assert pool.used() == 0
    assert pool.allocated_total == pool.freed_total == 5
    row = pool.index_row([3, 1], 10)
    assert row.tolist() == [12, 13, 14, 15, 4, 5, 6, 7, 0, 0]
    m = pool.metrics.render()
    assert "sparknet_kv_alloc_total 5" in m and "sparknet_kv_free_total 5" in m


def test_admission_sheds_on_kv_budget(jax_engine):
    eng = _port_engine(jax_engine, prefill_buckets=(8,), max_streams=1,
                       kv_blocks=4)
    eng.warmup()
    blocks = eng.reserve(2, 6)  # 8 positions -> 2 blocks
    with pytest.raises(KVBudgetExceeded):
        eng.reserve(4, 12)  # needs 4 blocks, only 2 left
    slot, _, _ = eng.admit([1, 2], 6, blocks=blocks)
    b2 = eng.reserve(2, 6)
    with pytest.raises(RuntimeError, match="no free decode slot"):
        eng.admit([3, 4], 6, blocks=b2)
    eng.release(b2)
    eng.finish(slot)
    assert eng.pool.used() == 0
    assert eng.pool.allocated_total == eng.pool.freed_total > 0


def test_stream_batcher_continuous_join_and_exit(jax_engine, engine):
    """More streams than decode slots: short streams exit, queued ones
    join mid-flight, every stream's tokens equal its solo JAX run."""
    specs = [([5, 9, 2], 14), ([1, 2], 4), ([8, 8, 8], 4), ([4, 4], 5)]
    refs = [_run_stream(jax_engine, p, n)[0] for p, n in specs]
    sb = StreamBatcher(engine, max_queue=8)
    try:
        streams = [sb.submit_stream(p, n) for p, n in specs]
        finals = [st.result(timeout=60.0) for st in streams]
        assert [f["event"] for f in finals] == ["done"] * 4
        assert [f["tokens"] for f in finals] == refs
        occ = sb.m_occupancy
        assert occ.count > 0 and occ.sum / occ.count > 1 / 3
    finally:
        sb.stop(drain=True, timeout=30.0)
    assert engine.pool.used() == 0


def test_stream_batcher_sheds_queue_full(jax_engine):
    eng = _port_engine(jax_engine, prefill_buckets=(8,), max_streams=1)
    eng.warmup()
    sb = StreamBatcher(eng, max_queue=1)
    try:
        first = sb.submit_stream([1, 2], 16)
        shed = 0
        for _ in range(6):
            try:
                sb.submit_stream([3, 4], 16)
            except QueueFull:
                shed += 1
        assert shed > 0
        assert first.result(timeout=60.0)["event"] == "done"
        assert 'sparknet_gen_streams_shed_total{cause="queue_full"}' in (
            sb.metrics.render()
        )
    finally:
        sb.stop(drain=True, timeout=30.0)
    assert eng.pool.used() == 0


def _post(host, port, body):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("POST", "/generate", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def test_generate_round_trip_over_loopback(jax_engine):
    """Chunked NDJSON tokens equal the JAX engine's; a KV-budget
    overflow is a 429 with X-Shed-Cause before any chunk; /healthz,
    /metrics and the /predict pointer answer."""
    eng = _port_engine(jax_engine, kv_blocks=6)
    eng.warmup()
    server = ServeServer(eng, host="127.0.0.1", port=0)
    server.start()
    host, port = server.address
    try:
        resp, data = _post(host, port, {"prompt": [5, 9, 2], "max_new": 9})
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        events = [json.loads(x) for x in data.decode().splitlines()]
        assert [e["event"] for e in events] == ["token"] * 9 + ["done"]
        want_toks, want_lps = _run_stream(jax_engine, [5, 9, 2], 9)
        assert events[-1]["tokens"] == want_toks
        np.testing.assert_allclose(
            [e["logprob"] for e in events[:-1]], want_lps, atol=ATOL
        )
        # 24 + 8 positions need 8 blocks of 4; the arena has 6
        resp, data = _post(host, port, {"prompt": [1] * 24, "max_new": 8})
        assert resp.status == 429
        assert resp.getheader("X-Shed-Cause") == "kv_reserve"
        assert json.loads(data)["cause"] == "kv_reserve"
        resp, data = _post(host, port, {"prompt": [], "max_new": 4})
        assert resp.status == 400
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["status"] == "ok"
        conn.request("GET", "/metrics")
        m = conn.getresponse().read().decode()
        assert "sparknet_gen_tokens_total 9" in m
        assert 'sparknet_gen_streams_shed_total{cause="kv_reserve"} 1' in m
        assert "sparknet_kv_blocks_total 6" in m
        conn.request("POST", "/predict", body=b"{}")
        assert conn.getresponse().status == 404
        conn.close()
        server.initiate_drain()
        resp, _ = _post(host, port, {"prompt": [1, 2], "max_new": 2})
        assert resp.status == 503
        assert resp.getheader("X-Shed-Cause") == "draining"
    finally:
        server.shutdown(drain_timeout_s=10.0)
    assert eng.pool.used() == 0
    assert eng.pool.allocated_total == eng.pool.freed_total


def test_request_tracing_and_profiler_fold_a_stream(jax_engine):
    """With a tracer and a request profiler installed, a stream gets an
    id at admission that rides its queue/KV/prefill/decode/write spans,
    a KV refusal leaves a ``shed`` instant, and /healthz carries the
    profiler's block."""
    from sparknet_tpu_torch.obs import reqtrace, trace

    eng = _port_engine(jax_engine, kv_blocks=6)
    eng.warmup()
    tracer = trace.install_tracer(trace.Tracer())
    prof = reqtrace.install(
        reqtrace.RequestProfiler(registry=eng.pool.metrics, export_every=1)
    )
    server = ServeServer(eng, host="127.0.0.1", port=0)
    server.start()
    host, port = server.address
    try:
        resp, _ = _post(host, port, {"prompt": [5, 9, 2], "max_new": 5})
        assert resp.status == 200
        resp, _ = _post(host, port, {"prompt": [1] * 24, "max_new": 8})
        assert resp.status == 429
        code, health = server.health_payload()
        assert code == 200
        block = health["request_profile"]
        assert block["requests_profiled"] == 1
        assert block["sheds"] == {"kv_reserve": 1}
        assert block["verdict"] in reqtrace.BOUND_CODE
    finally:
        server.shutdown(drain_timeout_s=10.0)
        reqtrace.uninstall(prof)
        trace.uninstall_tracer()
    events = tracer.events()
    spans = {(e["name"], e.get("cat")) for e in events if e["ph"] == "X"}
    for want in [("request", "req"), ("queue_wait", "req"),
                 ("kv_reserve", "req"), ("prefill", "gen"),
                 ("decode_step", "gen"), ("stream_write", "req")]:
        assert want in spans, want
    rid = next(e["args"]["req"] for e in events if e["name"] == "request")
    assert any(e["name"] == "decode_step" and rid in e["args"]["reqs"]
               for e in events if e["ph"] == "X")
    sheds = [e for e in events if e["name"] == "shed"]
    assert [e["args"]["cause"] for e in sheds] == ["kv_reserve"]
    assert "sparknet_req_completed_total 1" in eng.pool.metrics.render()
    assert not reqtrace.tracing_enabled()
