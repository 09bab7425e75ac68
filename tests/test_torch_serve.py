"""The port's image serving path against the JAX package's, on the CPU.

Mirrors the JAX package's ``tests/test_serve.py`` (engine, micro-
batcher) and ``tests/test_serve_server.py`` (``/predict`` over HTTP:
``/healthz``, ``/metrics``, concurrent clients, 400/429/500/503/504,
keep-alive, drain, route gating) on ``InferenceEngine(device="cpu")``,
and holds the port to the JAX package on identical inputs:

- ``models.deploy_variant`` equals the JAX function's, field by field,
  for every zoo model, and raises where it raises;
- a narrow CaffeNet-shaped net (both LRNs, grouped conv2) gives the JAX
  engine's ``prob`` from the same seed and from a ``.caffemodel`` the
  JAX package wrote, within 1e-5 relative in float32;
- in bfloat16 both engines lie within ``BF16_ATOL`` of a float64 run and
  of each other (measured on this net and seed: JAX 5.35e-3 from
  float64, the port 3.84e-3, the two 3.91e-3 apart, i.e. two bf16 ulps
  at 0.5; ``BF16_ATOL`` is a bit over twice the larger distance);
- K5's bfloat16 plain version agrees with the JAX Pallas LRN
  (``pallas_lrn.lrn_across_channels``, interpret mode) on bf16 input.
"""

import dataclasses
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparknet_tpu import config as jconfig
from sparknet_tpu import models as jmodels
from sparknet_tpu.io import caffemodel as jcaffemodel
from sparknet_tpu.ops import pallas_lrn
from sparknet_tpu.serve import InferenceEngine as JaxEngine
from sparknet_tpu_torch import config, models
from sparknet_tpu_torch.io import caffemodel
from sparknet_tpu_torch.net import TorchNet
from sparknet_tpu_torch.ops import cuda_lrn
from sparknet_tpu_torch.ops.base import Layer
from sparknet_tpu_torch.serve import (
    InferenceEngine,
    MicroBatcher,
    QueueFull,
    ServeServer,
)
from sparknet_tpu_torch.tools import cli

TOY_DEPLOY = """
name: "toy"
input: "data"
input_shape { dim: 2 dim: 3 dim: 8 dim: 8 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3 weight_filler { type: "xavier" } } }
layer { name: "ip" type: "InnerProduct" bottom: "conv" top: "logits"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "logits" top: "prob" }
"""

TOY_TRAIN_TEST = """
name: "toy_tt"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 4 dim: 3 dim: 8 dim: 8 } shape { dim: 4 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "logits"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "acc" type: "Accuracy" bottom: "logits" bottom: "label" top: "accuracy"
  include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" }
"""

# CaffeNet's layer sequence at narrow widths: conv1 -> relu -> pool ->
# norm1 (LRN), grouped conv2 -> relu -> pool -> norm2, fc6 -> relu ->
# dropout, fc8, under a train/test head the engine takes to its deploy view
CAFFENET_NARROW = """
name: "caffenet_narrow"
layer { name: "data" type: "HostData" top: "data" top: "label"
  java_data_param { shape { dim: 4 dim: 3 dim: 35 dim: 35 } shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 12 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.05 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"
  convolution_param { num_output: 16 pad: 1 kernel_size: 3 group: 2
    weight_filler { type: "gaussian" std: 0.05 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm2" type: "LRN" bottom: "pool2" top: "norm2"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "fc6" type: "InnerProduct" bottom: "norm2" top: "fc6"
  inner_product_param { num_output: 32
    weight_filler { type: "gaussian" std: 0.05 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu6" type: "ReLU" bottom: "fc6" top: "fc6" }
layer { name: "drop6" type: "Dropout" bottom: "fc6" top: "fc6"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "fc8" type: "InnerProduct" bottom: "fc6" top: "fc8"
  inner_product_param { num_output: 10 weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "accuracy" type: "Accuracy" bottom: "fc8" bottom: "label" top: "accuracy"
  include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" bottom: "label" top: "loss" }
"""

FP32_RTOL = 1e-5
BF16_ATOL = 1.2e-2
# a row's output can move by an ulp with the bucket its batch ran at:
# torch's CPU products block by batch size (XLA's did not here)
ROW_RTOL = 1e-6
BUCKETS = (1, 4, 8)


@pytest.fixture(scope="module")
def engine():
    eng = InferenceEngine(
        config.parse_net_prototxt(TOY_DEPLOY), buckets=BUCKETS, device="cpu"
    )
    eng.warmup()
    return eng


def _narrow_input(n=5, seed=0):
    # x50: the LRN's scale moves off 1, so both LRNs matter in the output
    return np.random.RandomState(seed).randn(n, 3, 35, 35).astype(np.float32) * 50


# ---------------------------------------------------------------------------
# engine (tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_bucket_selection(engine):
    assert engine.bucket_for(1) == 1
    assert engine.bucket_for(2) == 4
    assert engine.bucket_for(4) == 4
    assert engine.bucket_for(5) == 8
    assert engine.bucket_for(8) == 8
    assert engine.bucket_for(9) == 8  # beyond the top bucket: caller chunks
    with pytest.raises(ValueError):
        engine.bucket_for(0)


def test_padding_shapes(engine):
    x = np.ones((3, 3, 8, 8), np.float32)
    padded, n = engine.pad_to_bucket(x)
    assert n == 3 and padded.shape == (4, 3, 8, 8)
    assert np.array_equal(padded[:3], x)
    assert not padded[3:].any()  # zero pad rows


def test_infer_byte_equal_with_single_shot_forward(engine):
    """Serving outputs equal ``TorchNet.forward`` at the same bucket
    shape bit for bit: pad rows change nothing for the real rows."""
    net = TorchNet(config.parse_net_prototxt(TOY_DEPLOY), phase="TEST")
    x = np.random.RandomState(0).randn(6, 3, 8, 8).astype(np.float32)
    out = engine.infer(x)
    padded, _ = engine.pad_to_bucket(x)
    with torch.inference_mode():
        ref = net.forward(engine.params, engine.stats,
                          {"data": torch.from_numpy(padded)})["prob"]
    ref = ref.numpy()[:6]
    assert out.dtype == ref.dtype == np.float32
    assert np.array_equal(out, ref)


def test_infer_single_item_and_oversized(engine):
    one = engine.infer(np.zeros((3, 8, 8), np.float32))  # no batch dim
    assert one.shape == (1, 5)
    big = engine.infer(np.zeros((19, 3, 8, 8), np.float32))  # > max bucket
    assert big.shape == (19, 5)


def test_no_new_shape_after_warmup(engine):
    before = engine.jit_cache_size()
    assert before == len(engine.buckets)
    for n in (1, 2, 3, 5, 8, 11):
        engine.infer(np.zeros((n, 3, 8, 8), np.float32))
    assert engine.jit_cache_size() == before


def test_train_test_config_derives_deploy_view():
    eng = InferenceEngine(
        config.parse_net_prototxt(TOY_TRAIN_TEST), buckets=(1, 2),
        device="cpu",
    )
    assert eng.data_blob == "data"
    assert eng.output_blob == "prob"
    assert eng.warmup() == 2
    out = eng.infer(np.zeros((2, 3, 8, 8), np.float32))
    assert out.shape == (2, 5)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)


def test_engine_rejects_bad_shapes(engine):
    with pytest.raises(ValueError):
        engine.run_padded(np.zeros((3, 3, 8, 8), np.float32))  # not a bucket
    with pytest.raises(ValueError):
        engine.run_padded(np.zeros((4, 3, 7, 7), np.float32))  # item shape
    with pytest.raises(ValueError):
        InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY),
                        buckets=(0, 4), device="cpu")
    with pytest.raises(ValueError):
        InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY),
                        output_blob="nope", device="cpu")


def test_engine_loads_caffemodel_weights(tmp_path):
    eng0 = InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY),
                           buckets=(2,), seed=3, device="cpu")
    path = str(tmp_path / "toy.caffemodel")
    caffemodel.save_weights(
        caffemodel.net_blobs(eng0.net, eng0.params, eng0.stats), path)
    eng1 = InferenceEngine(
        config.parse_net_prototxt(TOY_DEPLOY), weights=path, buckets=(2,),
        seed=9, device="cpu",  # another init seed: weights come from the file
    )
    x = np.random.RandomState(2).randn(2, 3, 8, 8).astype(np.float32)
    assert np.array_equal(eng0.infer(x), eng1.infer(x))


def test_engine_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY), buckets=(1,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--net", "caffenet", "--dtype", "bfloat16"])


# ---------------------------------------------------------------------------
# micro-batcher (tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_batcher_demux_matches_single_shot(engine):
    mb = MicroBatcher(engine, max_queue=32, max_wait_ms=50.0)
    try:
        x = np.random.RandomState(1).randn(6, 3, 8, 8).astype(np.float32)
        ref = engine.infer(x)
        results = {}

        def client(i):
            results[i] = mb.submit(x[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(6):
            assert results[i].shape == (1, 5)
            np.testing.assert_allclose(results[i][0], ref[i], rtol=ROW_RTOL)
        assert mb.m_batches.value < 6  # concurrency coalesced
        assert mb.m_images.value == 6
        assert mb.m_occupancy.count == mb.m_batches.value
        assert mb.m_latency.count == 6
    finally:
        mb.stop()


def test_batcher_multi_item_requests(engine):
    mb = MicroBatcher(engine, max_queue=32, max_wait_ms=1.0)
    try:
        x = np.random.RandomState(4).randn(5, 3, 8, 8).astype(np.float32)
        assert np.array_equal(mb.submit(x), engine.infer(x))
        big = np.random.RandomState(5).randn(11, 3, 8, 8).astype(np.float32)
        assert np.array_equal(mb.submit(big), engine.infer(big))
    finally:
        mb.stop()


def test_batcher_queue_full_sheds(engine):
    mb = MicroBatcher(engine, max_queue=2, max_wait_ms=200.0)
    try:
        x = np.zeros((1, 3, 8, 8), np.float32)
        for _ in range(2):
            threading.Thread(target=lambda: mb.submit(x), daemon=True).start()
        deadline = 50
        while mb.queue_depth() < 2 and deadline:
            threading.Event().wait(0.01)
            deadline -= 1
        assert mb.queue_depth() == 2
        with pytest.raises(QueueFull):
            mb.submit(x)
        assert mb.m_shed.value == 1
    finally:
        mb.stop()


def test_batcher_drain_serves_queued_then_rejects(engine):
    mb = MicroBatcher(engine, max_queue=32, max_wait_ms=50.0)
    x = np.zeros((1, 3, 8, 8), np.float32)
    results = []
    threads = [
        threading.Thread(target=lambda: results.append(mb.submit(x)))
        for _ in range(3)
    ]
    for t in threads:
        t.start()
    while mb.queue_depth() < 3:
        threading.Event().wait(0.005)
    mb.stop(drain=True)  # drain: queued requests still get answers
    for t in threads:
        t.join(10.0)
    assert len(results) == 3
    with pytest.raises(RuntimeError):
        mb.submit(x)


def test_serve_metrics_shim_is_the_obs_registry():
    from sparknet_tpu_torch.obs import metrics as obs_metrics
    from sparknet_tpu_torch.serve.metrics import (
        Counter,
        Gauge,
        Histogram,
        MetricsRegistry,
    )

    assert Counter is obs_metrics.Counter and Gauge is obs_metrics.Gauge
    assert Histogram is obs_metrics.Histogram
    assert MetricsRegistry is obs_metrics.MetricsRegistry


# ---------------------------------------------------------------------------
# /predict over HTTP (tests/test_serve_server.py)
# ---------------------------------------------------------------------------

def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, r.read().decode()


def _post_predict(base, x, timeout=60):
    req = urllib.request.Request(
        base + "/predict",
        data=json.dumps({"data": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _start(engine, **kw):
    srv = ServeServer(engine, port=0, **kw)
    srv.start()
    host, port = srv.address
    return srv, f"http://{host}:{port}"


@pytest.fixture()
def server():
    engine = InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY),
                             buckets=BUCKETS, device="cpu")
    engine.warmup()
    srv, base = _start(engine, max_queue=64, max_wait_ms=50.0)
    yield srv, engine, base
    srv.shutdown()


def test_healthz_and_metrics_endpoints(server):
    _srv, _engine, base = server
    status, body = _get(base, "/healthz")
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, body = _get(base, "/metrics")
    assert status == 200
    assert "serve_requests_total" in body
    assert "serve_jit_cache_size 3" in body
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base, "/nope")
    assert ei.value.code == 404


def test_concurrent_clients_get_correct_outputs(server):
    _srv, engine, base = server
    n_clients = 12
    x = np.random.RandomState(0).randn(n_clients, 3, 8, 8).astype(np.float32)
    ref = engine.infer(x)
    shapes_before = engine.jit_cache_size()
    results, errors = {}, []

    def client(i):
        try:
            status, out = _post_predict(base, x[i])
            results[i] = (status, np.asarray(out["outputs"], np.float32))
        except BaseException as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    for i in range(n_clients):
        status, out = results[i]
        assert status == 200 and out.shape == (1, 5)
        np.testing.assert_allclose(out[0], ref[i], rtol=ROW_RTOL)
    assert engine.jit_cache_size() == shapes_before
    _status, metrics = _get(base, "/metrics")
    lines = dict(line.rsplit(" ", 1) for line in metrics.splitlines()
                 if line and not line.startswith("#"))
    assert float(lines["serve_requests_total"]) == n_clients
    assert float(lines["serve_images_total"]) == n_clients
    assert float(lines["serve_batch_occupancy_sum"]) > 0
    assert 0 < float(lines["serve_batches_total"]) < n_clients


def test_batched_request_roundtrip(server):
    _srv, engine, base = server
    x = np.random.RandomState(3).randn(5, 3, 8, 8).astype(np.float32)
    status, out = _post_predict(base, x)
    assert status == 200 and out["batched"] == 5
    assert out["shape"] == [5, 5]
    assert np.array_equal(np.asarray(out["outputs"], np.float32),
                          engine.infer(x))


def test_predict_bad_input_is_400(server):
    _srv, _engine, base = server
    for payload in (b"{}", b"not json", b'{"data": [[1, 2]]}', b'{"data": []}'):
        req = urllib.request.Request(base + "/predict", data=payload)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400


def test_keepalive_survives_early_return_paths(server):
    """Early-return responses (404 route, bad input) consume the body,
    or the leftover bytes would corrupt the next request on the same
    HTTP/1.1 connection."""
    _srv, _engine, base = server
    host, port = base[len("http://"):].rsplit(":", 1)
    body = b'{"data": [1, 2, 3]}'

    def read_response(sock):
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                return buf
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        clen = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                clen = int(line.split(b":", 1)[1])
        while len(rest) < clen:
            rest += sock.recv(65536)
        return head

    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(b"POST /nope HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert read_response(s).startswith(b"HTTP/1.1 404")
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert read_response(s).startswith(b"HTTP/1.1 400")
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        assert read_response(s).startswith(b"HTTP/1.1 200")


def test_queue_overflow_sheds_with_429():
    engine = InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY),
                             buckets=BUCKETS, device="cpu")
    engine.warmup()
    srv, base = _start(engine, max_queue=2, max_wait_ms=500.0)
    try:
        x = np.zeros((1, 3, 8, 8), np.float32)
        codes, retry_after = [], []
        lock = threading.Lock()

        def client():
            try:
                code = _post_predict(base, x)[0]
            except urllib.error.HTTPError as e:
                code = e.code
                retry_after.append(e.headers.get("Retry-After"))
            with lock:
                codes.append(code)

        threads = [threading.Thread(target=client) for _ in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert codes.count(429) >= 1, codes
        assert codes.count(200) >= 2, codes
        assert set(codes) <= {200, 429}, codes
        assert set(retry_after) == {"1"}
        assert "serve_requests_shed_total" in _get(base, "/metrics")[1]
    finally:
        srv.shutdown()


def test_engine_errors_are_500_and_timeouts_504(engine):
    """A failing forward is a 500, never a 503 (CUDA errors are
    ``RuntimeError``s: only a drain or an unservable fleet is 503); a
    request not served in time is a 504."""
    eng = InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY),
                          buckets=BUCKETS, device="cpu")
    eng.warmup()
    gate = threading.Event()

    def run_padded(px):
        if px[0, 0, 0, 0] == 7:
            raise RuntimeError("CUDA error: an illegal memory access")
        gate.wait(5.0)
        return InferenceEngine.run_padded(eng, px)

    eng.run_padded = run_padded
    srv, base = _start(eng, max_wait_ms=1.0, request_timeout_s=0.3)
    try:
        bad = np.zeros((1, 3, 8, 8), np.float32)
        bad[0, 0, 0, 0] = 7
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_predict(base, bad)
        assert ei.value.code == 500
        assert "CUDA error" in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_predict(base, np.zeros((1, 3, 8, 8), np.float32))
        assert ei.value.code == 504
    finally:
        gate.set()
        srv.shutdown()


def test_graceful_drain_completes_inflight_work():
    engine = InferenceEngine(config.parse_net_prototxt(TOY_DEPLOY),
                             buckets=(1, 4), device="cpu")
    engine.warmup()
    srv, base = _start(engine, max_queue=32, max_wait_ms=100.0)
    x = np.zeros((1, 3, 8, 8), np.float32)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(_post_predict(base, x)[0]))
        for _ in range(3)]
    for t in threads:
        t.start()
    while srv.batcher.queue_depth() < 3:
        threading.Event().wait(0.005)
    srv.initiate_drain()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base, "/healthz")
    assert ei.value.code == 503
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_predict(base, x)
    assert ei.value.code == 503
    srv.shutdown()
    for t in threads:
        t.join(30)
    assert results == [200, 200, 200]


def test_generate_and_predict_routes_are_gated(server):
    """A prediction server 404s ``/generate`` and a generation server
    ``/predict``, each with a pointer to its own route."""
    from sparknet_tpu_torch.models.transformer_lm import TransformerLM
    from sparknet_tpu_torch.serve import GenerationEngine

    _s, _e, clf_base = server
    gen = GenerationEngine(
        TransformerLM(dim=32, depth=1, heads=2, seq_len=16, vocab=64),
        prefill_buckets=(8,), max_streams=2, kv_blocks=8, kv_block_size=4,
        device="cpu")
    gen.warmup()
    gsrv, gen_base = _start(gen)
    try:
        req = urllib.request.Request(
            clf_base + "/generate",
            data=json.dumps({"prompt": [1], "max_new": 2}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 404
        assert "/predict" in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_predict(gen_base, np.zeros((1, 3, 8, 8), np.float32))
        assert ei.value.code == 404
        assert "/generate" in json.loads(ei.value.read())["error"]
    finally:
        gsrv.shutdown()


def test_cli_serve_predict_in_process(tmp_path):
    """``cli serve --net`` on the CPU: one engine, then a fleet of two
    with ``--dtype bfloat16`` and a watch directory — no refusal."""
    x = _narrow_input(3)
    proto = tmp_path / "net.prototxt"
    proto.write_text(CAFFENET_NARROW)
    want = InferenceEngine(config.parse_net_prototxt(CAFFENET_NARROW),
                           buckets=(4,), device="cpu").infer(x)
    for extra in ([], ["--replicas", "2", "--dtype", "bfloat16",
                       "--watch", str(tmp_path / "pub")]):
        got = {}
        assert cli.main(["serve", "--net", str(proto), "--device", "cpu",
                         "--port", "0", "--buckets", "1,4"] + extra,
                        result=got) == 0
        srv = got["server"]
        srv.start()
        host, port = srv.address
        try:
            status, out = _post_predict(f"http://{host}:{port}", x)
            assert status == 200 and out["batched"] == 3
            tol = BF16_ATOL if extra else 0.0
            np.testing.assert_allclose(out["outputs"], want, rtol=0, atol=tol)
            if extra:
                assert (got["delivery"] is not None
                        and got["delivery"].phase == "idle")
        finally:
            srv.shutdown()


@pytest.mark.parametrize("extra", [[], ["--replicas", "2", "--watch", None]],
                         ids=["engine", "fleet+watch"])
def test_cli_serve_unstarted_server_shuts_down(tmp_path, extra):
    """A server ``cli.main(result=)`` hands back is shut down without
    ever being started: shutdown returns, the batchers and the watcher
    stop, and the listening socket closes."""
    proto = tmp_path / "net.prototxt"
    proto.write_text(CAFFENET_NARROW)
    extra = [str(tmp_path / "pub") if a is None else a for a in extra]
    got = {}
    assert cli.main(["serve", "--net", str(proto), "--device", "cpu",
                     "--port", "0", "--buckets", "1,4"] + extra,
                    result=got) == 0
    srv = got["server"]
    t = threading.Thread(target=srv.shutdown, daemon=True)
    t.start()
    t.join(30)
    assert not t.is_alive(), "shutdown of an unstarted server hung"
    assert srv.httpd.socket.fileno() == -1
    if got["delivery"] is not None:
        assert got["delivery"]._thread is None
    batchers = ([r.batcher for r in srv.router.pool.replicas]
                if srv.router is not None else [srv.batcher])
    for b in batchers:
        with pytest.raises(RuntimeError, match="stopped or draining"):
            b.submit(_narrow_input(1), timeout=1.0)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _same_fields(ours, theirs, path="net"):
    """Field-by-field equality over the schema fields both packages
    define; a field only the JAX schema has must be empty there."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict), path
        for k, v in theirs.items():
            if k in ours:
                _same_fields(ours[k], v, f"{path}.{k}")
            else:
                assert not v, f"{path}.{k} = {v!r} has no port field"
        assert set(ours) <= set(theirs), (path, set(ours) - set(theirs))
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _same_fields(a, b, f"{path}[{i}]")
    else:
        assert ours == theirs, (path, ours, theirs)


@pytest.mark.parametrize("name", models.available_models())
def test_deploy_variant_matches_the_jax_package(name):
    assert name in jmodels.available_models()
    ours = models.deploy_variant(models.load_model(name), batch=2)
    theirs = jmodels.deploy_variant(jmodels.load_model(name), batch=2)
    _same_fields(dataclasses.asdict(ours), dataclasses.asdict(theirs))
    assert ours.layer[0].type == "Input"
    assert ours.layer[0].input_param.shape[0].dim[0] == 2


@pytest.mark.parametrize("text", [
    TOY_TRAIN_TEST,
    CAFFENET_NARROW,
    # a data layer that declares no shapes: both raise the same error
    'name: "n" layer { name: "d" type: "HostData" top: "data" top: "label" }'
    ' layer { name: "ip" type: "InnerProduct" bottom: "data" top: "o"'
    ' inner_product_param { num_output: 2 } }',
], ids=["toy", "caffenet_narrow", "no_shapes"])
def test_deploy_variant_of_configs_matches_or_raises_alike(text):
    try:
        theirs = jmodels.deploy_variant(jconfig.parse_net_prototxt(text))
    except ValueError as e:
        with pytest.raises(ValueError, match="declares no shapes"):
            models.deploy_variant(config.parse_net_prototxt(text))
        assert "declares no shapes" in str(e)
        return
    ours = models.deploy_variant(config.parse_net_prototxt(text))
    _same_fields(dataclasses.asdict(ours), dataclasses.asdict(theirs))


def test_engine_matches_the_jax_engine_from_the_seed():
    """Same seed, same numpy input: the port's ``prob`` lies within 1e-5
    (relative) of the JAX engine's in float32."""
    x = _narrow_input()
    ours = InferenceEngine(config.parse_net_prototxt(CAFFENET_NARROW),
                           buckets=BUCKETS, seed=3, device="cpu")
    theirs = JaxEngine(jconfig.parse_net_prototxt(CAFFENET_NARROW),
                       buckets=BUCKETS, seed=3)
    assert ours.output_blob == theirs.output_blob == "prob"
    assert ours.item_shape == theirs.item_shape == (3, 35, 35)
    want = np.asarray(theirs.infer(x))
    got = ours.infer(x)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=FP32_RTOL, atol=0)


def test_engine_serves_a_jax_written_caffemodel(tmp_path):
    theirs = JaxEngine(jconfig.parse_net_prototxt(CAFFENET_NARROW),
                       buckets=(4,), seed=7)
    path = str(tmp_path / "narrow.caffemodel")
    jcaffemodel.save_weights(
        jcaffemodel.net_blobs(theirs.net, theirs.params, theirs.stats), path,
        net_name="caffenet_narrow")
    ours = InferenceEngine(config.parse_net_prototxt(CAFFENET_NARROW),
                           weights=path, buckets=(4,), seed=0, device="cpu")
    x = _narrow_input(4, seed=1)
    np.testing.assert_allclose(ours.infer(x), np.asarray(theirs.infer(x)),
                               rtol=FP32_RTOL, atol=0)


def test_bf16_engine_matches_the_jax_engine_within_the_float64_bound():
    x = _narrow_input()
    netp, jnetp = (config.parse_net_prototxt(CAFFENET_NARROW),
                   jconfig.parse_net_prototxt(CAFFENET_NARROW))
    ours = InferenceEngine(netp, buckets=BUCKETS, seed=3,
                           compute_dtype="bfloat16", device="cpu")
    theirs = JaxEngine(jnetp, buckets=BUCKETS, seed=3,
                       compute_dtype="bfloat16")
    exact = InferenceEngine(netp, buckets=BUCKETS, seed=3,
                            compute_dtype="float64", device="cpu").infer(x)
    got = ours.infer(x)
    want = np.asarray(theirs.infer(x))
    assert str(want.dtype) == "bfloat16"
    # numpy has no bfloat16: the port hands out the bf16 values as float32
    assert got.dtype == np.float32
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))
    want = want.astype(np.float32)
    assert np.abs(got - exact).max() <= BF16_ATOL
    assert np.abs(want - exact).max() <= BF16_ATOL
    assert np.abs(got - want).max() <= BF16_ATOL
    assert np.array_equal(got.argmax(1), exact.argmax(1))


def test_bf16_net_keeps_losses_labels_and_masters_in_float32():
    """``compute_dtype``: parameters stay float32 masters, the loss layer
    sums in float32, labels are never cast, and the port's bf16 loss lies
    near the JAX net's bf16 loss on the same batch."""
    from sparknet_tpu.net import JaxNet

    assert Layer.MIXED_PRECISION_EXEMPT is False
    rs = np.random.RandomState(0)
    batch = {"data": (rs.randn(4, 3, 35, 35) * 50).astype(np.float32),
             "label": rs.randint(0, 10, 4).astype(np.float32)}
    net = TorchNet(config.parse_net_prototxt(CAFFENET_NARROW), phase="TEST",
                   compute_dtype="bfloat16")
    params, stats = net.init(3)
    out = net.apply(params, stats,
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert all(b.dtype == torch.float32 for bl in params.values() for b in bl)
    assert out.loss.dtype == torch.float32
    assert out.blobs["label"].dtype == torch.float32
    assert out.blobs["fc8"].dtype == torch.bfloat16
    jnet = JaxNet(jconfig.parse_net_prototxt(CAFFENET_NARROW), phase="TEST",
                  compute_dtype="bfloat16")
    jp, js = jnet.init(3)
    jout = jnet.apply(jp, js, batch, train=False)
    assert abs(float(out.loss) - float(jout.loss)) <= BF16_ATOL * 4


@pytest.mark.parametrize("shape", [(2, 96, 13, 13), (2, 7, 11, 13), (1, 3, 5, 9)])
def test_lrn_bf16_plain_version_matches_the_pallas_kernel(shape):
    """K5's bf16 plain version (float32 math on the widened input, one
    rounding to bf16) equals the JAX Pallas LRN in interpret mode on the
    same bf16 input, within one bf16 ulp."""
    x = (np.random.RandomState(1).randn(*shape) * 3).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pallas_lrn.lrn_across_channels(
        xb, 5, 1e-4, 0.75, 1.0, True)).astype(np.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = cuda_lrn.lrn_fwd(xt, 5, 1e-4, 0.75, 1.0)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.abs(want) * 2.0 ** -7  # one bf16 ulp bounds |x| * 2^-7
    assert np.all(np.abs(got - want) <= np.maximum(ulp, 1e-30))
    assert np.array_equal(got, cuda_lrn.lrn_fwd_bf16_reference(
        xt, 5, 1e-4, 0.75, 1.0).float().numpy())
