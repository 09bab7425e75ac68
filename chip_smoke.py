#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: build, check, serve, train.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc)::

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):

1. The card's name and power limit (``nvidia-smi``), and the build of
   every CUDA kernel of the port from ``sparknet_tpu_torch/ops/csrc``.
2. Each kernel against its plain PyTorch version on the card, in
   float32, at the serving path's shapes — flash forward (causal and
   not, T in 16..256, a ragged T_q, a block of fully-masked rows) and
   decode attention (8 slots x 256 positions, ragged lengths) — then
   each kernel's time beside its plain version's, one PyTorch library
   call's (``scaled_dot_product_attention``, a yardstick the port never
   calls) and the least time the card could take.
3. End to end at the CLI's default model (``TransformerLM(dim=256,
   depth=4, heads=4, seq_len=256)``, seeded weights): the engine is
   built and warmed as ``cli serve --generate`` does, ``ServeServer``
   listens on a loopback port, and 4 concurrent ``POST /generate``
   streams of 32 tokens are read back.  Kernel launch counts are reset
   just before the requests and read just after.  Every streamed
   logprob is held against a CPU copy of the same model (plain
   attention) scoring the same tokens teacher-forced, and every token
   against the CPU model's argmax except where its top-2 logit margin
   is a near-tie.

4. The comm plane's epilogue kernels — K9 encode, K10 barriered apply,
   K11 overlap correction — against their plain versions on the card,
   bit for bit, at the three comm chunks of cifar10_full at W=4: fp32,
   bf16 and int8, the error readout on and off, a masked worker and no
   survivors for K10, an all-zero leaf.  Then each kernel's time over
   one round's launches (every chunk) beside its plain version's and the
   least time the card could take (bytes over 3.35 TB/s); no single
   PyTorch call computes these functions, so there is no library time.
5. The training main path: ``apps.cifar_app.main`` in process on
   synthesized CIFAR (5,000 train / 1,000 test), cifar10_full, 4
   workers, tau 10, batch 100, in three legs — no compression,
   ``--compress int8`` and ``--compress bf16 --overlap_avg``.  Launch
   counts are reset before each leg and read after it, and must match
   the chunk arithmetic (3 chunks: 3 K9 + 3 K10 per int8 round; 3 K9 per
   overlapped round and 3 K11 per round landed, the last at finalize).
   Each compressed leg's final smoothed loss is held within the JAX
   package's LOSS_BAND (0.08) of the uncompressed leg's, each leg's
   first round against the same round on the CPU, and one int8 round is
   profiled (device busy share, top kernels, K9-K11's share).

6. The flash backward kernels — K3 (dq) and K4 (dk/dv) — against their
   plain versions on the card, in float32, with a nonzero ``dlse``: the
   training shape (B=8, T=256, H=4, D=64, causal), non-causal, a ragged
   T_q, offsets (0, 64) with fully-masked rows, D=32 and D=128.  Then
   each kernel's time beside its plain version's and the least time the
   card could take, and, for K3 and K4 together, the library yardstick
   ``scaled_dot_product_attention`` forward+backward minus its forward.
7. The LM training main path: ``apps.lm_app.main`` in process at the
   CLI's model width (dim 256, depth 4, heads 4, seq_len 256), W=2,
   tau 4, batch 8, 6 rounds, in two legs — the default (flash: K1, K3,
   K4) and ``--dense_attention``.  Launch counts are reset before each
   leg and read after it: the flash leg launches exactly depth x W x
   tau x rounds = 192 each of K1, K3 and K4, the dense leg none.  Both
   legs' losses are finite and fall from ~ln 256; the flash leg's
   per-round losses and final params lie within LM_TOL (5e-4) of the
   dense leg's; its first round on the card matches the same round on
   the CPU relative to the update; one flash round is profiled.

The second-to-last line is ``{"kernels": [...]}`` (K1, K2, K3, K4, K9,
K10, K11); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import json
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# float32 on both sides; the kernels sum tile by tile (online softmax)
# where the plain versions sum densely, so results agree to rounding
KERNEL_ATOL = 2e-5
# streamed logprobs vs the CPU model's teacher-forced scores: float32
# through 4 layers, summed in another order on another device
LOGPROB_ATOL = 1e-4
# a token may differ from the CPU argmax only where the CPU's top-2
# logits are this close (seeded random weights give near-ties)
TIE_MARGIN = 1e-4
# the flash backward against its plain version: 2e-5 of the largest
# magnitude of the plain output (float32 sums of up to T products, in
# another order)
BWD_RTOL = 2e-5

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32
# operations/s outside the tensor cores (the kernels run fp32 FMA)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

CLI_MODEL = dict(dim=256, depth=4, heads=4, seq_len=256)
CLI_SERVE = dict(
    prefill_buckets=(16, 32, 64, 128), max_streams=8, kv_blocks=64,
    kv_block_size=16,
)
PROMPT_LENS = (5, 23, 50, 100)
MAX_NEW = 32


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 50, warm: int = 5) -> float:
    """Mean device time of one call, CUDA events around ``iters``
    back-to-back calls after ``warm`` untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n: int = 20):
    """Device time of one call without the host's launch cost: ``n``
    calls captured in one CUDA graph, the graph replayed between CUDA
    events, divided by ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, iters=10, warm=2) / n


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    """Max |got - want| over entries finite in ``want``; infinities must
    match exactly (the (0, -inf) rule of masked rows)."""
    inf = torch.isinf(want)
    check(bool(torch.equal(torch.isinf(got), inf)), "infinities differ")
    check(bool(torch.equal(got[inf], want[inf])), "infinity signs differ")
    check(not bool(torch.isnan(got).any()), "NaN in kernel output")
    if bool(inf.all()):
        return 0.0
    return float((got[~inf] - want[~inf]).abs().max())


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
def check_kernels(dev):
    """Hold each kernel against its plain version; return the per-kernel
    records (without launch counts) for the kernels line."""
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    B, H, D = 1, 4, 64
    flash_err = 0.0
    cases = [(t, t, False) for t in (16, 32, 64, 128, 256)]
    cases += [(t, t, True) for t in (16, 32, 64, 128, 256)]
    cases += [(37, 37, True), (37, 128, True), (37, 128, False)]
    for tq, tk, causal in cases:
        q, k, v = rand(B, tq, H, D), rand(B, tk, H, D), rand(B, tk, H, D)
        o, lse = ca._flash_core(q, k, v, tk - tq, 0, causal)
        o_ref, lse_ref = ca._flash_core_reference(q, k, v, tk - tq, 0, causal)
        e = max(max_err(o, o_ref), max_err(lse, lse_ref))
        print(f"K1 flash_fwd tq={tq} tk={tk} causal={causal}: "
              f"max_abs_err {e:.3e}")
        check(e <= KERNEL_ATOL, f"flash_fwd disagrees at {tq}x{tk}: {e}")
        flash_err = max(flash_err, e)
    # absolute offsets: keys start at 64, so query rows 0..63 see nothing
    q, k, v = rand(B, 128, H, D), rand(B, 128, H, D), rand(B, 128, H, D)
    o, lse = ca._flash_core(q, k, v, 0, 64, True)
    o_ref, lse_ref = ca._flash_core_reference(q, k, v, 0, 64, True)
    check(bool((o[:, :64] == 0).all()), "masked rows must give o = 0")
    e = max(max_err(o, o_ref), max_err(lse, lse_ref))
    print(f"K1 flash_fwd offsets (0, 64), 64 fully-masked rows: "
          f"max_abs_err {e:.3e}")
    check(e <= KERNEL_ATOL, f"flash_fwd disagrees with offsets: {e}")
    flash_err = max(flash_err, e)

    # decode attention at the serving decode shape
    Bd, S = CLI_SERVE["max_streams"], CLI_MODEL["seq_len"]
    lengths = torch.tensor([1, 17, 256, 100, 200, 64, 128, 255],
                           dtype=torch.int32, device=dev)
    qd, kd, vd = rand(Bd, 1, H, D), rand(Bd, S, H, D), rand(Bd, S, H, D)
    od = ca.decode_attention(qd, kd, vd, lengths)
    od_ref = ca.decode_attention_reference(qd, kd, vd, lengths)
    dec_err = max_err(od, od_ref)
    print(f"K2 decode_attention B={Bd} S={S} lengths "
          f"{lengths.tolist()}: max_abs_err {dec_err:.3e}")
    check(dec_err <= KERNEL_ATOL, f"decode_attention disagrees: {dec_err}")

    def timed(record, kernel, plain, library=None):
        """Per-call times of the kernel, its plain version and the
        library call: on the device (``ms``, ``plain_ms``,
        ``library_ms``: CUDA-graph replays, no host launch cost) and as
        a caller waits (``call_ms`` etc.: CUDA events around
        back-to-back calls, the host's launch cost included)."""
        for key, fn in (("", kernel), ("plain_", plain),
                        ("library_", library)):
            if fn is not None:
                record[key + "ms"] = device_ms(fn)
                record[key + "call_ms"] = time_ms(fn)
        return record

    # times at every prefill bucket and the scorer's T=256, causal
    for t in (16, 32, 64, 128, 256):
        q, k, v = rand(B, t, H, D), rand(B, t, H, D), rand(B, t, H, D)
        r = timed({}, lambda: ca.flash_attention(q, k, v, True),
                  lambda: ca.flash_attention_reference(q, k, v, True))
        print(f"K1 flash_fwd T={t} causal: kernel {r['ms']:.4f} ms on "
              f"device ({r['call_ms']:.4f} ms per call), plain "
              f"{r['plain_ms']:.4f} ms ({r['plain_call_ms']:.4f} ms)")
    T = CLI_SERVE["prefill_buckets"][-1]
    q, k, v = rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = B * H * T * (T + 1) // 2  # visible (query, key) pairs
    flash_bytes = 4 * (4 * B * T * H * D + B * H * T)  # q,k,v,o + lse
    fb, fby = bound_ms(flash_bytes, 4 * D * pairs)  # 2 products, 2 ops/MAC
    flash = timed(
        dict(
            name="flash_fwd", route="cuda",
            source="sparknet_tpu_torch/ops/csrc/flash_fwd.cu",
            replaces="sparknet_tpu/ops/pallas_attention.py:67",
            max_abs_err=flash_err, bound_ms=fb, bound_by=fby,
            shape=f"B={B} T={T} H={H} D={D} causal fp32",
        ),
        lambda: ca.flash_attention(q, k, v, True),
        lambda: ca.flash_attention_reference(q, k, v, True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
    )

    n_valid = int(lengths.sum())
    dec_bytes = 4 * (2 * Bd * H * D + 2 * n_valid * H * D + Bd)
    db, dby = bound_ms(dec_bytes, 4 * H * D * n_valid)
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    qdt, kdt, vdt = (x.transpose(1, 2) for x in (qd, kd, vd))
    decode = timed(
        dict(
            name="decode_attention", route="cuda",
            source="sparknet_tpu_torch/ops/csrc/decode_attention.cu",
            replaces="sparknet_tpu/ops/pallas_attention.py:320",
            max_abs_err=dec_err, bound_ms=db, bound_by=dby,
            shape=f"B={Bd} S={S} H={H} D={D} sum(lengths)={n_valid} fp32",
        ),
        lambda: ca.decode_attention(qd, kd, vd, lengths),
        lambda: ca.decode_attention_reference(qd, kd, vd, lengths),
        lambda: F.scaled_dot_product_attention(qdt, kdt, vdt, attn_mask=mask),
    )
    for r in (flash, decode):
        print(f"{r['name']} [{r['shape']}] on device (per call as a caller "
              f"waits): kernel {r['ms']:.4f} ms ({r['call_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms ({r['plain_call_ms']:.4f}), library "
              f"{r['library_ms']:.4f} ms ({r['library_call_ms']:.4f}), bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    return [flash, decode]


# ----------------------------------------------------------------------
# phase 3: the main path — cli serve --generate, 4 concurrent streams
# ----------------------------------------------------------------------
def _stream(host, port, prompt, out, i):
    conn = http.client.HTTPConnection(host, port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/generate",
                 body=json.dumps({"prompt": prompt, "max_new": MAX_NEW}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, t_first = [], None
    for line in resp:
        if not line.strip():
            continue
        ev = json.loads(line)
        if t_first is None:
            t_first = time.perf_counter() - t0
        events.append(ev)
    conn.close()
    out[i] = dict(status=resp.status, events=events, ttft_s=t_first,
                  total_s=time.perf_counter() - t0)


def serve_end_to_end(dev, card):
    from sparknet_tpu_torch.models.transformer_lm import TransformerLM
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.serve import GenerationEngine, ServeServer

    t0 = time.perf_counter()
    engine = GenerationEngine(TransformerLM(**CLI_MODEL), device=dev,
                              **CLI_SERVE)
    n_shapes = engine.warmup()
    print(f"engine built and warmed ({n_shapes} shapes, "
          f"{engine.lm.num_params()} params) in "
          f"{time.perf_counter() - t0:.2f} s")
    server = ServeServer(engine, host="127.0.0.1", port=0)
    server.start()
    host, port = server.address
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, size=n).tolist() for n in PROMPT_LENS]
    results = [None] * len(prompts)
    threads = [
        threading.Thread(target=_stream, args=(host, port, p, results, i),
                         name=f"client-{i}")
        for i, p in enumerate(prompts)
    ]
    ca.reset_launch_counts()
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    prefills = server.batcher.m_ttft.count
    steps = server.batcher.m_occupancy.count
    server.shutdown()
    check(all(not t.is_alive() for t in threads), "a stream did not finish")

    depth = CLI_MODEL["depth"]
    print(f"main path: {prefills} prefills, {steps} decode steps, "
          f"launches {launches}")
    check(prefills == len(prompts), f"{prefills} prefills")
    check(launches["flash_fwd"] >= prefills * depth > 0,
          "prefill did not run the flash kernel")
    check(launches["decode_attention"] >= steps * depth > 0,
          "decode did not run the decode kernel")

    # the CPU reference: the same seeded model, plain attention
    cpu = GenerationEngine(TransformerLM(**CLI_MODEL), device="cpu",
                           **CLI_SERVE)
    for name, p in engine.lm.state_dict().items():
        check(torch.equal(p.cpu(), cpu.lm.state_dict()[name]),
              f"weights differ at {name}")
    worst_lp, worst_gpu_score, ties, n_tok = 0.0, 0.0, 0, 0
    for prompt, r in zip(prompts, results):
        check(r is not None and r["status"] == 200, f"stream failed: {r}")
        evs = r["events"]
        check(evs[-1]["event"] == "done", f"stream ended {evs[-1]}")
        toks = [e["token"] for e in evs if e["event"] == "token"]
        lps = np.array([e["logprob"] for e in evs if e["event"] == "token"])
        check(len(toks) == MAX_NEW and toks == evs[-1]["tokens"],
              "token events and the done event disagree")
        check(bool(np.isfinite(lps).all()), "non-finite logprob")
        ref_lp = cpu.score_tokens(prompt, toks)
        worst_lp = max(worst_lp, float(np.abs(lps - ref_lp).max()))
        gpu_lp = engine.score_tokens(prompt, toks)  # the scorer on the card
        worst_gpu_score = max(worst_gpu_score,
                              float(np.abs(gpu_lp - ref_lp).max()))
        seq = np.zeros((1, CLI_MODEL["seq_len"]), np.int64)
        seq[0, : len(prompt) + len(toks)] = prompt + toks
        logits = cpu.lm.forward_logits(torch.from_numpy(seq))[0]
        for j, tok in enumerate(toks):
            top2 = torch.topk(logits[len(prompt) - 1 + j], 2)
            n_tok += 1
            if tok != int(top2.indices[0]):
                margin = float(top2.values[0] - top2.values[1])
                check(margin < TIE_MARGIN,
                      f"token {j} differs from the CPU argmax "
                      f"(margin {margin})")
                ties += 1
    print(f"vs CPU reference: {n_tok} tokens, max |logprob diff| "
          f"{worst_lp:.3e} (limit {LOGPROB_ATOL}), scorer on card "
          f"{worst_gpu_score:.3e}, {ties} tokens differ at near-ties")
    check(worst_lp <= LOGPROB_ATOL, f"logprobs differ by {worst_lp}")
    check(worst_gpu_score <= LOGPROB_ATOL,
          f"card scorer differs by {worst_gpu_score}")
    ttfts = sorted(r["ttft_s"] for r in results)
    print(f"[{card}] TTFT over {len(results)} concurrent streams: "
          f"min {ttfts[0] * 1e3:.2f} ms, max {ttfts[-1] * 1e3:.2f} ms")
    print(f"[{card}] {n_tok} tokens in {wall:.3f} s wall: "
          f"{n_tok / wall:.1f} tokens/s across 4 streams; intertoken p50 "
          f"{server.batcher.m_intertoken.quantile(0.5) * 1e3:.2f} ms")
    where_time_goes(engine, card)
    return launches


def where_time_goes(engine, card, iters: int = 15):
    """Wall time of one decode step with all 8 slots live (prompts of
    16..128 tokens) and of one T=128 prefill, the device's busy share
    of it, and the kernels that take the device time
    (``torch.profiler``).  The prefill's pad rows are all dropped, so
    it writes nothing; the slots are freed at the end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    T = CLI_SERVE["prefill_buckets"][-1]
    rs = np.random.RandomState(1)
    slots = [
        engine.admit(rs.randint(0, 256, size=16 * (i + 1)).tolist(),
                     2 * iters + 8)[0]
        for i in range(engine.max_streams)
    ]
    oob = np.full((T,), engine.pool.oob_row, np.int64)
    programs = (
        ("decode step, 8 live slots", engine.step),
        (f"prefill T={T}",
         lambda: engine._prefill(np.zeros((1, T), np.int64), 0, oob)),
    )
    for name, fn in programs:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # device-side events only: a CPU op also reports the device
        # time of the kernels it launched, which would count them twice
        rows = sorted(
            ((e.self_device_time_total / iters / 1e3, e.count // iters, e.key)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0),
            reverse=True,
        )
        busy = sum(r[0] for r in rows)
        check(busy > 0, f"{name}: the profiler saw no device time")
        attn = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2]
                   or "decode_kernel" in r[2])
        n_kernels = sum(r[1] for r in rows)
        print(f"[{card}] {name}: {wall_ms:.3f} ms wall, {busy:.3f} ms "
              f"device busy ({busy / wall_ms:.1%}), {n_kernels} kernel "
              f"launches of {len(rows)} kinds; the port's attention "
              f"kernels {attn:.4f} ms ({attn / busy:.1%} of device)")
        for ms, count, key in rows[:6]:
            print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} "
                  f"launches)  {key[:90]}")
    for slot in slots:
        engine.finish(slot)
    check(engine.pool.used() == 0, "KV blocks leaked")

# ----------------------------------------------------------------------
# phase 4: the comm epilogue kernels (K9-K11) against their plain
# versions, bit for bit, at the cifar10_full chunk shapes
# ----------------------------------------------------------------------
CIFAR_W, CIFAR_TAU, CIFAR_BATCH = 4, 10, 100
TRAIN_ROUNDS = 8  # per training leg of phase 5


def _cifar_trainer(dev, compress="int8", overlap=False, metrics=None):
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver

    solver = Solver(models.load_model_solver("cifar10_full"), device=dev)
    return ParameterAveragingTrainer(solver, CIFAR_W, compress=compress,
                                     overlap_avg=overlap, metrics=metrics)


def _bitwise(got, want, what) -> float:
    """Check ``got`` equals ``want`` bit for bit (NaNs in the same places;
    bf16 compared as bits) and return max |got - want| (0.0)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    if not got.is_floating_point():
        check(bool(torch.equal(got, want)), f"{what}: payload differs")
        return float((got.float() - want.float()).abs().max())
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    check(bool(torch.equal(gn, wn)), f"{what}: NaNs differ")
    g, w = got[~gn], want[~wn]
    if got.dtype == torch.bfloat16:
        check(bool(torch.equal(g.view(torch.int16), w.view(torch.int16))),
              f"{what}: bits differ")
    else:
        check(bool(torch.equal(g, w)), f"{what}: bits differ")
    return float((g.float() - w.float()).abs().max()) if g.numel() else 0.0


def check_comm_kernels(dev):
    """K9 encode, K10 barriered apply and K11 overlap correction against
    their plain versions on the card, at the real comm chunks of
    cifar10_full at W=4: all three modes, the error readout on and off, a
    masked worker and no survivors for K10, an all-zero leaf.  Then each
    kernel's time over one round's launches (3 chunks) beside its plain
    version's and the bound.  Returns the kernels-line records."""
    from sparknet_tpu_torch.ops import cuda_comm as cc

    trainer = _cifar_trainer(dev)
    state = trainer.init_state(0)
    leaves, chunks = trainer._comm.plan(state)
    gen = torch.Generator().manual_seed(1)

    def near(xs, s):
        return [(x + s * torch.randn(x.shape, generator=gen).to(dev)).contiguous()
                for x in xs]

    a = [x.contiguous() for x in leaves]
    x = near(a, 1e-3)
    r = near([torch.zeros_like(t) for t in a], 1e-6)
    means = [t[0].contiguous() for t in near(a, 1e-3)]
    # the ip1 bias leaf all zero: amax 0 -> int8 scale 1
    for t in (a, x, r):
        t[-1] = torch.zeros_like(t[-1])
    sizes = [sl.stop - sl.start for sl in chunks]
    print(f"comm plane: {len(chunks)} chunks of {sizes} leaves, "
          f"{sum(t[0].numel() for t in a)} floats per worker, W={CIFAR_W}")
    check(len(chunks) == 3, f"expected 3 comm chunks, got {len(chunks)}")
    err = {"comm_encode": 0.0, "comm_apply_barriered": 0.0,
           "comm_apply_correction": 0.0}
    for mode in ("fp32", "bf16", "int8"):
        for sl in chunks:
            modes = (mode,) * (sl.stop - sl.start)
            for with_err in (False, True):
                got = cc.encode(x[sl], a[sl], r[sl], modes, with_err)
                want = cc.encode_reference(x[sl], a[sl], r[sl], modes, with_err)
                for g, w in zip(got[0] + got[1] + got[2],
                                want[0] + want[1] + want[2]):
                    err["comm_encode"] = max(err["comm_encode"],
                                             _bitwise(g, w, f"K9 {mode}"))
                if with_err:
                    check(bool(torch.equal(got[3][:, 0], want[3][:, 0])),
                          "K9 max|err| differs")
                    rel = float(((got[3][:, 1:] - want[3][:, 1:]).abs()
                                 / want[3][:, 1:].abs().clamp_min(1e-30)).max())
                    check(rel <= 1e-5, f"K9 readout sums differ by {rel}")
            q, scales = got[0], got[1]
            got = cc.apply_correction(x[sl], a[sl], q, scales, means[sl], modes)
            want = cc.apply_correction_reference(x[sl], a[sl], q, scales,
                                                 means[sl], modes)
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                err["comm_apply_correction"] = max(
                    err["comm_apply_correction"], _bitwise(g, w, f"K11 {mode}"))
    for alive in ([1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 0, 0]):
        al = torch.tensor(alive, dtype=torch.float32, device=dev)
        d0 = al.sum()
        for sl in chunks:
            got = cc.apply_barriered(x[sl], a[sl], means[sl], r[sl], al, d0)
            want = cc.apply_barriered_reference(x[sl], a[sl], means[sl], r[sl],
                                                al, d0)
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                err["comm_apply_barriered"] = max(
                    err["comm_apply_barriered"], _bitwise(g, w, f"K10 {alive}"))
    torch.cuda.synchronize()
    print("K9-K11 bitwise equal to their plain versions: 3 modes x "
          "err on/off, masked worker, no survivors, all-zero leaf")

    # timing: one round's launches (every chunk) per call, at the main
    # path's modes — K9 int8 with the readout, K10 int8 barriered (all
    # live), K11 bf16 (the overlap leg)
    def per_round(fn):
        return lambda: [fn(sl) for sl in chunks]

    int8 = {sl.start: ("int8",) * (sl.stop - sl.start) for sl in chunks}
    bf16 = {sl.start: ("bf16",) * (sl.stop - sl.start) for sl in chunks}
    q16 = {sl.start: cc.encode(x[sl], a[sl], r[sl], bf16[sl.start], False)[:2]
           for sl in chunks}
    al = torch.ones(CIFAR_W, device=dev)
    d0 = al.sum()
    cases = {
        "comm_encode": (
            "K9", "sparknet_tpu/ops/pallas_comm.py:83", "int8, readout on",
            lambda sl: cc.encode(x[sl], a[sl], r[sl], int8[sl.start], True),
            lambda sl: cc.encode_reference(x[sl], a[sl], r[sl], int8[sl.start],
                                           True),
            sum(cc.chunk_bytes("encode", a[sl], int8[sl.start]) for sl in chunks),
        ),
        "comm_apply_barriered": (
            "K10", "sparknet_tpu/ops/pallas_comm.py:164", "all live",
            lambda sl: cc.apply_barriered(x[sl], a[sl], means[sl], r[sl], al, d0),
            lambda sl: cc.apply_barriered_reference(x[sl], a[sl], means[sl],
                                                    r[sl], al, d0),
            sum(cc.chunk_bytes("apply_barriered", a[sl], int8[sl.start])
                for sl in chunks),
        ),
        "comm_apply_correction": (
            "K11", "sparknet_tpu/ops/pallas_comm.py:224", "bf16",
            lambda sl: cc.apply_correction(x[sl], a[sl], *q16[sl.start],
                                           means[sl], bf16[sl.start]),
            lambda sl: cc.apply_correction_reference(
                x[sl], a[sl], *q16[sl.start], means[sl], bf16[sl.start]),
            sum(cc.chunk_bytes("apply_correction", a[sl], bf16[sl.start])
                for sl in chunks),
        ),
    }
    records = []
    for name, (tag, replaces, what, kern, plain, nbytes) in cases.items():
        b, by = bound_ms(nbytes, 0.0)
        rec = dict(
            name=name, route="cuda",
            source="sparknet_tpu_torch/ops/csrc/comm_epilogue.cu",
            replaces=replaces, max_abs_err=err[name], bound_ms=b, bound_by=by,
            library_ms=None,
            ms=device_ms(per_round(kern)), call_ms=time_ms(per_round(kern)),
            plain_ms=device_ms(per_round(plain)),
            plain_call_ms=time_ms(per_round(plain)),
        )
        print(f"{tag} {name} [cifar10_full W={CIFAR_W}, {len(chunks)} chunk "
              f"launches, {what}, {nbytes} bytes]: kernel {rec['ms']:.4f} ms on "
              f"device ({rec['call_ms']:.4f} ms per call), plain "
              f"{rec['plain_ms']:.4f} ms ({rec['plain_call_ms']:.4f}), bound "
              f"{b * 1e3:.3f} us ({by}), library: none")
        records.append(rec)
    return records


# ----------------------------------------------------------------------
# phase 5: the training main path — cifar_app on the card, three legs
# ----------------------------------------------------------------------
def _first_round_matches_cpu(dev, compress, overlap):
    """One round of the W=4 cifar10_full trainer on the card and on the
    CPU from one carried init and one set of windows: the round's
    parameter updates agree within ``tol`` of their size."""
    from sparknet_tpu_torch.data import CifarLoader, MinibatchSampler, stack_windows
    from sparknet_tpu_torch.utils.tree import tree_leaves

    with tempfile.TemporaryDirectory() as d:
        CifarLoader.write_synthetic(d, num_train=5000, num_test=100)
        xs, ys = CifarLoader(d, seed=0).minibatches(CIFAR_BATCH)
    batches = stack_windows([
        MinibatchSampler({"data": x, "label": y}, CIFAR_TAU, seed=w).next_window()
        for w, (x, y) in enumerate(zip(np.array_split(xs, CIFAR_W),
                                       np.array_split(ys, CIFAR_W)))
    ])
    runs = []
    init = None
    for d in (dev, torch.device("cpu")):
        tr = _cifar_trainer(d, compress, overlap)
        init = init if init is not None else tr.solver.init_state(0)
        st0 = tr.broadcast_state(init)
        st, _ = tr.round(st0, {k: torch.from_numpy(v).to(d)
                               for k, v in batches.items()})
        st = tr.finalize(st)
        runs.append([t.cpu() for t in tree_leaves(st.params)])
    x0 = [t.cpu() for t in tree_leaves(init.params)]
    # float32 on both sides, but cuDNN and the CPU sum the convolutions in
    # other orders over 10 momentum steps (~1e-3 of the update, measured);
    # quantized deltas: a last-bit difference may also move an element
    # across one step of the bf16/int8 grid
    tol = 1e-2 if compress == "none" else 3e-2
    worst = 0.0
    for g, c, p0 in zip(runs[0], runs[1], x0):
        size = float((c - p0[None]).abs().max())
        worst = max(worst, float((g - c).abs().max()) / max(size, 1e-30))
    check(worst <= tol, f"first round on the card vs the CPU ({compress}): "
          f"{worst:.3e} of the update (limit {tol})")
    return worst


def train_end_to_end(dev, card):
    """``cifar_app.main`` in process on synthesized CIFAR (5,000 / 1,000),
    W=4, tau=10, batch 100, TRAIN_ROUNDS rounds, in three legs: no
    compression, ``--compress int8`` (K9 + K10) and ``--compress bf16
    --overlap_avg`` (K9 + K11).  Launch counts are reset before each leg
    and read after it; each compressed leg's final smoothed loss is held
    within LOSS_BAND of the uncompressed leg's, and each leg's first round
    against the same round on the CPU.  Returns the summed launches."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.parallel import LOSS_BAND

    legs = (("none", []), ("int8", ["--compress", "int8"]),
            ("bf16+overlap", ["--compress", "bf16", "--overlap_avg"]))
    argv = ["--device", dev.type, "--workers", str(CIFAR_W), "--tau",
            str(CIFAR_TAU), "--batch", str(CIFAR_BATCH), "--rounds",
            str(TRAIN_ROUNDS)]
    total = dict.fromkeys(cc.LAUNCHES, 0)
    losses = {}
    R = TRAIN_ROUNDS
    expect = {
        "none": dict(comm_encode=0, comm_apply_barriered=0, comm_apply_correction=0),
        "int8": dict(comm_encode=3 * R, comm_apply_barriered=3 * R,
                     comm_apply_correction=0),
        "bf16+overlap": dict(comm_encode=3 * R, comm_apply_barriered=0,
                             comm_apply_correction=3 * R),
    }
    for leg, extra in legs:
        result = {}
        cc.reset_launch_counts()
        rc = cifar_app.main(argv + extra, result)
        torch.cuda.synchronize()
        launches = dict(cc.LAUNCHES)
        check(rc == 0, f"cifar_app leg {leg} exited {rc}")
        print(f"train leg {leg}: launches {launches}, final smoothed_loss "
              f"{result['smoothed_loss']:.6f}, accuracy {result['accuracy']:.4f}")
        check(launches == expect[leg],
              f"leg {leg}: launches {launches}, expected {expect[leg]}")
        for leaf in result["state"].params.values():
            for t in leaf:
                check(bool(torch.isfinite(t).all()), f"leg {leg}: non-finite params")
        losses[leg] = result["smoothed_loss"]
        check(np.isfinite(losses[leg]), f"leg {leg}: non-finite loss")
        rs = np.array(result["round_seconds"][1:])  # round 0 warms up
        imgs = CIFAR_W * CIFAR_TAU * CIFAR_BATCH
        print(f"[{card}] train leg {leg}: {1.0 / rs.mean():.3f} rounds/s, "
              f"{imgs / rs.mean():.1f} images/s (mean of rounds 1..{R - 1}: "
              f"{rs.mean() * 1e3:.2f} ms, min {rs.min() * 1e3:.2f} ms)")
        worst = _first_round_matches_cpu(
            dev, "none" if leg == "none" else extra[1], "--overlap_avg" in extra
        )
        print(f"train leg {leg}: first round on the card vs the CPU, worst "
              f"|diff| {worst:.3e} of the update")
        for k, v in launches.items():
            total[k] += v
    for leg in ("int8", "bf16+overlap"):
        gap = abs(losses[leg] - losses["none"])
        print(f"loss band: {leg} {losses[leg]:.6f} vs none {losses['none']:.6f}: "
              f"gap {gap:.6f} (limit {LOSS_BAND})")
        check(gap <= LOSS_BAND, f"{leg} leaves the loss band: {gap}")
    where_train_time_goes(dev, card)
    return total


def where_train_time_goes(dev, card):
    """One int8 round of the W=4 cifar10_full trainer under
    ``torch.profiler``: wall time, the device's busy share, the kernels
    that take the device time, and K9-K11's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr = _cifar_trainer(dev, "int8")
    st = tr.init_state(0)
    rs = np.random.RandomState(0)
    batch = {
        "data": torch.from_numpy(rs.randn(CIFAR_W, CIFAR_TAU, CIFAR_BATCH, 3, 32, 32)
                                 .astype(np.float32) * 50).to(dev),
        "label": torch.from_numpy(rs.randint(0, 10, (CIFAR_W, CIFAR_TAU, CIFAR_BATCH))
                                  .astype(np.float32)).to(dev),
    }
    st, _ = tr.round(st, batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = tr.round(st, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, _ = tr.round(st, batch)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    check(busy > 0, "train round: the profiler saw no device time")
    comm = sum(r[0] for r in rows if "encode_kernel" in r[2]
               or "apply_barriered_kernel" in r[2]
               or "apply_correction_kernel" in r[2])
    n_kernels = sum(r[1] for r in rows)
    print(f"[{card}] train round (cifar10_full, W={CIFAR_W}, tau={CIFAR_TAU}, "
          f"int8): {wall_ms:.3f} ms wall, {busy:.3f} ms device busy "
          f"({busy / wall_ms:.1%}), {n_kernels} kernel launches of {len(rows)} "
          f"kinds; K9-K11 {comm:.4f} ms ({comm / busy:.2%} of device)")
    for ms, count, key in rows[:8]:
        print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} launches)  "
              f"{key[:90]}")


# ----------------------------------------------------------------------
# phase 6: the flash backward kernels (K3, K4) against their plain
# versions, at the LM training shape and its edges
# ----------------------------------------------------------------------
LM_MODEL = dict(CLI_MODEL)  # the LM trains at the width it serves
LM_W, LM_TAU, LM_BATCH, LM_ROUNDS = 2, 4, 8, 6
# lm_app's default rate, 0.1 (the JAX package's, tuned at dim 64), diverged
# at this width on the H100 (per-round loss 4.61 -> 8.16 -> 9.46); 0.05,
# 0.03 and 0.02 spiked; 0.01 falls from ln 256 to ~2.9 in 6 rounds
LM_LR = 0.01
# the JAX package's LM associativity tolerance (bench.py BENCH_LM_TOL)
LM_TOL = 5e-4
# first LM round on the card vs the CPU, relative to the round's update:
# float32 on both sides, summed in other orders over 4 momentum steps
LM_CPU_TOL = 1e-2


def _bwd_case(dev, gen, b, tq, tk, h, d, q_off, k_off, causal):
    """Seeded inputs of K3/K4: q, k, v, do, dlse and K1's (o, lse)."""
    from sparknet_tpu_torch.ops import cuda_attention as ca

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    q, k, v = rand(b, tq, h, d), rand(b, tk, h, d), rand(b, tk, h, d)
    do, dlse = rand(b, tq, h, d), rand(b, h, tq)
    o, lse = ca._flash_core(q, k, v, q_off, k_off, causal)
    return (q, k, v, do, o, lse, dlse, q_off, k_off, causal)


def check_bwd_kernels(dev):
    """Hold K3 and K4 against their plain versions on the card; return
    their kernels-line records (without launch counts)."""
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cpu").manual_seed(2)
    B, T, H, D = LM_BATCH, LM_MODEL["seq_len"], LM_MODEL["heads"], \
        LM_MODEL["dim"] // LM_MODEL["heads"]
    cases = [
        ("training shape", B, T, T, H, D, 0, 0, True),
        ("non-causal", B, T, T, H, D, 0, 0, False),
        ("ragged T_q", 2, 37, 100, H, D, 63, 0, True),
        ("offsets (0, 64), 64 fully-masked rows", 2, 128, 128, H, D, 0, 64, True),
        ("D=32", 2, 70, 70, H, 32, 0, 0, True),
        ("D=128", 2, 100, 100, H, 128, 0, 0, True),
    ]
    err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for what, *shape in cases:
        args = _bwd_case(dev, gen, *shape)
        got = {"flash_bwd_dq": (ca.flash_bwd_dq(*args),),
               "flash_bwd_dkv": ca.flash_bwd_dkv(*args)}
        want = {"flash_bwd_dq": (ca._flash_bwd_dq_reference(*args),),
                "flash_bwd_dkv": ca._flash_bwd_dkv_reference(*args)}
        torch.cuda.synchronize()
        for name, outs in (("flash_bwd_dq", ("K3 dq",)),
                           ("flash_bwd_dkv", ("K4 dk", "K4 dv"))):
            for g, w, out in zip(got[name], want[name], outs):
                check(bool(torch.isfinite(g).all()), f"{out} {what}: non-finite")
                e = float((g - w).abs().max())
                scale = max(1.0, float(w.abs().max()))
                print(f"{out} {what} {tuple(g.shape)}: max_abs_err {e:.3e} "
                      f"(scale {scale:.3g})")
                check(e <= BWD_RTOL * scale,
                      f"{name} disagrees ({what}): {e} > {BWD_RTOL} x {scale}")
                err[name] = max(err[name], e)
        if shape[6] == 64:  # q_off 0, k_off 64: rows 0..63 see no key
            check(bool((got["flash_bwd_dq"][0][:, :64] == 0).all()),
                  "fully-masked rows must give dq = 0")

    # times at the training shape, causal, dlse = 0 (what the LM passes)
    args = list(_bwd_case(dev, gen, B, T, T, H, D, 0, 0, True))
    args[6] = torch.zeros_like(args[6])
    args = tuple(args)
    q, k, v, do = args[:4]
    pairs = B * H * T * (T + 1) // 2  # visible (query, key) pairs
    tensor_bytes = 4 * B * T * H * D
    row_bytes = 4 * B * H * T
    # K3 reads q, k, v, o, do, lse, dlse and writes dq: 3 products
    dq_b, dq_by = bound_ms(6 * tensor_bytes + 2 * row_bytes, 6 * D * pairs)
    # K4 reads the same and writes dk, dv: 4 products
    dkv_b, dkv_by = bound_ms(7 * tensor_bytes + 2 * row_bytes, 8 * D * pairs)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    do_s = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), do_s)

    lib_fwd, lib_fwd_bwd = device_ms(sdpa), device_ms(sdpa_fwd_bwd)
    library = lib_fwd_bwd - lib_fwd
    shape = f"B={B} T={T} H={H} D={D} causal fp32"
    records = []
    for name, tag, line, kernel, plain, b, by in (
        ("flash_bwd_dq", "K3", 91, lambda: ca.flash_bwd_dq(*args),
         lambda: ca._flash_bwd_dq_reference(*args), dq_b, dq_by),
        ("flash_bwd_dkv", "K4", 119, lambda: ca.flash_bwd_dkv(*args),
         lambda: ca._flash_bwd_dkv_reference(*args), dkv_b, dkv_by),
    ):
        rec = dict(
            name=name, route="cuda",
            source="sparknet_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=f"sparknet_tpu/ops/pallas_attention.py:{line}",
            max_abs_err=err[name], bound_ms=b, bound_by=by,
            library_ms=library, shape=shape,
            ms=device_ms(kernel), call_ms=time_ms(kernel),
            plain_ms=device_ms(plain), plain_call_ms=time_ms(plain),
        )
        print(f"{tag} {name} [{shape}]: kernel {rec['ms']:.4f} ms on device "
              f"({rec['call_ms']:.4f} ms per call), plain {rec['plain_ms']:.4f} "
              f"ms ({rec['plain_call_ms']:.4f}), bound {b * 1e3:.3f} us ({by})")
        records.append(rec)
    print(f"K3+K4 library yardstick: scaled_dot_product_attention fwd+bwd "
          f"{lib_fwd_bwd:.4f} ms - fwd {lib_fwd:.4f} ms = {library:.4f} ms on "
          f"device; K3+K4 {records[0]['ms'] + records[1]['ms']:.4f} ms")
    return records


# ----------------------------------------------------------------------
# phase 7: the LM training main path — lm_app on the card, two legs
# ----------------------------------------------------------------------
def _lm_argv(dev):
    m = LM_MODEL
    return ["--device", dev.type, "--workers", str(LM_W), "--tau", str(LM_TAU),
            "--batch", str(LM_BATCH), "--rounds", str(LM_ROUNDS),
            "--dim", str(m["dim"]), "--depth", str(m["depth"]),
            "--heads", str(m["heads"]), "--seq_len", str(m["seq_len"]),
            "--base_lr", str(LM_LR), "--log_every", "1"]


def _lm_trainer(dev):
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    args = lm_app._parser().parse_args(_lm_argv(dev))
    lm, solver = lm_app.build_lm_solver(args, dev)
    return lm, ParameterAveragingTrainer(solver, LM_W)


def _lm_batch(r: int):
    """Round ``r``'s (W, tau, B, T) windows, as lm_app draws them."""
    from sparknet_tpu_torch.data import (
        TextWindowSampler, load_corpus, stack_windows, write_synthetic_corpus)

    with tempfile.TemporaryDirectory() as d:
        write_synthetic_corpus(d, seed=0)
        docs = load_corpus(d)
    base = TextWindowSampler(docs, LM_MODEL["seq_len"], LM_BATCH, seed=0)
    return stack_windows([base.for_worker(w).window_for_round(r, LM_TAU)
                          for w in range(LM_W)])


def _lm_first_round_matches_cpu(dev):
    """Round 0 of the flash leg on the card and on the CPU from one init
    and one set of windows: the parameter updates agree within
    LM_CPU_TOL of their size, the losses within LM_TOL."""
    from sparknet_tpu_torch.utils.tree import tree_leaves

    batch = _lm_batch(0)
    runs, init = [], None
    for d in (dev, torch.device("cpu")):
        _, tr = _lm_trainer(d)
        init = init if init is not None else tr.solver.init_state(0)
        st, losses = tr.round(tr.broadcast_state(init),
                              {k: torch.from_numpy(v).to(d)
                               for k, v in batch.items()})
        runs.append(([t.cpu() for t in tree_leaves(st.params)], losses.cpu()))
    x0 = [t.cpu() for t in tree_leaves(init.params)]
    worst = 0.0
    for g, c, p0 in zip(runs[0][0], runs[1][0], x0):
        size = float((c - p0[None]).abs().max())
        worst = max(worst, float((g - c).abs().max()) / max(size, 1e-30))
    loss_gap = float((runs[0][1] - runs[1][1]).abs().max())
    check(worst <= LM_CPU_TOL, f"LM first round on the card vs the CPU: "
          f"{worst:.3e} of the update (limit {LM_CPU_TOL})")
    check(loss_gap <= LM_TOL, f"LM first-round losses differ by {loss_gap}")
    return worst, loss_gap


def lm_train_end_to_end(dev, card):
    """``lm_app.main`` in process at the CLI model's width, W=2, tau 4,
    batch 8, LM_ROUNDS rounds, flash and dense legs; returns the flash
    leg's launches."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.utils.tree import tree_leaves

    n = LM_MODEL["depth"] * LM_W * LM_TAU * LM_ROUNDS
    expect = {
        "flash": dict(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n,
                      decode_attention=0),
        "dense": dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                      decode_attention=0),
    }
    results, launches = {}, {}
    for leg, extra in (("flash", []), ("dense", ["--dense_attention"])):
        result = {}
        ca.reset_launch_counts()
        rc = lm_app.main(_lm_argv(dev) + extra, result)
        torch.cuda.synchronize()
        launches[leg] = dict(ca.LAUNCHES)
        check(rc == 0, f"lm_app leg {leg} exited {rc}")
        losses = result["losses"]  # (rounds, W, tau)
        per_round = losses.mean(axis=(1, 2))
        print(f"LM leg {leg}: launches {launches[leg]}, per-round mean loss "
              + " ".join(f"{x:.4f}" for x in per_round))
        check(launches[leg] == expect[leg],
              f"LM leg {leg}: launches {launches[leg]}, expected {expect[leg]}")
        check(bool(np.isfinite(losses).all()), f"LM leg {leg}: non-finite loss")
        check(abs(float(losses[0, :, 0].mean()) - np.log(256)) < 0.5,
              f"LM leg {leg}: first loss {losses[0, :, 0].mean()} not ~ln 256")
        check(per_round[-1] < per_round[0] - 0.5,
              f"LM leg {leg}: loss did not fall ({per_round[0]} -> "
              f"{per_round[-1]})")
        for t in tree_leaves(result["state"].params):
            check(bool(torch.isfinite(t).all()), f"LM leg {leg}: non-finite params")
        rs = np.array(result["round_seconds"][1:])  # round 0 warms up
        print(f"[{card}] LM leg {leg}: {result['tokens_per_round'] / rs.mean():.1f} "
              f"tokens/s, {1.0 / rs.mean():.3f} rounds/s (mean of rounds "
              f"1..{LM_ROUNDS - 1}: {rs.mean() * 1e3:.2f} ms, min "
              f"{rs.min() * 1e3:.2f} ms)")
        results[leg] = result
    loss_gap = float(np.abs(results["flash"]["losses"]
                            - results["dense"]["losses"]).max())
    param_gap = max(
        float((a - b).abs().max())
        for a, b in zip(tree_leaves(results["flash"]["state"].params),
                        tree_leaves(results["dense"]["state"].params)))
    print(f"LM flash vs dense over {LM_ROUNDS} rounds: losses {loss_gap:.3e}, "
          f"params {param_gap:.3e} (limit {LM_TOL})")
    check(loss_gap <= LM_TOL, f"flash and dense losses differ by {loss_gap}")
    check(param_gap <= LM_TOL, f"flash and dense params differ by {param_gap}")
    worst, first_gap = _lm_first_round_matches_cpu(dev)
    print(f"LM first round on the card vs the CPU: worst |diff| {worst:.3e} of "
          f"the update, losses {first_gap:.3e}")
    where_lm_time_goes(dev, card)
    return launches["flash"]


def where_lm_time_goes(dev, card):
    """One flash round of the LM trainer under ``torch.profiler``: wall
    time, the device's busy share, the top kernels and K1/K3/K4's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, tr = _lm_trainer(dev)
    st = tr.init_state(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _lm_batch(0).items()}
    st, _ = tr.round(st, batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = tr.round(st, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, _ = tr.round(st, batch)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    check(busy > 0, "LM round: the profiler saw no device time")
    share = {tag: sum(r[0] for r in rows if kern in r[2])
             for tag, kern in (("K1", "flash_fwd_kernel"),
                               ("K3", "flash_bwd_dq_kernel"),
                               ("K4", "flash_bwd_dkv_kernel"))}
    n_kernels = sum(r[1] for r in rows)
    print(f"[{card}] LM round (dim {LM_MODEL['dim']}, depth {LM_MODEL['depth']}, "
          f"W={LM_W}, tau={LM_TAU}, batch {LM_BATCH}, flash): {wall_ms:.3f} ms "
          f"wall, {busy:.3f} ms device busy ({busy / wall_ms:.1%}), {n_kernels} "
          f"kernel launches of {len(rows)} kinds; "
          + ", ".join(f"{t} {ms:.4f} ms ({ms / busy:.1%})" for t, ms in share.items()))
    for ms, count, key in rows[:8]:
        print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} launches)  "
              f"{key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    from sparknet_tpu_torch.ops import _build
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    card = card_name_and_power_limit(0)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(p.name for p in libs.values()))
    for p in libs.values():
        log = p.with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {p.stem}: {line.strip()}")

    kernels = check_kernels(dev)
    kernels += check_bwd_kernels(dev)
    comm_kernels = check_comm_kernels(dev)
    launches = serve_end_to_end(dev, card)
    for name, n in lm_train_end_to_end(dev, card).items():
        launches[name] += n
    launches.update(train_end_to_end(dev, card))
    kernels += comm_kernels
    for r in kernels:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never ran on the main path")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
