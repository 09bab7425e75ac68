"""The port's hot-path invariant linter (``sparknet_tpu_torch/analysis``
+ ``python -m sparknet_tpu_torch.tools.lint``): must-flag / must-pass
fixture pairs per checker in torch idiom, the suppression-marker
grammar, the allowlist baseline semantics, the whole-port ``--check``
tier-1 smoke, the sanitizer's site matching on synthetic warning
stacks, and the port held against the JAX package's linter (the same
finding keys on the framework-neutral fixtures, the same canon less the
names the port does not emit).

Every checker gets at least one fixture that PROVES it still bites — a
gate that silently stopped flagging is worse than no gate.
"""

import ast
import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import traceback
import warnings

import pytest

from sparknet_tpu.analysis import registry as jregistry
from sparknet_tpu.analysis import runner as jrunner
from sparknet_tpu.analysis.hotpaths import HOT_PATHS as JHOT_PATHS
from sparknet_tpu_torch.analysis import astutil, registry, runner, sanitize
from sparknet_tpu_torch.analysis.hotpaths import HOT_PATHS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINT = [sys.executable, "-m", "sparknet_tpu_torch.tools.lint"]


def _scan(src, hot=frozenset(), **kw):
    return runner.scan_source(textwrap.dedent(src), hot_scopes=hot, **kw)


def _checkers(rep):
    return {f.checker for f in rep.findings}


@functools.lru_cache(maxsize=None)
def _port_scan():
    """The whole-port scan, docs included (one a test process)."""
    return runner.scan_package(REPO, with_docs=True)


def _lint(*args, cwd=REPO):
    return subprocess.run(
        [*LINT, *args], capture_output=True, text=True, timeout=300,
        cwd=cwd, env={**os.environ, "PYTHONPATH": REPO})


# ----------------------------------------------------------------------
# sync-in-hot-path
# ----------------------------------------------------------------------

class TestSyncChecker:
    def test_flags_every_listed_sync_kind_in_hot_scope(self):
        rep = _scan(
            """
            import numpy as np
            import torch

            def round_loop(state, losses, x, ev, stream, dev):
                a = losses.item()
                b = losses.tolist()
                c = x.cpu()
                d = x.numpy()
                e = x.to("cpu")
                f = x.to(device="cpu")
                g = float(losses)
                h = int(losses)
                i = bool(losses)
                j = np.asarray(x)
                k = np.array(x)
                torch.cuda.synchronize()
                ev.synchronize()
                stream.synchronize()
                m = x.nonzero()
                n = torch.nonzero(x)
                o = torch.tensor([1.0], device=dev)
                p = torch.as_tensor(state, device=dev)
                q = x.to(torch.device("cpu"))
                return a, b, c, d, e, f, g, h, i, j, k, m, n, o, p, q
            """,
            hot={"round_loop"},
        )
        msgs = [f.message for f in rep.findings]
        assert len(msgs) == 19, msgs
        for token in (".item()", ".tolist()", ".cpu()", ".numpy()",
                      ".to(cpu)", "float()", "int()", "bool()",
                      "np.asarray", "np.array", "torch.cuda.synchronize",
                      ".synchronize()", ".nonzero()", "torch.nonzero",
                      "torch.tensor(device=)", "torch.as_tensor(device=)"):
            assert any(token in m for m in msgs), token

    def test_method_call_reductions_are_not_benign(self):
        """`float(losses.max())` is a scalar D2H sync — a leaf-name
        match on 'max' must not whitelist METHOD calls."""
        rep = _scan(
            """
            def round_loop(losses, x):
                a = float(losses.max())
                b = float(x.sum())
                c = int(x.argmin())
                d = bool(x.any())
                return a, b, c, d
            """,
            hot={"round_loop"},
        )
        assert len(rep.findings) == 4, [f.message for f in rep.findings]

    def test_device_comparison_inside_float_is_not_benign(self):
        """float(x > 0.5) on a tensor is a sync; a shape comparison is
        not."""
        rep = _scan(
            """
            def round_loop(state, losses):
                a = float(state.loss > 0.5)          # device compare
                ok = int(losses.shape[-1] == 2)      # shape compare
                return a, ok
            """,
            hot={"round_loop"},
        )
        msgs = [f.message for f in rep.findings]
        assert len(msgs) == 1 and "float()" in msgs[0], msgs

    def test_cold_scope_and_benign_reads_pass(self):
        rep = _scan(
            """
            import numpy as np
            import torch

            def setup(x):            # NOT a hot scope: syncing is free
                return np.asarray(x.cpu()), x.item()

            def round_loop(losses, r, x, dev):
                tau = int(losses.shape[-1])      # shape read: no sync
                n = float(len(losses))           # len: no sync
                k = int(r.start or 0)            # slice metadata
                m = int(x.numel()) + int(x.size(0)) + int(x.dim())
                big = bool(x.is_cuda)            # header flag
                y = x.to(dev)                    # not to the host
                z = torch.tensor([1.0])          # host tensor
                w = torch.as_tensor(z, device="cpu")
                return tau + n + k + m, big, y, w
            """,
            hot={"round_loop"},
        )
        assert not rep.findings, [f.message for f in rep.findings]

    def test_suppression_marker_with_reason(self):
        rep = _scan(
            """
            def round_loop(ev):
                # sparknet: sync-ok(the wire wait, overlapped)
                ev.synchronize()
            """,
            hot={"round_loop"},
        )
        assert not rep.findings
        assert len(rep.suppressed) == 1
        assert rep.suppressed[0].reason == "the wire wait, overlapped"

    def test_marker_reason_may_contain_parentheses(self):
        """The reason captures to the line's LAST ')': '(W,) verdict
        read' must survive intact into the inventory."""
        rep = _scan(
            """
            def round_loop(bad):
                # sparknet: sync-ok(one tiny (W,) verdict read)
                return bool(bad.any())
            """,
            hot={"round_loop"},
        )
        assert not rep.findings
        assert rep.suppressed[0].reason == "one tiny (W,) verdict read"

    def test_trailing_marker_does_not_bless_the_next_line(self):
        """A same-line marker covers ITS statement only — the next
        line's unannotated sync must still flag."""
        rep = _scan(
            """
            def round_loop(ev, losses):
                ev.synchronize()  # sparknet: sync-ok(handback)
                return losses.item()
            """,
            hot={"round_loop"},
        )
        assert len(rep.findings) == 1, [f.message for f in rep.findings]
        assert ".item()" in rep.findings[0].message
        assert len(rep.suppressed) == 1  # the annotated line still is

    def test_empty_marker_reason_is_its_own_finding(self):
        rep = _scan(
            """
            def round_loop(ev):
                ev.synchronize()  # sparknet: sync-ok()
            """,
            hot={"round_loop"},
        )
        # the sync still flags AND the empty marker flags
        assert any(f.checker == "sync-in-hot-path" for f in rep.findings)
        assert any(f.checker == "marker" for f in rep.findings)

    def test_unknown_marker_rule_flags(self):
        rep = _scan(
            """
            x = 1  # sparknet: sink-ok(typo'd rule)
            """,
        )
        assert any(
            f.checker == "marker" and "sink" in f.message
            for f in rep.findings
        )

    def test_thread_target_is_hot_by_construction(self):
        rep = _scan(
            """
            import threading

            def producer(shared):
                return shared.tolist()

            t = threading.Thread(target=producer, name="p", daemon=True)
            """,
        )
        assert any(
            f.checker == "sync-in-hot-path"
            and f.scope == "producer" for f in rep.findings
        )

    def test_suppressed_site_spans_a_wrapped_call(self):
        """The inventory keeps each annotated call's last line: the
        sanitizer matches a frame anywhere in the call."""
        rep = _scan(
            """
            def round_loop(pending):
                # sparknet: sync-ok(3-scalar readout, one round late)
                vals = pending.tolist(
                )
                return vals
            """,
            hot={"round_loop"},
        )
        (s,) = rep.suppressed
        assert (s.line, s.end_line) == (4, 5)
        assert s.as_dict()["end_line"] == 5


# ----------------------------------------------------------------------
# donation-discipline: the non_blocking hand-over
# ----------------------------------------------------------------------

def _donation(rep):
    return [f for f in rep.findings if f.checker == "donation-discipline"]


class TestDonationChecker:
    @pytest.mark.parametrize("write", [
        "buf[0] = 1.0",
        "buf.zero_()",
        "buf.copy_(other)",
        "buf += 1",
        "buf[1:] += 1",
        "np.copyto(buf.numpy(), other)",
        "torch.add(other, 1, out=buf)",
    ])
    def test_write_after_non_blocking_to_flags(self, write):
        rep = _scan(
            f"""
            import numpy as np
            import torch

            def stage(buf, other, dev):
                out = buf.to(dev, non_blocking=True)
                {write}
                return out
            """,
        )
        assert any("'buf'" in f.message for f in _donation(rep)), (
            write, [f.message for f in rep.findings])

    def test_copy_source_and_pinned_staging_flag(self):
        rep = _scan(
            """
            def stage(dst, src, host, dev):
                dst.copy_(src, non_blocking=True)
                src.mul_(2)
                d = host.pin_memory().to(dev, non_blocking=True)
                host[0] = 0
                return d
            """,
        )
        names = {f.message.split("'")[1] for f in _donation(rep)}
        assert names == {"src", "host"}, [f.message for f in rep.findings]

    def test_loop_carried_reuse_flags(self):
        """The classic bug: one staging buffer built OUTSIDE the loop,
        refilled every iteration while last iteration's copy may still
        read it."""
        rep = _scan(
            """
            import torch

            def feed(batches, dev, n):
                buf = torch.empty(4).pin_memory()
                outs = []
                for r in range(n):
                    buf.copy_(batches[r])
                    outs.append(buf.to(dev, non_blocking=True))
                return outs
            """,
        )
        assert any("'buf'" in f.message for f in _donation(rep)), [
            f.message for f in rep.findings]

    def test_known_async_producer_applies_cross_module(self):
        """``place_batch(host, ...)`` hands ``host`` over by registry,
        even in a module that never defines it."""
        rep = _scan(
            """
            def produce(host, dev, stream):
                out = place_batch(host, dev, stream)
                host["data"][:] = 0
                return out
            """,
        )
        assert any("'host'" in f.message for f in _donation(rep))

    @pytest.mark.parametrize("wait", [
        "torch.cuda.synchronize()",
        "ev.synchronize()",
        "torch.cuda.current_stream().wait_stream(side)",
        "torch.cuda.current_stream().wait_event(ev)",
        "ev.wait()",
    ])
    def test_a_wait_ends_the_hand_over(self, wait):
        rep = _scan(
            f"""
            import torch

            def stage(buf, dev, ev, side):
                out = buf.to(dev, non_blocking=True)
                {wait}
                buf[0] = 1.0
                return out
            """,
        )
        assert not _donation(rep), [f.message for f in rep.findings]

    def test_rebuilt_per_iteration_and_blocking_copies_pass(self):
        rep = _scan(
            """
            import torch

            def feed(batches, dev, n):
                outs = []
                for r in range(n):
                    buf = torch.from_numpy(batches[r]).pin_memory()
                    outs.append(buf.to(dev, non_blocking=True))
                host = batches[0]
                blocking = torch.from_numpy(host).to(dev)
                host[0] = 0
                return outs, blocking
            """,
        )
        assert not _donation(rep), [f.message for f in rep.findings]

    def test_branch_local_hand_over_does_not_poison_the_other_branch(self):
        rep = _scan(
            """
            def stage(buf, dev, fast):
                if fast:
                    out = buf.to(dev, non_blocking=True)
                    buf = None
                else:
                    buf[0] = 1.0          # other branch: buf was not sent
                    out = buf.to(dev)
                return out
            """,
        )
        assert not _donation(rep), [f.message for f in rep.findings]

    def test_donation_marker_suppresses(self):
        rep = _scan(
            """
            def stage(buf, dev):
                out = buf.to(dev, non_blocking=True)
                # sparknet: donation-ok(pageable source: the copy was staged before the call returned)
                buf[0] = 1.0
                return out
            """,
        )
        assert not _donation(rep)
        assert any(
            s.checker == "donation-discipline" for s in rep.suppressed
        )

    def test_donation_keys_are_line_number_free(self):
        """The message must not embed the hand-over line — an
        allowlisted finding has to survive edits above it."""
        rep = _scan(
            """
            def stage(buf, dev):
                out = buf.to(dev, non_blocking=True)
                buf[0] = 1.0
                return out
            """,
        )
        don = _donation(rep)
        assert don and not any(
            ch.isdigit() for f in don for ch in f.key
        ), [f.key for f in don]


# ----------------------------------------------------------------------
# thread-hygiene (framework-neutral: the JAX fixtures in torch's setting)
# ----------------------------------------------------------------------

THREAD_FIXTURES = {
    "anonymous_implicit_daemon": """
        import threading

        def spawn(fn):
            t = threading.Thread(target=fn)
            t.start()
            return t
        """,
    "named_explicit_daemon": """
        import threading

        def spawn(fn):
            return threading.Thread(
                target=fn, name="feed-producer", daemon=True
            )
        """,
    "join_no_timeout": """
        def await_result(worker):
            worker.join()             # mid-round wait, unbounded
        """,
    "join_shutdown_or_timeout": """
        def stop(worker):
            worker.join()             # shutdown path: allowed

        def poll(worker):
            worker.join(timeout=5.0)  # bounded: allowed
            sep = ", ".join(["a"])    # str.join: not a thread join
            return sep
        """,
    "join_marker": """
        def await_pending(p):
            # sparknet: join-ok(bounded by the in-flight chunk means)
            p.join()
        """,
    "bare_and_swallow": """
        import threading

        def worker():
            try:
                step()
            except Exception:
                pass                  # swallowed in a thread target

        def anywhere():
            try:
                step()
            except:                   # bare: flags everywhere
                raise

        t = threading.Thread(target=worker, name="w", daemon=True)
        """,
    "recorded_error_and_retry": """
        import queue
        import threading

        def worker(holder, q):
            try:
                step()
            except BaseException as e:
                holder["error"] = e   # surfaced on next __next__
            while True:
                try:
                    q.put(1, timeout=0.1)
                    break
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, name="w", daemon=True)
        """,
    "lock_cycle": """
        class A:
            def ab(self):
                with self._alock:
                    with self._block:
                        work()

            def ba(self):
                with self._block:
                    with self._alock:
                        work()
        """,
    "lock_consistent": """
        class A:
            def ab(self):
                with self._alock:
                    with self._block:
                        work()

            def also_ab(self):
                with self._alock:
                    with self._block:
                        other()
        """,
    "lock_cycle_by_call": """
        class A:
            def outer(self):
                with self._alock:
                    self.helper()

            def helper(self):
                with self._block:
                    work()

            def inverted(self):
                with self._block:
                    with self._alock:
                        work()
        """,
    "lock_marker": """
        class A:
            def ab(self):
                with self._alock:
                    # sparknet: lock-ok(the pair is only ever taken on one thread)
                    with self._block:
                        work()

            def ba(self):
                with self._block:
                    with self._alock:
                        work()
        """,
}


class TestThreadChecker:
    def test_anonymous_and_implicit_daemon_flag(self):
        cs = _checkers(_scan(THREAD_FIXTURES["anonymous_implicit_daemon"]))
        assert "thread-hygiene/thread-anonymous" in cs
        assert "thread-hygiene/thread-daemon" in cs

    def test_named_explicit_daemon_passes(self):
        rep = _scan(THREAD_FIXTURES["named_explicit_daemon"])
        assert not rep.findings, [f.message for f in rep.findings]

    def test_untimeouted_join_outside_shutdown_flags(self):
        rep = _scan(THREAD_FIXTURES["join_no_timeout"])
        assert "thread-hygiene/join-no-timeout" in _checkers(rep)

    def test_join_in_shutdown_path_or_with_timeout_passes(self):
        rep = _scan(THREAD_FIXTURES["join_shutdown_or_timeout"])
        assert not rep.findings, [f.message for f in rep.findings]

    def test_join_marker_suppresses(self):
        rep = _scan(THREAD_FIXTURES["join_marker"])
        assert not rep.findings
        assert any(s.checker.endswith("join-no-timeout")
                   for s in rep.suppressed)

    def test_bare_except_and_thread_target_swallow_flag(self):
        cs = _checkers(_scan(THREAD_FIXTURES["bare_and_swallow"]))
        assert "thread-hygiene/except-swallow" in cs
        assert "thread-hygiene/except-bare" in cs

    def test_recorded_error_and_retry_continue_pass(self):
        rep = _scan(THREAD_FIXTURES["recorded_error_and_retry"])
        assert not rep.findings, [f.message for f in rep.findings]

    def test_seeded_lock_order_cycle_flags(self):
        rep = _scan(THREAD_FIXTURES["lock_cycle"])
        msg = next(
            f.message for f in rep.findings
            if f.checker == "thread-hygiene/lock-order-cycle"
        )
        assert "_alock" in msg and "_block" in msg

    def test_consistent_lock_order_passes(self):
        rep = _scan(THREAD_FIXTURES["lock_consistent"])
        assert "thread-hygiene/lock-order-cycle" not in _checkers(rep)

    def test_call_propagated_cycle_flags(self):
        rep = _scan(THREAD_FIXTURES["lock_cycle_by_call"])
        assert "thread-hygiene/lock-order-cycle" in _checkers(rep)

    def test_port_threads_are_named_with_a_daemon_policy(self):
        """Every thread the port starts passes the rules (the whole-port
        scan, thread checkers only)."""
        bad = [f for f in _port_scan().findings
               if f.checker.startswith("thread-")]
        assert not bad, [f.format() for f in bad]


# ----------------------------------------------------------------------
# registry-audit
# ----------------------------------------------------------------------

REGISTRY_FIXTURES = {
    "unregistered": """
        def setup(registry, obs):
            c = registry.counter("sparknet_bogus_total", "nope")
            with obs.span("warp_drive"):
                pass
        """,
    "canonical_and_drift": """
        def setup(registry, obs):
            registry.counter("sparknet_rounds_total", "ok")
            registry.counter(
                "sparknet_faults_total", "drifted", labels=("oops",)
            )
            with obs.span("execute"):
                pass
            with obs.span("cache_read", cat="cache"):
                pass
        """,
    "second_emitter_drift": """
        def good(registry):
            registry.counter(
                "sparknet_faults_total", "ok", labels=("kind",)
            )

        def drifted(registry):
            registry.counter("sparknet_faults_total", "bad")
        """,
}


def _audit_msgs(rep):
    return [f.message for f in rep.findings if f.checker == "registry-audit"]


class TestRegistryAudit:
    def test_unregistered_metric_and_span_flag(self):
        msgs = _audit_msgs(_scan(REGISTRY_FIXTURES["unregistered"],
                                 audit_registry=True))
        assert any("sparknet_bogus_total" in m for m in msgs), msgs
        assert any("warp_drive" in m for m in msgs), msgs

    def test_canonical_names_pass_and_label_drift_flags(self):
        msgs = _audit_msgs(_scan(REGISTRY_FIXTURES["canonical_and_drift"],
                                 audit_registry=True))
        assert not any("sparknet_rounds_total" in m for m in msgs), msgs
        assert not any("'execute'" in m for m in msgs), msgs
        assert not any("cache_read" in m for m in msgs), msgs
        assert any(
            "sparknet_faults_total" in m and "label drift" in m
            for m in msgs
        ), msgs

    def test_label_drift_on_second_emitter_not_hidden_by_first(self):
        msgs = _audit_msgs(_scan(REGISTRY_FIXTURES["second_emitter_drift"],
                                 audit_registry=True))
        assert any("label drift" in m for m in msgs), msgs

    def test_the_port_only_differences_are_held(self):
        """The port does not register ``sparknet_jit_cache_size`` (an
        emitter of it is uncanonical) and spans ``allgather``."""
        msgs = _audit_msgs(_scan(
            """
            def setup(registry, obs):
                registry.gauge("sparknet_jit_cache_size", "x")
                with obs.span("allgather"):
                    pass
            """,
            audit_registry=True,
        ))
        assert any("'sparknet_jit_cache_size' emitted but not in" in m
                   for m in msgs), msgs
        assert not any("'allgather'" in m for m in msgs), msgs

    def test_docs_leg_takes_documented_absences_only(self):
        """A doc token naming a metric the port documents as absent is
        legal; any other uncanonical token is stale."""
        from sparknet_tpu_torch.analysis import registry_audit

        perf = " ".join(list(registry.CANONICAL_METRICS)
                        + sorted(registry.CANONICAL_SPANS["phase"]))
        rep = registry_audit.audit(registry_audit.Inventory(), {
            "PERF.md": perf + " sparknet_jit_cache_size sparknet_cache_",
            "README.md": "sparknet_tpu_torch sparknet_bogus_total",
        })
        docs = [f.message for f in rep.findings if f.scope == "<docs>"]
        assert docs == ["docs mention 'sparknet_bogus_total' which is not "
                        "a canonical metric (stale or typo'd name)"], docs

    def test_package_emitters_match_canon_exactly(self):
        """The real port: every emitted sparknet_* metric and span literal
        is canonical AND every canonical name is emitted."""
        audit = [f for f in _port_scan().findings
                 if f.checker == "registry-audit" and f.scope != "<docs>"]
        assert not audit, [f.message for f in audit]

    def test_docs_reference_complete(self):
        """PERF.md's telemetry reference names every canonical metric and
        phase of the port; PERF.md and README.md name no other."""
        docs = [
            f for f in _port_scan().findings
            if f.checker == "registry-audit" and f.scope == "<docs>"
        ]
        assert not docs, [f.message for f in docs]


# ----------------------------------------------------------------------
# held against the JAX package's linter
# ----------------------------------------------------------------------

MARKER_FIXTURES = {
    "empty_reason": """
        def f(p):
            p.join()  # sparknet: join-ok()
        """,
    "unknown_rule": """
        x = 1  # sparknet: sink-ok(typo'd rule)
        """,
    "parenthesized_reason": """
        def f(p):
            # sparknet: join-ok(bounded (by the peer's) timeout)
            p.join()
        """,
    "trailing_marker": """
        def f(p, q):
            p.join()  # sparknet: join-ok(bounded)
            q.join()
        """,
}
NEUTRAL = [("thread", k, v) for k, v in THREAD_FIXTURES.items()] + [
    ("marker", k, v) for k, v in MARKER_FIXTURES.items()] + [
    ("registry", k, v) for k, v in REGISTRY_FIXTURES.items()]


class TestAgainstJax:
    @pytest.mark.parametrize("kind,name,src", NEUTRAL,
                             ids=[f"{k}-{n}" for k, n, _ in NEUTRAL])
    def test_neutral_fixture_gives_the_jax_keys(self, kind, name, src):
        """On the framework-neutral fixtures the two runners give the
        same finding keys (the registry's: the emitter-side findings,
        whose keys name the fixture) and the same suppressed sites."""
        src = textwrap.dedent(src)
        audit = kind == "registry"
        got = runner.scan_source(src, hot_scopes=set(), audit_registry=audit)
        want = jrunner.scan_source(src, hot_scopes=set(),
                                   audit_registry=audit)

        def keys(rep):
            return sorted(f.key for f in rep.findings
                          if f.path == "<fixture>.py")

        assert keys(got) == keys(want)
        assert keys(got) or kind != "registry"
        assert ([(s.checker, s.line, s.reason) for s in got.suppressed]
                == [(s.checker, s.line, s.reason) for s in want.suppressed])

    def test_canon_is_the_jax_canon_less_what_the_port_does_not_emit(self):
        want = dict(jregistry.CANONICAL_METRICS)
        for name in registry.DOCUMENTED_ABSENT:
            want.pop(name)
        assert registry.DOCUMENTED_ABSENT == {
            "sparknet_jit_cache_size": "the port compiles no XLA programs"}
        assert registry.CANONICAL_METRICS == want
        spans = {c: set(v) for c, v in jregistry.CANONICAL_SPANS.items()}
        spans["phase"].add("allgather")
        assert {c: set(v) for c, v in registry.CANONICAL_SPANS.items()} \
            == spans
        assert registry.COMM_SPANS == jregistry.COMM_SPANS
        assert registry.DOC_IGNORED_PREFIXES == jregistry.DOC_IGNORED_PREFIXES

    def test_hot_modules_are_the_jax_modules(self):
        """Every module the JAX registry polices has its entry here; every
        JAX scope has its counterpart or is named in the registry's
        docstring with its reason, and so is every port-only scope."""
        from sparknet_tpu_torch.analysis import hotpaths

        assert set(JHOT_PATHS) <= set(HOT_PATHS)
        doc = hotpaths.__doc__
        for rel, quals in JHOT_PATHS.items():
            for q in quals - HOT_PATHS[rel]:
                assert f"``{q}``" in doc, (rel, q)
        for rel, quals in HOT_PATHS.items():
            for q in quals - JHOT_PATHS.get(rel, frozenset()):
                assert f"``{q}``" in doc, (rel, q)

    def test_both_gates_pass_on_the_shared_docs(self):
        """PERF.md and README.md describe both packages: the JAX audit's
        docs leg and the port's both pass on them."""
        for run in (jrunner.scan_package(REPO, with_docs=True),
                    _port_scan()):
            docs = [f.message for f in run.findings if f.scope == "<docs>"]
            assert not docs, docs


# ----------------------------------------------------------------------
# runner / baseline / CLI
# ----------------------------------------------------------------------

class TestRunnerAndCLI:
    def test_hot_path_registry_names_real_scopes(self):
        """Every (module, qualname) in HOT_PATHS must exist in the port —
        a rename that silently empties the hot set would disarm the
        checker."""
        for rel, quals in HOT_PATHS.items():
            path = os.path.join(REPO, "sparknet_tpu_torch", rel)
            assert os.path.exists(path), rel
            with open(path) as f:
                tree = ast.parse(f.read())
            funcs = set(astutil.collect_functions(tree))
            missing = set(quals) - funcs
            assert not missing, (rel, sorted(missing))

    def test_finding_keys_are_line_number_free_and_ordinal_unique(self):
        rep = _scan(
            """
            import numpy as np

            def round_loop(a, b):
                x = np.asarray(a)
                y = np.asarray(b)
                return x, y
            """,
            hot={"round_loop"},
        )
        keys = [f.key for f in rep.findings]
        assert len(keys) == len(set(keys)) == 2
        for k in keys:
            assert ":5:" not in k and ":6:" not in k  # no line numbers

    def test_allowlist_waives_exact_keys_and_reports_stale(self):
        rep = _scan(
            """
            def round_loop(a):
                return a.item()
            """,
            hot={"round_loop"},
        )
        key = rep.findings[0].key
        entries = [
            {"key": key, "reason": "fixture baseline"},
            {"key": "sync-in-hot-path:gone.py:f:ancient", "reason": "x"},
        ]
        new, waived, stale = runner.apply_allowlist(rep, entries)
        assert not new and len(waived) == 1
        assert stale == ["sync-in-hot-path:gone.py:f:ancient"]

    def test_allowlist_entries_require_reasons(self, tmp_path):
        p = tmp_path / "allow.json"
        p.write_text(json.dumps([{"key": "k"}]))
        with pytest.raises(ValueError):
            runner.load_allowlist(str(p))

    def test_whole_port_check_passes_tier1(self):
        """THE tier-1 guard: ``python -m sparknet_tpu_torch.tools.lint
        --check`` over the tree exits 0 against the committed allowlist —
        and that allowlist stays tiny (<= 5 justified entries).
        ``--show-suppressed`` enumerates the annotated sites, each with
        its reason."""
        out = _lint("--check", "--show-suppressed")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "(0 new," in out.stdout
        with open(os.path.join(REPO, "sparknet_tpu_torch", "tools",
                               "lint_allowlist.json")) as f:
            allow = json.load(f)
        assert len(allow) <= 5, allow
        for e in allow:
            assert str(e.get("reason", "")).strip(), e
        lines = [line for line in out.stdout.splitlines()
                 if line.startswith("suppressed ")]
        for site in ("sparknet_tpu_torch/parallel/comm.py",
                     "sparknet_tpu_torch/serve/engine.py",
                     "sparknet_tpu_torch/obs/profile.py",
                     "sparknet_tpu_torch/utils/timers.py"):
            assert any(line.startswith(f"suppressed {site}:")
                       for line in lines), site
        assert all(" -- " in line and line.split(" -- ", 1)[1].strip()
                   for line in lines)
        assert f"{len(lines)} annotated site(s)" in out.stdout

    def test_cli_fails_on_a_seeded_item_in_the_round(self, tmp_path):
        """A copy of the port with one ``.item()`` seeded into
        ``ParameterAveragingTrainer.round``: ``--check`` exits 1 naming
        exactly it."""
        shutil.copytree(
            os.path.join(REPO, "sparknet_tpu_torch"),
            tmp_path / "sparknet_tpu_torch",
            ignore=shutil.ignore_patterns("__pycache__", "csrc"))
        for doc in ("PERF.md", "README.md"):
            shutil.copy(os.path.join(REPO, doc), tmp_path / doc)
        path = tmp_path / "sparknet_tpu_torch" / "parallel" / "trainers.py"
        src = path.read_text()
        anchor = "        if self.metrics is not None:\n            " \
            "self.metrics.rounds.inc()\n"
        assert src.count(anchor) == 1
        path.write_text(src.replace(
            anchor, "        last = losses.max().item()\n" + anchor))
        out = _lint("--check", "--root", str(tmp_path))
        assert out.returncode == 1, out.stdout + out.stderr
        new = [line for line in out.stdout.splitlines() if ": [" in line]
        assert new == [
            f"sparknet_tpu_torch/parallel/trainers.py:"
            f"{src[:src.index(anchor)].count(chr(10)) + 1}: "
            "[sync-in-hot-path] ParameterAveragingTrainer.round: .item() "
            "syncs host<->device inside hot path "
            "'ParameterAveragingTrainer.round'"], out.stdout
        assert "(1 new, 0 waived)" in out.stdout

    def test_cli_fails_on_a_pageable_constant_in_the_loss(self, tmp_path):
        """``ops/losses.py`` is a port-only hot module: putting back the
        loss normalizer's ``torch.tensor(x, device=...)`` (a pageable
        H2D copy each forward) makes ``--check`` exit 1 naming it."""
        shutil.copytree(
            os.path.join(REPO, "sparknet_tpu_torch"),
            tmp_path / "sparknet_tpu_torch",
            ignore=shutil.ignore_patterns("__pycache__", "csrc"))
        for doc in ("PERF.md", "README.md"):
            shutil.copy(os.path.join(REPO, doc), tmp_path / doc)
        path = tmp_path / "sparknet_tpu_torch" / "ops" / "losses.py"
        src = path.read_text()
        good = "        return _scalar(1.0, torch.float32, device)\n"
        assert src.count(good) == 1
        path.write_text(src.replace(
            good, "        return torch.tensor(1.0, device=device)\n"))
        out = _lint("--check", "--root", str(tmp_path))
        assert out.returncode == 1, out.stdout + out.stderr
        new = [line for line in out.stdout.splitlines() if ": [" in line]
        line = src[:src.index(good)].count(chr(10)) + 1
        assert len(new) == 1 and new[0].startswith(
            f"sparknet_tpu_torch/ops/losses.py:{line}: [sync-in-hot-path] "
            "_normalizer: "), out.stdout

    def test_checkout_without_perf_md_lints_clean_with_no_docs(self,
                                                               tmp_path):
        """A checkout of the code without PERF.md (``chip_smoke.py``
        phase 23 (a) then passes ``--no-docs``): the code checks alone
        exit 0 with the repo's annotated sites; with the docs leg on,
        only the docs leg's PERF.md findings are new."""
        shutil.copytree(
            os.path.join(REPO, "sparknet_tpu_torch"),
            tmp_path / "sparknet_tpu_torch",
            ignore=shutil.ignore_patterns("__pycache__", "csrc"))
        shutil.copy(os.path.join(REPO, "README.md"), tmp_path / "README.md")
        out = _lint("--check", "--json", "--no-docs", "--root", str(tmp_path))
        assert out.returncode == 0, out.stdout + out.stderr
        rep = json.loads(out.stdout)
        whole = json.loads(_lint("--json").stdout)
        assert rep["new"] == [] and rep["suppressed"] == whole["suppressed"]
        out = _lint("--check", "--json", "--root", str(tmp_path))
        assert out.returncode == 1, out.stdout + out.stderr
        new = json.loads(out.stdout)["new"]
        assert new and all(f["path"] == "PERF.md" and f["scope"] == "<docs>"
                           for f in new), new

    def test_cli_json_lists_the_sync_inventory(self):
        out = _lint("--json")
        assert out.returncode == 0, out.stdout + out.stderr
        rep = json.loads(out.stdout)
        assert rep["new"] == [] and rep["stale_allowlist_keys"] == []
        syncs = [s for s in rep["suppressed"]
                 if s["checker"] == "sync-in-hot-path"]
        paths = {s["path"] for s in syncs}
        assert {"sparknet_tpu_torch/parallel/comm.py",
                "sparknet_tpu_torch/parallel/trainers.py",
                "sparknet_tpu_torch/serve/engine.py"} <= paths
        assert all(s["reason"].strip() and s["end_line"] >= s["line"]
                   for s in syncs)


# ----------------------------------------------------------------------
# the sanitizer's site matching (the real guard runs on the card only:
# chip_smoke.py phase 23)
# ----------------------------------------------------------------------

HOT_SRC = '''\
def round_loop(x):
    # sparknet: sync-ok(the fixture's deliberate sync)
    x.item()
    x.tolist()
    return x
'''
SITE = ("sparknet_tpu_torch/hot.py", 3, "round_loop")
OTHER = ("sparknet_tpu_torch/hot.py", 4, "round_loop")


class _Synchronizing:
    """A stand-in tensor whose reads warn as torch's sync debug mode
    does (from outside the port, as torch's own code is)."""

    def item(self):
        warnings.warn(sanitize.SYNC_WARNING)

    tolist = item


def _frame(path, line, name="f"):
    return traceback.FrameSummary(path, line, name)


class TestSanitizer:
    def test_port_relpath_finds_the_package_anywhere(self):
        assert sanitize.port_relpath(
            "/x/build/tree/sparknet_tpu_torch/parallel/comm.py"
        ) == "sparknet_tpu_torch/parallel/comm.py"
        assert sanitize.port_relpath("/usr/lib/torch/cuda/__init__.py") is None

    def test_an_annotated_site_passes_and_an_unannotated_one_is_named(self):
        rep = runner.scan_source(HOT_SRC, "sparknet_tpu_torch/hot.py",
                                 hot_scopes={"round_loop"})
        (s,) = [s for s in rep.suppressed if s.checker == "sync-in-hot-path"]
        torch_frame = _frame("/usr/lib/torch/_tensor.py", 40, "item")
        events = [
            ("main", [_frame("/r/chip_smoke.py", 9, "leg"),
                      _frame("/r/sparknet_tpu_torch/hot.py", 3,
                             "round_loop"), torch_frame]),
            ("prefetch-producer",
             [_frame("/r/sparknet_tpu_torch/hot.py", 3, "round_loop")]),
            ("comm", [_frame("/r/sparknet_tpu_torch/hot.py", 4,
                             "round_loop")]),
            ("main", [_frame("/r/chip_smoke.py", 12, "leg"), torch_frame]),
        ]
        ok, bad = sanitize.classify(events, rep.suppressed)
        assert ok == {SITE: 2}
        assert bad == {
            OTHER: 1,
            ("<outside the port>: /usr/lib/torch/_tensor.py", 40, "item"): 1}
        # the lint's JSON rows match as its Suppressed records do
        assert sanitize.classify(events, [s.as_dict()])[0] == ok

    def test_recorder_hooks_every_thread_and_passes_other_warnings(
            self, tmp_path, monkeypatch):
        """Real warnings through the hook: each sync warning's stack is
        recorded, on whatever thread, every time (the filter is
        ``always``); other warnings go to the previous hook."""
        pkg = tmp_path / "sparknet_tpu_torch"
        pkg.mkdir()
        (pkg / "hot.py").write_text(HOT_SRC)
        monkeypatch.syspath_prepend(str(tmp_path / "sparknet_tpu_torch"))
        import importlib

        hot = importlib.import_module("hot")
        seen = []
        with warnings.catch_warnings():
            warnings.showwarning = lambda m, *a, **k: seen.append(str(m))
            with sanitize.SyncRecorder(arm=False) as rec:
                hot.round_loop(_Synchronizing())
                t = threading.Thread(target=hot.round_loop,
                                     args=(_Synchronizing(),),
                                     name="producer", daemon=True)
                t.start()
                t.join(timeout=30)
                warnings.warn("an unrelated warning")
        events = rec.snapshot()
        assert [name for name, _ in events] == [
            threading.current_thread().name] * 2 + ["producer"] * 2
        rep = runner.scan_source(HOT_SRC, "sparknet_tpu_torch/hot.py",
                                 hot_scopes={"round_loop"})
        ok, bad = sanitize.classify(events, rep.suppressed)
        assert ok == {SITE: 2} and bad == {OTHER: 2}
        assert seen == ["an unrelated warning"]
        sys.modules.pop("hot", None)

    def test_recorder_wraps_the_waits_for_the_window(self):
        """The waits the debug mode does not report are wrapped while the
        recorder is open: each call recorded under its caller's frame,
        the original run and put back afterwards."""

        class Event:
            def synchronize(self):
                return "waited"

        orig = Event.synchronize
        with sanitize.SyncRecorder(arm=False,
                                   waits=[(Event, "synchronize")]) as rec:
            assert Event().synchronize() == "waited"
            line = sys._getframe().f_lineno - 1
        assert Event.synchronize is orig
        ((thread, stack),) = rec.snapshot()
        assert (stack[-1].filename, stack[-1].lineno) == (__file__, line)
        assert thread == threading.current_thread().name
        assert [p for p, _ in sanitize.WAITS] == ["cuda", "cuda.Event"]
