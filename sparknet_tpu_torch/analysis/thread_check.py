"""Thread hygiene across the framework's producer/comm/watchdog/server
threads (the port of ``sparknet_tpu/analysis/thread_check.py``; the
rules are framework-neutral and give the JAX runner's finding keys).
The port's threads: the ``Prefetcher`` producer behind ``RoundFeed``,
the comm plane's pacing thread, the async snapshot writer, the serving
batcher, server, delivery watcher and fleet router's mirror, the
exporter, shipper, collector and SLO evaluator of ``obs/``, the record
reader of ``runtime/``, and the launcher's preemption thread and its
children's pipe drains (``utils/procs.py``).

Rules (marker in parentheses suppresses, with a mandatory reason):

- ``thread-anonymous`` (``thread-ok``): every ``threading.Thread(...)``
  must pass ``name=`` — anonymous threads make traces, stall reports
  and ``py-spy`` dumps unattributable (the tracer labels Perfetto
  tracks from thread names).
- ``thread-daemon`` (``thread-ok``): ``daemon=`` must be explicit.  The
  default (inherit from spawner) silently flips lifecycle semantics
  when a thread starts another thread.
- ``join-no-timeout`` (``join-ok``): ``.join()`` with no timeout
  blocks forever on a wedged thread.  Allowed inside shutdown-path
  functions (name contains stop/close/shutdown/teardown/cleanup/
  reset/finalize/__exit__/drain/wait — teardown is allowed to wait);
  anywhere else it needs a bound or a justification.
- ``except-bare`` / ``except-swallow`` (``except-ok``): a bare
  ``except:`` anywhere, or an ``except ...: pass`` inside a
  thread-target function — a producer/comm thread that swallows its
  error dies silently and the consumer hangs until a watchdog fires.
- ``lock-order-cycle`` (``lock-ok``): the cross-module lock
  acquisition-order graph (``with a_lock:`` nested inside ``with
  b_lock:``, plus one level of intra-module call propagation) must be
  acyclic; a cycle is a latent deadlock between framework threads.

Lock identity is ``module:Class.attr`` for ``self._lock``-style
attributes and ``module:function.name`` for locals — good enough to
catch real inversions without alias analysis.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from sparknet_tpu_torch.analysis import astutil
from sparknet_tpu_torch.analysis.findings import (
    Finding,
    Markers,
    Report,
    Suppressed,
)

CHECKER = "thread-hygiene"

SHUTDOWN_TOKENS = (
    "stop", "close", "shutdown", "teardown", "cleanup", "reset",
    "finalize", "exit", "drain", "wait", "atexit", "reap", "del",
)

_LOCK_NAME_TOKENS = ("lock", "_lock", "mutex", "cond", "nonempty")


def _is_shutdown_scope(qual: str) -> bool:
    """Underscore-segment match, not substring: ``wait`` exempts
    ``wait``/``wait_all`` but not ``await_result``."""
    leaf = qual.split(".")[-1].lower()
    segs = [s for s in leaf.split("_") if s]
    return any(tok in segs for tok in SHUTDOWN_TOKENS)


def _lock_id(expr: ast.AST, module: str, qual: str) -> Optional[str]:
    """A stable id for a lock-ish ``with`` context expression, or None
    when the expression doesn't look like a lock."""
    name = astutil.dotted(expr)
    if not name:
        return None
    leaf = name.split(".")[-1]
    if not any(tok in leaf.lower() for tok in _LOCK_NAME_TOKENS):
        return None
    if name.startswith("self."):
        cls = qual.split(".")[0] if "." in qual else qual
        return f"{module}:{cls}.{leaf}"
    return f"{module}:{name}"


class _ModuleLocks:
    """Per-module lock facts: which locks each function acquires, and
    the syntactic nesting edges."""

    def __init__(self):
        self.acquires: Dict[str, Set[str]] = {}   # qual -> lock ids
        # (lock_a, lock_b, path, line) — a held while acquiring b
        self.edges: List[Tuple[str, str, str, int, str]] = []
        self.calls_under: List[Tuple[str, str, str, int, str]] = []
        # (lock_a, called-leaf-name, path, line, qual)


def check_module(
    tree: ast.Module,
    relpath: str,
    markers: Markers,
    thread_targets: Set[str],
    module_key: Optional[str] = None,
) -> Tuple[Report, _ModuleLocks]:
    rep = Report()
    module = module_key or relpath
    locks = _ModuleLocks()
    funcs = astutil.collect_functions(tree)

    def _emit(rule: str, marker: str, node: ast.AST, qual: str,
              message: str, fixit: str) -> None:
        lo, hi = astutil.span_lines(node)
        reason = markers.covers(marker, lo, hi)
        if reason is not None:
            rep.suppressed.append(Suppressed(
                f"{CHECKER}/{rule}", relpath, lo, qual, message, reason,
            ))
        else:
            rep.findings.append(Finding(
                checker=f"{CHECKER}/{rule}", path=relpath, line=lo,
                scope=qual, message=message, fixit=fixit,
            ))

    for qual, fn in funcs.items():
        leaf = qual.split(".")[-1]
        in_thread_target = leaf in thread_targets
        held: List[str] = []

        def visit(node: ast.AST, held: List[str], qual=qual,
                  in_thread_target=in_thread_target) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # nested defs are separate scopes
            if isinstance(node, ast.Call):
                if astutil.is_thread_ctor(node):
                    if astutil.kwarg(node, "name") is None:
                        _emit(
                            "thread-anonymous", "thread", node, qual,
                            "threading.Thread(...) without name= — "
                            "unattributable in traces and stall dumps",
                            "pass name=\"<subsystem>-<role>\"",
                        )
                    if astutil.kwarg(node, "daemon") is None:
                        _emit(
                            "thread-daemon", "thread", node, qual,
                            "threading.Thread(...) without an explicit "
                            "daemon= policy",
                            "pass daemon=True (reaped threads) or "
                            "daemon=False (must-complete work), "
                            "deliberately",
                        )
                fnode = node.func
                if (
                    isinstance(fnode, ast.Attribute)
                    and fnode.attr == "join"
                    and not node.args
                    and not node.keywords
                    and not _is_shutdown_scope(qual)
                ):
                    _emit(
                        "join-no-timeout", "join", node, qual,
                        ".join() with no timeout outside a shutdown "
                        "path can hang the caller on a wedged thread",
                        "join(timeout=...) and handle the still-alive "
                        "case, or annotate with # sparknet: "
                        "join-ok(<why the wait is bounded>)",
                    )
                # one-level call propagation for the lock-order graph
                if held:
                    callee = astutil.dotted(node.func)
                    if callee:
                        locks.calls_under.append((
                            held[-1], callee.split(".")[-1], relpath,
                            node.lineno, qual,
                        ))
            if isinstance(node, ast.ExceptHandler):
                if node.type is None:
                    _emit(
                        "except-bare", "except", node, qual,
                        "bare except: catches SystemExit/"
                        "KeyboardInterrupt and hides the real error",
                        "catch Exception (or the specific error) and "
                        "record it",
                    )
                elif in_thread_target and all(
                    isinstance(b, ast.Pass) for b in node.body
                ):
                    # `except Full: continue` retry loops are the
                    # polite-put pattern, not a swallow — only a body
                    # of pure `pass` hides an error
                    _emit(
                        "except-swallow", "except", node, qual,
                        "exception swallowed (pass) inside a thread "
                        "target — the thread dies silently and the "
                        "consumer hangs until a watchdog fires",
                        "record the error for the consumer "
                        "(the Prefetcher._run pattern) or log it",
                    )
            if isinstance(node, (ast.With, ast.AsyncWith)):
                ids = []
                for item in node.items:
                    lid = _lock_id(item.context_expr, module, qual)
                    if lid is not None:
                        ids.append(lid)
                        locks.acquires.setdefault(qual, set()).add(lid)
                        if held:
                            locks.edges.append((
                                held[-1], lid, relpath,
                                item.context_expr.lineno, qual,
                            ))
                held.extend(ids)
                for child in ast.iter_child_nodes(node):
                    visit(child, held)
                for _ in ids:
                    held.pop()
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, held)
    return rep, locks


def lock_cycle_findings(
    all_locks: List[Tuple[str, "_ModuleLocks"]],
    markers_by_path: Dict[str, Markers],
) -> Report:
    """Fold every module's lock facts into one acquisition-order graph
    (syntactic nesting edges + one level of call propagation within a
    module) and report each cycle once."""
    rep = Report()
    edges: Dict[str, Set[str]] = {}
    edge_site: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add_edge(a: str, b: str, path: str, line: int, qual: str) -> None:
        if a == b:
            return
        edges.setdefault(a, set()).add(b)
        edge_site.setdefault((a, b), (path, line, qual))

    for relpath, ml in all_locks:
        for a, b, path, line, qual in ml.edges:
            add_edge(a, b, path, line, qual)
        # call propagation: `with A: self.m()` where m acquires B
        acq_by_leaf: Dict[str, Set[str]] = {}
        for qual, ids in ml.acquires.items():
            acq_by_leaf.setdefault(qual.split(".")[-1], set()).update(ids)
        for a, callee_leaf, path, line, qual in ml.calls_under:
            for b in acq_by_leaf.get(callee_leaf, ()):
                add_edge(a, b, path, line, qual)

    # cycle detection: DFS with coloring; report each cycle's canonical
    # rotation once
    seen_cycles: Set[Tuple[str, ...]] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(u: str) -> None:
        color[u] = GRAY
        stack.append(u)
        for v in sorted(edges.get(u, ())):
            c = color.get(v, WHITE)
            if c == WHITE:
                dfs(v)
            elif c == GRAY:
                i = stack.index(v)
                cyc = tuple(stack[i:])
                k = min(range(len(cyc)), key=lambda j: cyc[j])
                canon = cyc[k:] + cyc[:k]
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    path, line, qual = edge_site.get(
                        (u, v), ("<graph>", 0, "<graph>")
                    )
                    msg = (
                        "lock acquisition-order cycle: "
                        + " -> ".join(canon + (canon[0],))
                    )
                    markers = markers_by_path.get(path)
                    reason = (
                        markers.covers("lock", line, line)
                        if markers else None
                    )
                    if reason is not None:
                        rep.suppressed.append(Suppressed(
                            f"{CHECKER}/lock-order-cycle", path, line,
                            qual, msg, reason,
                        ))
                    else:
                        rep.findings.append(Finding(
                            checker=f"{CHECKER}/lock-order-cycle",
                            path=path, line=line, scope=qual, message=msg,
                            fixit="pick one global order for these locks "
                            "(or drop to a single lock); a cycle is a "
                            "latent deadlock between framework threads",
                        ))
        stack.pop()
        color[u] = BLACK

    for node in sorted(edges):
        if color.get(node, WHITE) == WHITE:
            dfs(node)
    return rep
