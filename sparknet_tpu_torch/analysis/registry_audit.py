"""Trace/metrics registry audit: emitters and folders must agree (the
port of ``sparknet_tpu/analysis/registry_audit.py``).

Collects, across the scanned package:

- every ``registry.counter/gauge/histogram("sparknet_...")`` literal
  (name + ``labels=`` tuple) — the metric emitters;
- every ``span("...")`` / ``obs.span("...")`` literal with its ``cat``
  (default ``"phase"``) — the span emitters;

and cross-checks them against ``analysis.registry``'s canonical sets,
both directions, plus the docs:

- emitted-but-uncanonical: the folding side (the round profiler,
  dashboards) won't know the name exists;
- canonical-but-never-emitted: the registry documents a ghost;
- label drift: same name, different label tuple;
- docs drift (``DOC_FILES``: PERF.md and README.md, which describe the
  port beside the JAX package; ARCHITECTURE.md is the JAX package's
  alone): every canonical metric and phase must appear in PERF.md's
  telemetry reference, and every ``sparknet_*`` token the docs mention
  must be canonical or a ``DOCUMENTED_ABSENT`` name (tokens ending in
  ``_`` are accepted as explicit prefix mentions).

Dynamic names (f-strings, variables) are skipped — the audit polices
the literal vocabulary, and the framework's instant names are the only
dynamic ones (``fault_{kind}``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from sparknet_tpu_torch.analysis import astutil
from sparknet_tpu_torch.analysis.findings import Finding, Report
from sparknet_tpu_torch.analysis.registry import (
    CANONICAL_METRICS,
    CANONICAL_SPANS,
    DOC_IGNORED_PREFIXES,
    DOCUMENTED_ABSENT,
)

CHECKER = "registry-audit"

_METRIC_CTORS = ("counter", "gauge", "histogram")
_DOC_TOKEN_RE = re.compile(r"sparknet_[a-z0-9_]+")
_REGISTRY_PATH = "sparknet_tpu_torch/analysis/registry.py"
# the docs the audit reads: both describe the port (ARCHITECTURE.md is
# the JAX package's alone)
DOC_FILES = ("PERF.md", "README.md")


class Inventory:
    """What the code actually emits."""

    def __init__(self):
        # name -> [(labels, path, line), ...] — EVERY emitter is kept:
        # two emitters of one name with different label tuples is
        # exactly the drift the audit exists to catch
        self.metrics: Dict[str, List[Tuple[Tuple[str, ...], str, int]]] = {}
        # (cat, name) -> (path, line)
        self.spans: Dict[Tuple[str, str], Tuple[str, int]] = {}


def collect_module(tree: ast.Module, relpath: str, inv: Inventory) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _METRIC_CTORS:
            name = astutil.literal_str(node.args[0]) if node.args else None
            if name and name.startswith("sparknet_"):
                labels: Tuple[str, ...] = ()
                kw = astutil.kwarg(node, "labels")
                if isinstance(kw, (ast.Tuple, ast.List)):
                    labels = tuple(
                        el.value for el in kw.elts
                        if isinstance(el, ast.Constant)
                    )
                inv.metrics.setdefault(name, []).append(
                    (labels, relpath, node.lineno)
                )
        is_span = (
            (isinstance(fn, ast.Name) and fn.id == "span")
            or (isinstance(fn, ast.Attribute) and fn.attr == "span")
        )
        if is_span and node.args:
            name = astutil.literal_str(node.args[0])
            if name is None:
                continue
            cat = astutil.literal_str(astutil.kwarg(node, "cat")) or "phase"
            inv.spans.setdefault((cat, name), (relpath, node.lineno))


def audit(
    inv: Inventory,
    docs: Optional[Dict[str, str]] = None,
) -> Report:
    """Cross-check the inventory against the canonical sets (and the
    docs text when given: ``{filename: content}``)."""
    rep = Report()

    for name, emitters in sorted(inv.metrics.items()):
        for labels, path, line in emitters:
            if name not in CANONICAL_METRICS:
                rep.findings.append(Finding(
                    checker=CHECKER, path=path, line=line,
                    scope="<metrics>",
                    message=f"metric {name!r} emitted but not in the "
                    "canonical registry (analysis/registry.py) — "
                    "folders and dashboards won't know it exists",
                    fixit="add it to CANONICAL_METRICS and the PERF.md "
                    "telemetry reference",
                ))
                break  # one report per name suffices for this class
            if tuple(CANONICAL_METRICS[name]) != tuple(labels):
                # checked per EMITTER: a second module re-registering
                # the name with different labels must not hide behind
                # a canon-conforming first emitter
                rep.findings.append(Finding(
                    checker=CHECKER, path=path, line=line,
                    scope="<metrics>",
                    message=f"metric {name!r} label drift: emits "
                    f"{tuple(labels)!r}, registry says "
                    f"{tuple(CANONICAL_METRICS[name])!r}",
                    fixit="make the emitter and CANONICAL_METRICS agree",
                ))
    for name in sorted(CANONICAL_METRICS):
        if name not in inv.metrics:
            rep.findings.append(Finding(
                checker=CHECKER, path=_REGISTRY_PATH,
                line=1, scope="<metrics>",
                message=f"canonical metric {name!r} is never emitted "
                "(documented ghost)",
                fixit="emit it or drop it from CANONICAL_METRICS",
            ))

    emitted_by_cat: Dict[str, Set[str]] = {}
    for (cat, name), (path, line) in sorted(inv.spans.items()):
        emitted_by_cat.setdefault(cat, set()).add(name)
        canon = CANONICAL_SPANS.get(cat)
        if canon is None or name not in canon:
            rep.findings.append(Finding(
                checker=CHECKER, path=path, line=line, scope="<spans>",
                message=f"span {name!r} (cat={cat!r}) emitted but not "
                "in the canonical span set — trace_report/profile "
                "folding won't attribute it",
                fixit="add it to CANONICAL_SPANS[%r] (and the PERF.md "
                "phase table for phase-cat spans)" % cat,
            ))
    for cat, names in CANONICAL_SPANS.items():
        for name in sorted(names - emitted_by_cat.get(cat, set())):
            rep.findings.append(Finding(
                checker=CHECKER, path=_REGISTRY_PATH,
                line=1, scope="<spans>",
                message=f"canonical span {name!r} (cat={cat!r}) is "
                "never emitted (documented ghost)",
                fixit="emit it or drop it from CANONICAL_SPANS",
            ))

    if docs:
        all_text = "\n".join(docs.values())
        perf = docs.get("PERF.md", "")
        for name in sorted(CANONICAL_METRICS):
            if name not in perf:
                rep.findings.append(Finding(
                    checker=CHECKER, path="PERF.md", line=1,
                    scope="<docs>",
                    message=f"canonical metric {name!r} missing from "
                    "the PERF.md telemetry reference",
                    fixit="add a row to the metrics table",
                ))
        for name in sorted(CANONICAL_SPANS["phase"]):
            if name not in perf:
                rep.findings.append(Finding(
                    checker=CHECKER, path="PERF.md", line=1,
                    scope="<docs>",
                    message=f"canonical phase {name!r} missing from "
                    "the PERF.md telemetry reference",
                    fixit="add it to the phase table",
                ))
        doc_tokens = set(_DOC_TOKEN_RE.findall(all_text))
        for tok in sorted(doc_tokens):
            if any(tok.startswith(p) for p in DOC_IGNORED_PREFIXES):
                continue
            if tok in CANONICAL_METRICS or tok in DOCUMENTED_ABSENT:
                continue
            if tok.endswith("_") and any(
                m.startswith(tok) for m in CANONICAL_METRICS
            ):
                continue  # explicit prefix mention: sparknet_cache_...
            # a doc token may be a stale (renamed/removed) metric
            rep.findings.append(Finding(
                checker=CHECKER, path="<docs>", line=1, scope="<docs>",
                message=f"docs mention {tok!r} which is not a "
                "canonical metric (stale or typo'd name)",
                fixit="fix the docs or register the name",
            ))
    return rep
