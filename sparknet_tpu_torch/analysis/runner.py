"""Run every checker over the port (or one source string) and fold the
results into one :class:`findings.Report`, with the committed-allowlist
baseline semantics ``python -m sparknet_tpu_torch.tools.lint --check``
enforces (the port of ``sparknet_tpu/analysis/runner.py``):

- a finding whose :attr:`Finding.key` is in the allowlist is *waived*
  (it existed when the baseline was committed, with a written reason);
- any OTHER finding is NEW and fails the check — the gate that keeps
  the next careless ``loss.item()`` out of a round loop;
- allowlist entries that no longer match anything are reported as
  stale (warning, not failure — deleting them is the cleanup).

The allowlist lives at ``sparknet_tpu_torch/tools/lint_allowlist.json``::

    [{"key": "<finding key>", "reason": "<why this one is waived>"}]

and the acceptance bar is that it stays tiny (<= 5 entries): the
preferred fix is always the code fix, the second-best is an inline
``# sparknet: <rule>-ok(<reason>)`` marker at the site (self-
documenting, enumerable), and the allowlist is the last resort for
findings that have no single site to annotate.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional, Tuple

from sparknet_tpu_torch.analysis import (
    astutil,
    donation_check,
    registry_audit,
    sync_check,
    thread_check,
)
from sparknet_tpu_torch.analysis.findings import Finding, Markers, Report
from sparknet_tpu_torch.analysis.hotpaths import hot_scopes_for


def scan_source(
    source: str,
    relpath: str = "<fixture>.py",
    hot_scopes: Optional[set] = None,
    audit_registry: bool = False,
) -> Report:
    """Lint one source string — the fixture-test entry point.  Hot
    scopes default to the registry lookup for ``relpath`` (usually
    empty for fixtures, so pass the scopes the fixture exercises)."""
    tree = ast.parse(source)
    markers = Markers(source)
    targets = astutil.thread_target_names(tree)
    rep = Report()
    rep.findings.extend(markers.marker_findings(relpath))
    rep.extend(sync_check.check_module(
        tree, relpath, markers,
        hot_scopes if hot_scopes is not None else hot_scopes_for(relpath),
        targets,
    ))
    rep.extend(donation_check.check_module(tree, relpath, markers))
    t_rep, locks = thread_check.check_module(tree, relpath, markers, targets)
    rep.extend(t_rep)
    rep.extend(thread_check.lock_cycle_findings(
        [(relpath, locks)], {relpath: markers}
    ))
    if audit_registry:
        inv = registry_audit.Inventory()
        registry_audit.collect_module(tree, relpath, inv)
        rep.extend(registry_audit.audit(inv))
    return rep.finalize()


def _iter_py_files(pkg_dir: str):
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [
            d for d in dirnames if d != "__pycache__"
        ]
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def scan_package(
    root: str,
    package: str = "sparknet_tpu_torch",
    with_docs: bool = True,
) -> Report:
    """Lint the whole package under ``root`` (the repo checkout)."""
    pkg_dir = os.path.join(root, package)
    rep = Report()
    inv = registry_audit.Inventory()
    all_locks: List[Tuple[str, thread_check._ModuleLocks]] = []
    markers_by_path: Dict[str, Markers] = {}
    for path in _iter_py_files(pkg_dir):
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        pkg_rel = os.path.relpath(path, pkg_dir).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            rep.findings.append(Finding(
                checker="parse", path=relpath, line=e.lineno or 1,
                scope="<module>", message=f"syntax error: {e.msg}",
            ))
            continue
        markers = Markers(source)
        markers_by_path[relpath] = markers
        rep.findings.extend(markers.marker_findings(relpath))
        targets = astutil.thread_target_names(tree)
        rep.extend(sync_check.check_module(
            tree, relpath, markers, hot_scopes_for(pkg_rel), targets,
        ))
        rep.extend(donation_check.check_module(tree, relpath, markers))
        t_rep, locks = thread_check.check_module(
            tree, relpath, markers, targets, module_key=pkg_rel,
        )
        rep.extend(t_rep)
        all_locks.append((relpath, locks))
        registry_audit.collect_module(tree, relpath, inv)
    rep.extend(thread_check.lock_cycle_findings(all_locks, markers_by_path))
    docs = None
    if with_docs:
        docs = {}
        for fname in registry_audit.DOC_FILES:
            p = os.path.join(root, fname)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    docs[fname] = f.read()
    rep.extend(registry_audit.audit(inv, docs))
    return rep.finalize()


def load_allowlist(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        entries = json.load(f)
    for e in entries:
        if "key" not in e or not str(e.get("reason", "")).strip():
            raise ValueError(
                "allowlist entries need both 'key' and a non-empty "
                f"'reason': {e!r}"
            )
    return entries


def apply_allowlist(
    rep: Report, entries: List[dict]
) -> Tuple[list, list, list]:
    """Split findings into (new, waived, stale-allowlist-keys)."""
    allowed = {e["key"] for e in entries}
    new = [f for f in rep.findings if f.key not in allowed]
    waived = [f for f in rep.findings if f.key in allowed]
    present = {f.key for f in rep.findings}
    stale = sorted(allowed - present)
    return new, waived, stale
