"""The shared finding/fixit shape every checker emits, plus the
suppression-marker grammar (the port of
``sparknet_tpu/analysis/findings.py``: the same keys, the same grammar).

A finding's :meth:`Finding.key` is deliberately line-number-free
(``checker:path:scope:message[#ordinal]``): the committed allowlist
baseline (``tools/lint_allowlist.json``) must survive unrelated edits
shifting line numbers, while still distinguishing two identical
violations in one scope (the ordinal).

Marker grammar — one comment suppresses one checker's rule at one
statement::

    # sparknet: <rule>-ok(<reason>)

where ``<rule>`` is the checker's marker name (``sync``, ``donation``,
``thread``, ``join``, ``except``, ``lock``) and ``<reason>`` is a
mandatory free-text justification.  The marker sits on a line of the
flagged statement (``lineno..end_lineno`` — a wrapped call can carry it
on any of its lines) or on the line immediately above it (the readable
placement for statements that fill their line).  Markers with an empty
reason are reported as ``marker`` findings: a suppression that does not
say *why* is a suppression nobody can audit.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the reason runs to the LAST ')' on the line (anchored), so reasons
# may themselves contain parentheses — "(num_workers,) verdict read"
# must not truncate at its first ')'
MARKER_RE = re.compile(
    r"#\s*sparknet:\s*([a-z]+)-ok\((.*)\)\s*$"
)

# every marker name a checker honors; anything else in a sparknet:
# comment is a typo'd rule and gets flagged (a marker that silently
# suppresses nothing is worse than no marker).  registry-audit
# findings are deliberately NOT site-suppressible — the fix is always
# the canonical registry or the docs, never the emitter.
KNOWN_MARKERS = (
    "sync", "donation", "thread", "join", "except", "lock",
)


@dataclass
class Finding:
    checker: str            # e.g. "sync-in-hot-path"
    path: str               # repo-relative, forward slashes
    line: int               # 1-indexed
    scope: str              # enclosing qualname ("Class.method") or "<module>"
    message: str            # one line: what and why it matters
    fixit: Optional[str] = None   # suggested mechanical fix
    ordinal: int = 0        # disambiguates identical findings in a scope

    @property
    def key(self) -> str:
        base = f"{self.checker}:{self.path}:{self.scope}:{self.message}"
        return base if self.ordinal == 0 else f"{base}#{self.ordinal}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: [{self.checker}] {self.scope}: {self.message}"
        if self.fixit:
            out += f"\n    fix: {self.fixit}"
        return out


@dataclass
class Suppressed:
    """An annotated (deliberate) site — enumerable, not a failure.
    ``end_line`` is the last line of the flagged call (``line`` when it
    fits one line): the sanitizer matches a synchronizing call's frame
    against the whole span."""

    checker: str
    path: str
    line: int
    scope: str
    message: str
    reason: str
    end_line: int = 0

    def as_dict(self) -> dict:
        return {
            "checker": self.checker, "path": self.path, "line": self.line,
            "end_line": self.end_line or self.line,
            "scope": self.scope, "message": self.message,
            "reason": self.reason,
        }


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Suppressed] = field(default_factory=list)

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)

    def finalize(self) -> "Report":
        """Assign ordinals to otherwise-identical findings so baseline
        keys stay unique, and sort for stable output."""
        seen: Dict[str, int] = {}
        for f in sorted(
            self.findings, key=lambda f: (f.path, f.line, f.checker)
        ):
            base = f"{f.checker}:{f.path}:{f.scope}:{f.message}"
            f.ordinal = seen.get(base, 0)
            seen[base] = f.ordinal + 1
        self.findings.sort(key=lambda f: (f.path, f.line, f.checker))
        self.suppressed.sort(key=lambda s: (s.path, s.line))
        return self


class Markers:
    """Per-file suppression-marker index: ``covers(rule, lo, hi)`` says
    whether any line in [lo - 1, hi] carries ``# sparknet:
    <rule>-ok(...)`` with a non-empty reason.  The scan is over raw
    source lines, so markers inside string literals (the embedded
    worker sources in ``utils/procs.py``) are indexed too — harmless
    documentation there, and the reason unused markers are NOT reported
    as findings (a string-embedded annotation is deliberate, not
    dead)."""

    def __init__(self, source: str):
        # line -> list of (rule, reason, comment_only)
        self.by_line: Dict[int, List[Tuple[str, str, bool]]] = {}
        self.empty: List[Tuple[int, str]] = []   # (line, rule)
        self.unknown: List[Tuple[int, str]] = []  # (line, rule)
        for i, text in enumerate(source.splitlines(), start=1):
            for m in MARKER_RE.finditer(text):
                rule, reason = m.group(1), m.group(2).strip()
                if rule not in KNOWN_MARKERS:
                    self.unknown.append((i, rule))
                    continue
                if not reason:
                    self.empty.append((i, rule))
                    continue
                comment_only = text.lstrip().startswith("#")
                self.by_line.setdefault(i, []).append(
                    (rule, reason, comment_only)
                )

    def covers(self, rule: str, lo: int, hi: Optional[int]) -> Optional[str]:
        """The reason of the first matching marker in [lo - 1, hi]
        (the statement's lines, or the line immediately above it), else
        None.  ``hi=None`` means single-line.  The line-above lookback
        honors COMMENT-ONLY lines exclusively: a trailing same-line
        marker on the previous statement must not leak onto (and
        silently bless) the next statement's violation."""
        for line in range(max(1, lo - 1), (hi or lo) + 1):
            for r, reason, comment_only in self.by_line.get(line, ()):
                if r == rule and (comment_only or line >= lo):
                    return reason
        return None

    def marker_findings(self, path: str) -> List[Finding]:
        out = []
        for line, rule in self.empty:
            out.append(Finding(
                checker="marker", path=path, line=line, scope="<marker>",
                message=f"{rule}-ok marker with an empty reason",
                fixit="every suppression must say why: "
                f"# sparknet: {rule}-ok(<reason>)",
            ))
        for line, rule in self.unknown:
            out.append(Finding(
                checker="marker", path=path, line=line, scope="<marker>",
                message=f"unknown marker rule {rule!r}",
                fixit="known rules: %s" % ", ".join(KNOWN_MARKERS),
            ))
        return out
