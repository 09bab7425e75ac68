"""Hot-path invariant linter CLI for the port — the static half of the
sanitizer gate (``chip_smoke.py`` phase 23 is the dynamic half on the
card); the counterpart of the root ``tools/lint.py``.

Runs the ``sparknet_tpu_torch/analysis`` checkers over the port:
sync-in-hot-path, the non_blocking hand-over discipline, thread hygiene
(incl. lock acquisition-order cycles), and the trace/metrics registry
audit.

    python -m sparknet_tpu_torch.tools.lint            # every finding
    python -m sparknet_tpu_torch.tools.lint --check    # tier-1 gate: fail
                                          # on NEW findings vs the
                                          # committed allowlist
    python -m sparknet_tpu_torch.tools.lint --json     # machine-readable
    python -m sparknet_tpu_torch.tools.lint --show-suppressed  # every
                                          # marker-annotated site

``--check`` semantics: a finding whose key is in
``sparknet_tpu_torch/tools/lint_allowlist.json`` is waived (baseline);
anything else is NEW and exits 1.  Stale allowlist keys print as
warnings.  Suppressed (``# sparknet: <rule>-ok(<reason>)``) sites never
fail — they are the audited deliberate-sync inventory the sanitizer
holds the card's syncs to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from sparknet_tpu_torch.analysis import runner

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DEFAULT_ALLOWLIST = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "lint_allowlist.json"
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sparknet_tpu_torch.tools.lint",
        description=__doc__.split("\n", 1)[0])
    ap.add_argument(
        "--check", action="store_true",
        help="fail (exit 1) on findings NOT in the committed allowlist",
    )
    ap.add_argument("--root", default=_REPO,
                    help="repo root (package + docs live here)")
    ap.add_argument("--allowlist", default=DEFAULT_ALLOWLIST,
                    help="baseline allowlist JSON")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also list marker-suppressed (deliberate) sites")
    ap.add_argument("--no-docs", action="store_true",
                    help="skip the docs leg of the registry audit")
    args = ap.parse_args(argv)

    rep = runner.scan_package(args.root, with_docs=not args.no_docs)
    entries = runner.load_allowlist(args.allowlist)
    new, waived, stale = runner.apply_allowlist(rep, entries)

    if args.json:
        print(json.dumps({
            "new": [vars(f) | {"key": f.key} for f in new],
            "waived": [vars(f) | {"key": f.key} for f in waived],
            "stale_allowlist_keys": stale,
            "suppressed": [s.as_dict() for s in rep.suppressed],
        }, indent=1))
    else:
        for f in new:
            print(f.format())
        if waived:
            print("-- %d allowlisted finding(s) waived" % len(waived))
        for k in stale:
            print("-- warning: stale allowlist entry (no longer "
                  "matches): %s" % k)
        if args.show_suppressed:
            for s in rep.suppressed:
                print(
                    "suppressed %s:%d [%s] %s: %s -- %s"
                    % (s.path, s.line, s.checker, s.scope, s.message,
                       s.reason)
                )
        print(
            "lint: %d finding(s) (%d new, %d waived), %d annotated "
            "site(s)"
            % (len(rep.findings), len(new), len(waived),
               len(rep.suppressed))
        )
    if args.check:
        return 1 if new else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
