"""CLI for the port's malleability sanitizer + linter (port of
``repro/analysis/__main__.py``).

    python -m repro_torch.analysis lint [PATH ...]    # default: src/repro_torch
    python -m repro_torch.analysis audit TRAIL.json [TRAIL2.json ...]

``lint`` prints ``path:line: CODE message`` per finding; ``audit``
replays a ``dump_trail`` artifact through the schedule-trail race
detector.  Both exit non-zero when anything fires.  The default lint path
holds the port's library and its examples (``repro_torch.examples``).
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.trail import audit_trail_file, load_trail

PROG = "repro_torch.analysis"


def _cmd_lint(paths: List[str]) -> int:
    findings = lint_paths(paths or ["src/repro_torch"])
    for f in findings:
        print(f)
    n_files = "" if not paths else f" in {', '.join(paths)}"
    if findings:
        print(f"{PROG} lint: {len(findings)} finding(s){n_files}",
              file=sys.stderr)
        return 1
    print(f"{PROG} lint: clean{n_files}")
    return 0


def _cmd_audit(paths: List[str]) -> int:
    rc = 0
    for path in paths:
        violations = audit_trail_file(path)
        data = load_trail(path)
        if violations:
            for v in violations:
                print(f"{path}: {v}")
            print(f"{PROG} audit: {len(violations)} violation(s) "
                  f"in {path}", file=sys.stderr)
            rc = 1
        else:
            print(f"{PROG} audit: {path} clean "
                  f"({len(data['trail'])} events, {len(data['jobs'])} "
                  f"jobs, {len(data['pool_ids'])}-device pool, "
                  f"decisions={data['decisions']})")
    return rc


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {PROG}",
        description="malleability sanitizer + linter")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_lint = sub.add_parser("lint", help="AST lint over app/policy code")
    p_lint.add_argument("paths", nargs="*",
                        help="files/directories (default: src/repro_torch)")
    p_audit = sub.add_parser("audit",
                             help="schedule-trail race detection")
    p_audit.add_argument("paths", nargs="+", help="dump_trail artifacts")
    args = parser.parse_args(argv)
    if args.cmd == "lint":
        return _cmd_lint(args.paths)
    return _cmd_audit(args.paths)


if __name__ == "__main__":                               # pragma: no cover
    sys.exit(main())
