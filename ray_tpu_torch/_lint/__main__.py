"""CLI: python -m ray_tpu_torch._lint [paths...] | --race

Exit status: 0 when every violation is baselined, 1 when new
violations exist, 2 on unparsable files. ``--race`` runs the port's
lock-witness race run instead (``race.py``) and exits with its status.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .engine import (
    RULES, diff_baseline, lint_paths, load_baseline, write_baseline,
)

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..")
)
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json"
)
#: The linted tree: the port's package. Tests lint clean by convention
#: but are not invariant-bearing; keeping them out keeps the baseline
#: about the runtime.
DEFAULT_PATHS = [os.path.join(REPO_ROOT, "ray_tpu_torch")]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv == ["--race"]:
        from .race import main as race_main

        return race_main()
    ap = argparse.ArgumentParser(prog="python -m ray_tpu_torch._lint")
    ap.add_argument("paths", nargs="*", default=None)
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="snapshot current violations as the accepted debt",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="report every violation (ignore the baseline)",
    )
    ap.add_argument(
        "--only", action="append", default=None,
        help="run only the named rule (repeatable)",
    )
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, (_fn, doc) in sorted(RULES.items()):
            print(f"{name}: {doc}")
        return 0

    paths = args.paths or DEFAULT_PATHS
    violations, errors = lint_paths(paths, REPO_ROOT, only=args.only)
    for e in errors:
        print(f"raylint: parse error: {e}", file=sys.stderr)

    if args.write_baseline:
        if args.paths or args.only:
            # A narrowed run sees only a subset of the debt; writing
            # it wholesale would wipe every other tracked entry and
            # the next full run would drown in "new" violations. Snapshot only from the default full scope.
            print(
                "raylint: refusing --write-baseline with explicit "
                "paths/--only — the baseline is a FULL-scope snapshot; "
                "run `python -m ray_tpu_torch._lint --write-baseline` bare",
                file=sys.stderr,
            )
            return 2
        write_baseline(args.baseline, violations)
        print(
            f"raylint: baseline written: {len(violations)} violation(s) "
            f"-> {args.baseline}"
        )
        return 2 if errors else 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new, fixed = diff_baseline(violations, baseline)

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "total": len(violations),
                    "new": [v.as_dict() for v in new],
                    "baselined": len(violations) - len(new),
                    "fixed_fingerprints": fixed,
                },
                f, indent=1,
            )

    for v in sorted(new, key=lambda v: (v.path, v.line)):
        print(v.render())
    summary = (
        f"raylint: {len(violations)} violation(s), "
        f"{len(violations) - len(new)} baselined, {len(new)} new"
    )
    if fixed:
        summary += (
            f"; {len(fixed)} baseline entr(ies) no longer fire — "
            "run --write-baseline to shrink the debt"
        )
    print(summary)
    if errors:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
