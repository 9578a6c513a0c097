"""Run the repro_torch.lint static analyzer over the port.

Usage:
    python -m repro_torch.lint [paths...] [--root DIR] [--baseline F]
                               [--no-baseline] [--update-baseline]
                               [--format=text|json] [--output F]
                               [--rule RULE ...] [--list-rules]

Exit status: 0 when every finding is covered by the baseline (and no
baseline entry is stale), 1 when new findings exist, 2 on usage errors.
``--update-baseline`` rewrites the baseline from the current run and
exits 0 — review the diff; a growing baseline is a code review smell.

The default config scans ``src/repro_torch/**/*.py`` (and the kernels'
CUDA sources, for kernel-abi); pass explicit paths to lint a subset.
``--format=json`` emits the structured report, with the findings that
``# lint: allow`` comments suppressed under ``allowed``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.lint import core as lint

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BASELINE = os.path.join("src", "repro_torch", "lint", "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: config include globs)")
    ap.add_argument("--root", default=_ROOT,
                    help="repository root the paths and globs are relative "
                         "to (default: this checkout)")
    ap.add_argument("--baseline", default=BASELINE,
                    help=f"baseline file, repo-relative (default: {BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run and exit 0")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--output", default=None,
                    help="write the report here instead of stdout")
    ap.add_argument("--rule", action="append", default=None,
                    help="run only these rule ids (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for entry in lint.rule_entries():
            print(f"{entry.rule_id:20s} {entry.severity:8s} "
                  f"[{entry.scope}] {entry.help}")
        return 0

    t0 = time.perf_counter()
    config = lint.LintConfig()
    allowed: list = []
    findings = lint.run_lint(args.root, config, paths=args.paths or None,
                             rules=args.rule, allowed=allowed)
    files = len(lint.discover(args.root, config, args.paths or None))

    baseline_path = os.path.join(args.root, args.baseline)
    if args.update_baseline:
        lint.save_baseline(baseline_path, findings)
        print(f"baseline updated: {args.baseline} "
              f"({len(findings)} finding(s))")
        return 0

    baseline = {} if args.no_baseline else lint.load_baseline(baseline_path)
    new, old, stale = lint.partition(findings, baseline)
    # a partial run (explicit paths / --rule) legitimately misses baseline
    # entries; only a full default run treats them as stale
    partial = bool(args.paths or args.rule)
    seconds = time.perf_counter() - t0

    if args.format == "json":
        report = {
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in old],
            "allowed": [f.to_dict() for f in allowed],
            "stale_baseline": [] if partial else sorted(stale),
            "counts": {"files": files, "new": len(new),
                       "baselined": len(old), "allowed": len(allowed),
                       "stale": 0 if partial else len(stale)},
            "seconds": seconds,
        }
        text = json.dumps(report, indent=2) + "\n"
    else:
        lines = []
        for f in new:
            lines.append(f.render())
        if old:
            lines.append(f"# {len(old)} baselined finding(s) suppressed "
                         f"(see {args.baseline})")
        if stale and not partial:
            lines.append(f"# {len(stale)} stale baseline entr(ies) — the "
                         "code they matched is gone; rerun with "
                         "--update-baseline to retire them")
        if not new:
            lines.append("lint: clean" + (
                "" if not old else " (modulo baseline)"))
        lines.append(f"# {files} files, {len(new)} new, {len(allowed)} "
                     f"allowed, {len(old)} baselined in {seconds:.2f}s")
        text = "\n".join(lines) + "\n"

    if args.output:
        out_path = args.output if os.path.isabs(args.output) else \
            os.path.join(args.root, args.output)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"report written to {args.output} "
              f"({len(new)} new, {len(old)} baselined)")
    else:
        sys.stdout.write(text)

    if new:
        return 1
    if stale and not partial:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
