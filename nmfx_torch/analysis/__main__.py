"""Command line: ``python -m nmfx_torch.analysis [paths] [options]``
(counterpart of ``python -m nmfx.analysis``).

Exit code 0 when no unsuppressed, unbaselined ERROR findings remain;
1 otherwise; 2 on usage errors. ``--json`` emits one machine-readable
document (findings + summary) on stdout for CI consumption.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nmfx_torch.analysis",
        description="the port's contract linter (nmfx-lint's rules "
                    "on nmfx_torch)")
    ap.add_argument("paths", nargs="*", default=["nmfx_torch"],
                    help="files/directories to lint (default: "
                         "nmfx_torch)")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="JSON baseline of tolerated findings "
                         "(shipped policy: empty)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--rules", metavar="IDS", default=None,
                    help="comma-separated rule ids to run (default all)")
    ap.add_argument("--write-baseline", metavar="FILE", default=None,
                    help="write the current unsuppressed findings as a "
                         "baseline file and exit 0")
    ap.add_argument("--update-baseline", metavar="FILE", nargs="?",
                    const="lint_baseline.json", default=None,
                    help="regenerate a baseline file IN PLACE from the "
                         "current findings, preserving each surviving "
                         "record's required 'reason' field (default "
                         "target: lint_baseline.json); exits 0")
    args = ap.parse_args(argv)

    import os

    from nmfx_torch.analysis import active, run

    rule_ids = (None if args.rules is None
                else tuple(s.strip() for s in args.rules.split(",")
                           if s.strip()))
    baseline_path = args.baseline
    if (baseline_path is None and args.update_baseline is not None
            and os.path.exists(args.update_baseline)):
        # refreshing in place: the current file's records must be
        # treated as tolerated (and re-recorded), not re-reported
        baseline_path = args.update_baseline
    try:
        findings = run(args.paths, baseline=baseline_path,
                       rule_ids=rule_ids)
    except FileNotFoundError as e:
        print(f"nmfx-lint: {e}", file=sys.stderr)
        return 2

    errors = active(findings, "error")
    warnings = active(findings, "warning")

    if args.update_baseline:
        target = args.update_baseline
        old: "list[dict]" = []
        if os.path.exists(target):
            with open(target) as fh:
                old = json.load(fh)
        # reasons survive regeneration: exact (file, rule, line) match
        # first, then (file, rule) so a finding that merely moved keeps
        # its recorded justification instead of silently losing it
        exact: "dict[tuple, str]" = {}
        loose: "dict[tuple, str]" = {}
        for r in old:
            reason = str(r.get("reason") or "")
            if not reason:
                continue
            fkey = (os.path.abspath(str(r.get("file"))), r.get("rule"))
            exact[fkey + (r.get("line"),)] = reason
            loose.setdefault(fkey, reason)
        records = []
        for f in findings:
            if f.suppressed:
                continue
            fkey = (os.path.abspath(f.file), f.rule_id)
            records.append({"file": f.file, "rule": f.rule_id,
                            "line": f.line,
                            "reason": exact.get(fkey + (f.line,),
                                                loose.get(fkey, ""))})
        records.sort(key=lambda r: (r["file"], r["line"], r["rule"]))
        with open(target, "w") as fh:
            json.dump(records, fh, indent=2)
            fh.write("\n")
        missing = sum(1 for r in records if not r["reason"])
        msg = (f"nmfx-lint: rewrote {target} with {len(records)} "
               "baseline record(s)")
        if missing:
            msg += (f"; {missing} lack a 'reason' — every tolerated "
                    "finding needs one before review")
        print(msg)
        return 0

    if args.write_baseline:
        # include findings the CURRENT --baseline already tolerates —
        # refreshing a baseline in place must re-record them, not
        # truncate the file to [] because they were annotated away
        records = [{"file": f.file, "rule": f.rule_id, "line": f.line}
                   for f in findings if not f.suppressed]
        with open(args.write_baseline, "w") as fh:
            json.dump(records, fh, indent=2)
            fh.write("\n")
        print(f"nmfx-lint: wrote {len(records)} baseline records to "
              f"{args.write_baseline}")
        return 0

    if args.as_json:
        doc = {
            "findings": [f.to_json() for f in findings],
            "summary": {
                "errors": len(errors),
                "warnings": len(warnings),
                "suppressed": sum(f.suppressed for f in findings),
                "baselined": sum(f.baselined for f in findings),
            },
            "ok": not errors,
        }
        print(json.dumps(doc, indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"nmfx-lint: {len(errors)} error(s), {len(warnings)} "
              f"warning(s), {sum(f.suppressed for f in findings)} "
              f"suppressed, {sum(f.baselined for f in findings)} "
              "baselined")
    return 0 if not errors else 1


if __name__ == "__main__":
    raise SystemExit(main())
