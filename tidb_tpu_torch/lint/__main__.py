"""CLI front end: ``python -m tidb_tpu_torch.lint``.

Exit-code contract (CI / pre-commit):
    0  every selected rule ran clean
    1  findings (printed one per line: file:line: [rule] message)
    2  usage error (unknown rule, bad flags)

``--json`` swaps the human lines for one machine-readable document
(stable schema, pinned by test_cli_json_smoke, which
tests/test_torch_lint.py replays):

    {"version": 1, "clean": bool, "files": N, "rules": [...],
     "findings": [{"file", "line", "rule", "message"}, ...],
     "timing": {"parse_ms", "total_ms", "parse_calls",
                "rule_ms": {rule: ms}}}

The exit-code contract is identical in both modes.
"""

from __future__ import annotations

import argparse
import json
import sys

from tidb_tpu_torch.lint import REGISTRY, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tidb_tpu_torch.lint",
        description="Project static analysis: every rule over one "
                    "shared parse of the tidb_tpu_torch package.")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--rule", action="append", metavar="NAME",
                        help="run only this rule (repeatable)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="findings only, no timing report")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout "
                             "(same exit codes)")
    args = parser.parse_args(argv)

    if args.list_rules:
        width = max(len(n) for n in REGISTRY)
        for name, cls in REGISTRY.items():
            print(f"{name:<{width}}  {cls.doc()}")
        return 0

    try:
        report = run(rules=args.rule)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps({
            "version": 1,
            "clean": report.clean,
            "files": report.files,
            "rules": report.rules_run,
            "findings": [
                {"file": f.file, "line": f.line, "rule": f.rule,
                 "message": f.message} for f in report.findings],
            "timing": {
                "parse_ms": round(report.parse_time * 1e3, 1),
                "total_ms": round(report.total_time * 1e3, 1),
                "parse_calls": report.parse_calls,
                "rule_ms": {n: round(t * 1e3, 1)
                            for n, t in report.rule_times.items()},
            },
        }, indent=1))
        return 1 if report.findings else 0

    for finding in report.findings:
        print(finding)
    if not args.quiet:
        slowest = sorted(report.rule_times.items(),
                         key=lambda kv: -kv[1])[:3]
        print(f"{len(report.rules_run)} rule(s) over "
              f"{report.files} files: {len(report.findings)} finding(s) "
              f"in {report.total_time * 1e3:.0f} ms "
              f"(parse {report.parse_time * 1e3:.0f} ms; slowest "
              + ", ".join(f"{n} {t * 1e3:.0f} ms" for n, t in slowest)
              + ")")
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
