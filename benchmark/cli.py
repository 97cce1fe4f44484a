"""The command line of benchmark/run.py."""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from benchmark import catalog, harness


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True, help="a cell's name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    cell = catalog.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line = harness.Run(args.workload, args.seed, args.seconds,
                           bool(args.trace)).execute()
    except Exception:  # noqa: BLE001 - a failed run prints no result
        traceback.print_exc()
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run's process loaded {bad}", file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
