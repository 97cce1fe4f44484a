"""The control of each cell's comparison: the plain reference put in
the program's place, computed one precision below what the
configuration states, must come out not correct.

The configuration states its precision and names the control's
(`control_precision`): the TPC-H configuration states exact DECIMAL
answers, and Q1's sums of charges pass 2^53, so its control sums in
float64. Each answer is judged as a run judges the program's: equal to
the exact reference's text, or wrong.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--answers N]

prints one JSON line per seed: the cell, the seed, the answers judged
and the wrong ones. It needs no card and loads nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import catalog  # noqa: E402


def judge(cell_name: str, seed: int, answers: int) -> dict:
    """-> {"judged": n, "wrong": n} for the control on `seed`: `answers`
    answers, rotating through the mix as a client does."""
    cell = catalog.Cell(cell_name)
    data = cell.dataset.generate(cell.config, seed)
    names = cell.traffic["analytic"]["statements"]
    prec = cell.config["control_precision"]
    differs = {}
    for n in names:
        ref = cell.reference(n)
        differs[n] = ref.answer(data, prec) != ref.answer(data)
    wrong = sum(differs[names[i % len(names)]] for i in range(answers))
    return {"judged": answers, "wrong": wrong}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--answers", type=int, default=300)
    args = p.parse_args(argv)
    for seed in args.seeds:
        out = judge(args.workload, seed, args.answers)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
