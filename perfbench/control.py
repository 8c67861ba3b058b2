"""Readings of a cell's compared numbers over many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--seconds 2] [--subject control|program]

With ``--subject control`` (the default) the plain reference in the next
lower precision takes the program's place (`cases`): every seed must
come out not correct, and the smallest reading of each number is the
upper end its limit is set below. With ``--subject program`` the port
runs, as in a benchmark run: the largest reading over a dozen seeds or more
is the lower end. Each seed runs a short window at the cell's own load and
size and prints one JSON line: the seed, ``correct`` and ``checks``. The
benchmark's own runs never run this. Needs the card, as `run` does.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--subject", choices=("control", "program"),
                    default="control")
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.pop("REPRO_TRACE", None)

    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        print("perfbench: the control runs on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               device="cuda", subject=args.subject)
        print(json.dumps({"seed": seed, "subject": args.subject,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
