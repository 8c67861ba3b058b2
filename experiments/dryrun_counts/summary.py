#!/usr/bin/env python3
"""The port's dry-run records as a table of collectives counted against
reckoned, one row a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python3 experiments/dryrun_counts/summary.py [DIR]

``DIR`` (default ``experiments/dryrun_torch``) holds one JSON a cell, as
`repro_torch.launch.dryrun` writes them. Each ``ok`` cell gives a row: its
collectives a step as counted on the fake process group beside the
reckoning from the specs, by kind (ag all-gather, ar all-reduce, rs
reduce-scatter, a2a all-to-all, cp collective-permute, bc broadcast).
A cell whose sharded step failed shows ``reckoned`` and the start of its
failure. The last line counts the cells and those that kept the
reckoning.
"""

from __future__ import annotations

import glob
import json
import os
import sys

SHORT = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
         "all-to-all": "a2a", "collective-permute": "cp", "broadcast": "bc"}


def counts(by_kind: dict) -> str:
    return ", ".join(f"{SHORT[k]} {v}" for k, v in by_kind.items() if v) \
        or "none"


def rows(out_dir: str) -> list:
    """Markdown rows of the records in ``out_dir``, then the count line."""
    lines = ["| cell | kind | counted | reckoned |",
             "| --- | --- | --- | --- |"]
    fell = 0
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            continue
        coll = rec["collectives"]
        if coll["reckoned"]:
            fell += 1
            counted = f"reckoned ({rec.get('sharded_error', '')[:60]})"
        else:
            counted = counts(coll["counts"])
        reck = counts(coll.get("reckoning", coll)["counts"])
        lines.append(f"| {rec['arch']} {rec['shape']} {rec['mesh']} | "
                     f"{rec['kind']} | {counted} | {reck} |")
    lines.append(f"{len(lines) - 2} cells, {fell} kept the reckoning")
    return lines


def main() -> int:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"
    print("\n".join(rows(out_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
