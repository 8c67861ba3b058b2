"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card. It puts
``src`` on its path, refuses to run without a CUDA card (or with fewer
than the cell asks for), sets up, measures for ``--seconds``, compares
what the window produced with the plain reference, and prints one JSON
object as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (end to end with ``--trace 0``, per layer with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number beside its limit, which are also the last
lines of standard error. Earlier lines give the set-up's split, the port's
choice of format and the card's clocks and power. A run that finds JAX,
the JAX package or the old ``benchmarks`` loaded prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    """The card's name, power limit and draw, clocks and temperature."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return f"{q}: {out.stdout.strip()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.pop("REPRO_TRACE", None)     # spans only where asked for

    import torch

    from perfbench import harness, imports, manifest, timeline

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    bad = imports.reference_imports()
    if bad:
        print(f"perfbench: the references import {bad}", file=sys.stderr)
        return 3

    card = []
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", bench=bench,
                           t_start=T_START,
                           after_window=lambda: card.append(_card()))
    run = out["run"]
    print(f"perfbench: card after the window: {card[0]}")
    lat = run.get("latencies_s")
    print(f"perfbench: window {run['window_s']:.3f} s, attempted "
          f"{out['attempted']}"
          + (f", mean call {1e3 * sum(lat) / len(lat):.4f} ms" if lat else "")
          + f"; reference and comparison {run['compare_s']:.3f} s")
    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace:
        tl = run["timeline"]
        ws, we = timeline.window(tl)
        device["busy_s"] = timeline.covered(timeline.busy(tl), [(ws, we)]) / 1e6
        device["window_s"] = (we - ws) / 1e6
        line["breakdown"] = {"device_ops": timeline.device_ops(tl),
                             "idle_gaps": timeline.idle_gaps(tl)}
    line["checks"] = out["checks"]
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
