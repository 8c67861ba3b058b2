#!/usr/bin/env python3
"""Fits the `H100` cost model (`repro_torch.autotune.cost_model.CardModel`)
on one card, and holds it against passes it was not fitted on.

    python3 experiments/autotune_calibration/fit_h100.py \
        [--json experiments/autotune_calibration/points.json] [--jobs 7]
    python3 experiments/autotune_calibration/fit_h100.py --points FILE

1. The fit: `measure.card_calibration_suite` (1.6M to 5.7M nonzeros:
   banded, stencil, Erdos-Renyi, power-law rows and SmolLM-135M's tied
   head, f32; and the small suite, 600 to 9,830 nonzeros, whose passes
   show the fixed costs a launch), each in `measure.CALIBRATION_CONFIGS` at
   `measure.HEAD_BATCHES` (1, 4, 64), timed by `measure.time_kernel` (a
   CUDA graph of 20 calls between CUDA events, median of 3) and fitted by
   `measure.calibrate(base=H100)`. The dtANS encodes (pure Python, ~10 us
   a nonzero) run first, in ``--jobs`` processes.
2. Held out, priced under the fitted model: every entropy-coded
   configuration `choose_dtans_config` weighs on the head (but BCSR-dtANS
   2x2, whose fill is 2.95x) at B = 1, 4, 64, and the choice of
   `choose_dtans_config(budget=0)` at B = 1 and 64 against the fastest of
   them measured (what ``chip_smoke.py`` phase 4e checks); the small suite
   at B = 1 and 8, as phase 4f times it (B=1 is in the fit, B=8 is not).

Every point (matrix, config, B, measured ms, modeled ms, its row of
`cost_model.card_terms`) goes to the JSON, with the fitted constants, the
card's name and power limit. ``--points FILE`` fits again from such a JSON
on any host (no card: the same rows, the same least squares) and prints
the same tables.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.autotune import cost_model, measure  # noqa: E402
from repro_torch.autotune.cache import DecisionCache  # noqa: E402
from repro_torch.autotune.fingerprint import fingerprint  # noqa: E402
from repro_torch.autotune.search import choose_dtans_config  # noqa: E402
from repro_torch.sparse import registry  # noqa: E402

DEFAULT_JSON = ROOT / "experiments" / "autotune_calibration" / "points.json"
FAMILY_BATCHES = (1, 4, 64)
CHOICE_BATCHES = (1, 64)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _encode(job):
    """(matrix name, artifacts) of one configuration's encode."""
    mname, a, cfg = job
    spec, knobs = registry.parse_config(cfg)
    enc: dict = {}
    spec.nbytes_constructed(a, artifacts=enc, **knobs)
    return mname, enc


def family_configs(head) -> list:
    """The head's entropy-coded candidates but BCSR-dtANS 2x2."""
    fp = fingerprint(head)
    out = []
    for fmt in registry.format_names(selectable=True, decodes=True):
        spec = registry.get_format(fmt)
        for kn in spec.knob_grid(fp):
            if fmt != "bcsr_dtans":
                out.append(spec.encode_knobs(kn))
    return out


def encode_all(suite: dict, family: list, jobs: int) -> dict:
    todo = [(m, a, cfg) for m, a in suite.items()
            for cfg in measure.CALIBRATION_CONFIGS
            if registry.parse_config(cfg)[0].decodes]
    todo += [("head", suite["head"], cfg) for cfg in family
             if cfg not in measure.CALIBRATION_CONFIGS]
    # the head's encodes are the longest: start them first
    todo.sort(key=lambda j: -j[1].nnz)
    arts: dict = {m: {} for m in suite}
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
        for mname, enc in ex.map(_encode, todo):
            arts[mname].update(enc)
    return arts


def _point(p, modeled: float) -> dict:
    d = dataclasses.asdict(p)
    for k in ("modeled_after", "modeled_before", "measured"):
        d.pop(k)
    d["measured_ms"] = float(p.measured) * 1e3
    d["modeled_ms"] = modeled * 1e3
    d["terms"] = list(p.terms)
    return d


def priced(model, mats: dict, arts, configs, batches,
           device="cuda") -> list:
    """Passes measured now, priced under ``model`` (`calibrate` with
    ``model`` as its base: its ``modeled_before`` is the price)."""
    res = measure.calibrate(mats, base=model, configs=tuple(configs),
                            batches=tuple(batches), artifacts=arts,
                            device=device)
    return [_point(p, p.modeled_before) for p in res.points]


def choices(model, head) -> dict:
    """`choose_dtans_config(budget=0)` on the head at `CHOICE_BATCHES`."""
    return {str(B): choose_dtans_config(
        head, machine=model, budget=0, batch=B,
        cache=DecisionCache(path=None)).config_name
        for B in CHOICE_BATCHES}


def report(rec: dict) -> None:
    print(f"card: {rec['card']}")
    print("fitted H100:", json.dumps(rec["model"]))
    for part in ("fit", "family", "small"):
        rows = rec[part]
        ratio = [r["modeled_ms"] / r["measured_ms"] for r in rows]
        print(f"[{part}] {len(rows)} points, modeled / measured "
              f"{min(ratio):.3f} .. {max(ratio):.3f}; outside 2x: "
              f"{sum(not 0.5 <= q <= 2.0 for q in ratio)}")
        for r, q in zip(rows, ratio):
            print(f"  {r['matrix']:9s} {r['config_name']:26s} "
                  f"B={r['batch']:<3d} tiles={r['tiles']:<3d} "
                  f"launches={r['launches']:<3d} measured "
                  f"{r['measured_ms']:.5f} ms modeled "
                  f"{r['modeled_ms']:.5f} ms ({q:.3f})")
    fam = {(r["config_name"], r["batch"]): r["measured_ms"]
           for r in rec["family"]}
    for B, cfg in rec["choices"].items():
        times = {c: t for (c, b), t in fam.items() if b == int(B)}
        best = min(times, key=times.get)
        if cfg not in times:
            print(f"[choice] B={B}: budget=0 picks {cfg}, not measured; "
                  f"fastest measured {best} {times[best]:.5f} ms")
            continue
        print(f"[choice] B={B}: budget=0 picks {cfg} "
              f"{times[cfg]:.5f} ms; fastest measured {best} "
              f"{times[best]:.5f} ms ({times[cfg] / times[best] - 1:+.2%})")


def refit(path: Path) -> None:
    """The fit again from a JSON's rows, on any host."""
    rec = json.loads(path.read_text())
    base = cost_model.model_from_dict(rec["base"])
    fit = rec["fit"]
    model = measure.fit_card([r["terms"] for r in fit],
                             [r["measured_ms"] * 1e-3 for r in fit],
                             [r["weight"] for r in fit], base, name="h100")
    rec["model"] = model.to_dict()
    for part in ("fit", "family", "small"):
        for r in rec[part]:
            r["modeled_ms"] = model.seconds(r["terms"]) * 1e3
    report(rec)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=str(DEFAULT_JSON))
    ap.add_argument("--jobs", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", default=None,
                    help="fit again from this JSON (no card)")
    args = ap.parse_args()
    if args.points:
        refit(Path(args.points))
        return
    import torch
    t0 = time.time()
    suite = measure.card_calibration_suite()
    head = suite["head"]
    family = family_configs(head)
    arts = encode_all(suite, family, args.jobs)
    print(f"suite built and encoded in {time.time() - t0:.1f} s "
          f"({', '.join(f'{k} {v.nnz}' for k, v in suite.items())})",
          flush=True)
    base = cost_model.H100
    res = measure.calibrate(suite, base=base, name="h100",
                            batches=measure.HEAD_BATCHES, artifacts=arts,
                            device=args.device)
    model = res.model
    print(f"fit in {time.time() - t0:.1f} s: error {res.err_before:.3f} "
          f"(base) -> {res.err_after:.3f}", flush=True)
    small = {k: v for k, v in suite.items() if k.startswith("small_")}
    rec = {"card": card(), "torch": torch.__version__,
           "base": base.to_dict(), "model": model.to_dict(),
           "signature": model.signature(), "terms": cost_model.CARD_TERMS,
           "err_before": res.err_before, "err_after": res.err_after,
           "matrices": {m: {"shape": list(a.shape), "nnz": int(a.nnz)}
                        for m, a in suite.items()},
           "choices": choices(model, head),
           "fit": [_point(p, p.modeled_after) for p in res.points],
           "family": priced(model, {"head": head}, arts, family,
                            FAMILY_BATCHES, args.device),
           "small": priced(model, small, None, measure.CALIBRATION_CONFIGS,
                           measure.CALIBRATION_BATCHES, args.device)}
    rec["seconds"] = time.time() - t0
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(rec, indent=1))
    report(rec)
    print(f"wrote {args.json} in {rec['seconds']:.1f} s")


if __name__ == "__main__":
    main()
