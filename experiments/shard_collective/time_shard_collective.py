#!/usr/bin/env python3
"""Times the row-sharded head's collective pass on one or more GPUs.

    python3 experiments/shard_collective/time_shard_collective.py \\
        [--ranks 4] [--backend nccl|gloo ...] [--reps 20] [--json PATH]

The head of ``chip_smoke.py`` phase 4 (SmolLM-135M's tied LM head, W^T
49152 x 576 f32, weights drawn from seed 0 at std 0.02, pruned to 0.8,
8-bit codebook, lane width 128) is cut into ``--ranks`` row shards, each
encoded on the host (`FormatSpec.shard` of the registry's ``dtans``). The
per-shard loop on card 0 gives the reference rows. Then, for each ``--backend``, ``--ranks`` ranks are
spawned (`repro_torch.launch.mesh.spawn`; rank r on card r modulo the
cards), each uploads only its own shard and runs the rank body
`tests/torch_shard_ranks.py::rank_spmm`:
x broadcast from rank 0, its rows into a zero (49152, B) result, an
all-reduce. Every rank's result must be bitwise the loop's, at B = 1 and
64; the wall time of ``--reps`` passes a rank (a barrier, the pass, a
synchronize) is printed as percentiles 10 / 50 / 90 beside the loop's
CUDA-graph time. NCCL needs a card a rank; gloo stages through the host
and runs any number of ranks on one card. Every line gives the cards'
names and power limits.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.append(str(ROOT / "tests"))  # torch_shard_ranks (the rank body)

import torch  # noqa: E402

from repro_torch.kernels import shard_ops  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.sparse.prune import codebook_quantize, magnitude_prune  # noqa: E402
from repro_torch.sparse.registry import get_format  # noqa: E402

from torch_shard_ranks import rank_spmm  # noqa: E402

D_MODEL, VOCAB, SEED = 576, 49152, 0
BATCHES = (1, 64)


def cards() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line)


def graph_ms(fn, calls: int = 20, runs: int = 5) -> float:
    """Median ms a call over ``runs`` replays of a CUDA graph of ``calls``
    calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    out = []
    for _ in range(runs):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / calls)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", action="append", default=None,
                    help="nccl or gloo; repeat for both (default: nccl)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    backends = args.backend or ["nccl"]
    # the ranks of one host meet over the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if not torch.cuda.is_available():
        raise SystemExit("time_shard_collective: torch sees no CUDA card")
    where = cards()
    print(f"[cards] {torch.cuda.device_count()}: {where}", flush=True)

    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    t0 = time.perf_counter()
    pruned = codebook_quantize(magnitude_prune(w.T, 0.8), bits=8)
    plan = get_format("dtans").shard(pruned, args.ranks, lane_width=128,
                                     shared_table=True)
    print(f"[plan] {args.ranks} shards of {plan.shard_rows} rows, "
          f"{plan.shard_nbytes} B; encodes {time.perf_counter() - t0:.1f} s",
          flush=True)
    xrng = np.random.default_rng(SEED + 9)
    xs = {B: xrng.standard_normal((D_MODEL, B)).astype(np.float32)
          for B in BATCHES}
    out = {"cards": where, "ranks": args.ranks, "loop": {}, "collective": {}}
    wants = {}
    for B, x in xs.items():
        X = torch.as_tensor(x, device="cuda")
        wants[B] = shard_ops.shard_spmm(plan, X, device="cuda").cpu().numpy()
        out["loop"][B] = graph_ms(
            lambda: shard_ops.shard_spmm(plan, X, device="cuda"))
        print(f"[loop] B={B:3d} {args.ranks} launches on card 0: "
              f"{out['loop'][B]:.4f} ms (graph) | {where}", flush=True)
    jobs = [(shard_ops.host_plan(plan), xs[B]) for B in BATCHES]
    for backend in backends:
        t0 = time.perf_counter()
        ranks = spawn(args.ranks, rank_spmm, jobs, "cuda",
                      args.reps, backend=backend, device_type="cuda",
                      timeout_s=300.0)
        spawn_s = time.perf_counter() - t0
        res = {}
        for i, B in enumerate(BATCHES):
            for r, rank in enumerate(ranks):
                job = rank[i]
                assert np.array_equal(job["y"], wants[B]), (backend, B, r)
                assert job["uploaded"] == [j == r
                                           for j in range(args.ranks)]
            ms = ranks[0][i]["ms"]
            q = np.percentile(ms, [10, 50, 90])
            res[B] = {"p10": float(q[0]), "p50": float(q[1]),
                      "p90": float(q[2]),
                      "rank_p50": [r[i]["ms_p50"] for r in ranks]}
            print(f"[{backend}] B={B:3d} {args.ranks} ranks, bitwise the "
                  f"loop on every rank, each its own shard: wall "
                  f"{q[1]:.3f} ms p50 [{q[0]:.3f}, {q[2]:.3f}] on rank 0 "
                  f"({args.reps} passes); loop {out['loop'][B]:.4f} ms | "
                  f"{where}", flush=True)
        out["collective"][backend] = {"spawn_s": spawn_s, **res}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
