#!/usr/bin/env python3
"""Times one pooled decode step of SmolLM-135M at full width on one GPU.

    python3 experiments/engine_step/time_decode_step.py [--src DIR]

The model of ``chip_smoke.py`` phase 4g (30 layers, d_model 576, 9 / 3
heads, d_ff 1536, vocab 49152, float32 with TF32 off, weights from a
generator seeded 0), built by the package under ``DIR/src`` (default:
this checkout), gets 4 requests (prompts of 1, 3, 7 and 12 tokens)
admitted into the 4 slots of its ``Engine`` (max_seq 64). One pooled
``decode_hidden`` step at those positions is then

- timed `REPS` times by CUDA events around it and by the host clock, each
  step ending in a copy of its hidden states to the host, as an engine
  step ends in the copy of its logits (percentiles 10 / 50 / 90, after 2
  steps of warm-up);
- timed on the device alone: the median of 5 replays of a CUDA graph of
  20 steps, in ms a step;
- counted: the nodes of a CUDA graph of one step, by type (the driver's
  ``cuGraphGetNodes`` and ``cuGraphNodeGetType``), the launches an eager
  step makes.

Two checkouts can be compared in one call: run parent, change, change,
parent. Every line gives the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
PROMPTS = (1, 3, 7, 12)
SLOTS, MAX_SEQ, REPS = 4, 64, 50


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _warm(torch, fn) -> None:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)


def graph_ms(torch, fn, calls: int = 20, runs: int = 5) -> float:
    _warm(torch, fn)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / calls)
    return statistics.median(out)


def graph_nodes(torch, fn) -> dict:
    _warm(torch, fn)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = {"total": n.value}
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(t)) == 0
        kind = {0: "kernel", 1: "memcpy", 2: "memset"}.get(t.value, "other")
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="checkout whose src/ builds the model")
    args = ap.parse_args()
    src = args.src.resolve() / "src"
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch import configs, obs
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("smollm-135m").with_(dtype="float32")
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cuda")
    eng = Engine(model, slots=SLOTS, max_seq=MAX_SEQ,
                 metrics=obs.MetricsRegistry(), device="cuda")
    rng = np.random.default_rng(0)
    for n in PROMPTS:
        eng.submit(rng.integers(0, cfg.vocab, size=n), 8)
    smi = card()
    with torch.inference_mode():
        eng._fill_slots()
        toks = torch.as_tensor([[int(r.prompt[-1])] for r in eng.active],
                               device="cuda")
        pos = torch.as_tensor(eng.pos, device="cuda")

        def step():
            return model.decode_hidden(eng.cache, toks, pos)[0]
        events, wall = [], []
        for rep in range(REPS + 2):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            hidden = step()
            e1.record()
            hidden.cpu()
            if rep >= 2:
                wall.append((time.perf_counter() - t0) * 1e3)
                events.append(e0.elapsed_time(e1))
        graph = graph_ms(torch, step)
        nodes = graph_nodes(torch, step)

    def pct(ms):
        q = np.percentile(ms, [10, 50, 90])
        return [float(v) for v in q]
    out = {"src": str(src), "events_ms": pct(events), "wall_ms": pct(wall),
           "graph_ms": graph, "nodes": nodes,
           "idle": 1 - graph / pct(events)[1]}
    print(f"[decode step {src}] events p10/p50/p90 "
          f"{'/'.join(f'{v:.4f}' for v in out['events_ms'])} ms, wall "
          f"{'/'.join(f'{v:.4f}' for v in out['wall_ms'])} ms, graph "
          f"{graph:.4f} ms, idle {out['idle']:.1%}, nodes {nodes} | {smi}",
          flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
