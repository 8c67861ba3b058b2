"""One run of one cell: set-up, the measured window, the comparison, the
readers, and the result's line.

`run_cell` does the work on any device, so the tests drive it on the CPU
at small sizes; `perfbench.run` is the command, which refuses to run
without the card. The order of a run:

1. inputs from the seed (`cases`), and the harness's own buffers
   (`loops`), whose bytes are read before the port's object exists;
2. the port's object through its public entry (``setup.build_s``), then
   every shape of the window once; ``setup_s`` ends here;
3. the window, ``seconds`` long (with ``trace``, its last `TRACED_S`
   under the profiler and all of it with the port's spans written to a
   file under ``TMPDIR``);
4. device memory read, the port's object freed, then the reference and the
   comparison;
5. the readers of the cell's metrics (end to end without ``trace``, per
   layer with it).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import tempfile
import time

import torch

from perfbench import manifest, timeline

MIB = 1 << 20
#: Seconds at the window's end that a traced run profiles: the trace of a
#: whole window holds millions of device operations, too many to read.
TRACED_S = 2.0


def _counters() -> dict:
    from repro_torch import obs
    snap = obs.default_registry().snapshot()
    return {k: v for k, v in snap.get("counters", {}).items()}


def _spans(path: str, t0: float, t1: float) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "span" and t0 <= rec["ts"] <= t1:
                out.append(rec)
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", bench: dict | None = None,
             config: dict | None = None, traffic: dict | None = None,
             subject: str = "program", t_start: float | None = None,
             log=print, after_window=None) -> dict:
    """Runs the cell once and returns the result (`result_line`'s fields
    and the run's record). ``config`` / ``traffic`` replace the files'
    (the tests' small sizes); ``subject="control"`` puts the plain
    reference in the next lower precision in the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest.load() if bench is None else bench
    cell = manifest.cell(bench, cell_name)
    cfg = config or manifest.config(bench, cell["config"])
    params = traffic or manifest.traffic(cell["traffic"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    split = {}

    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
    split["cuda_init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    case = manifest.case_module(cfg["case"]).make(cfg, seed, dev)
    mark = (torch.profiler.record_function if trace
            else lambda name: contextlib.nullcontext())
    mix = manifest.loop_module(params["loop"]).make(params, case, seed, dev,
                                                    mark)
    mix.prepare()
    if cuda:
        torch.cuda.synchronize(dev)
        base_bytes = torch.cuda.memory_allocated(dev)
    split["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    subj = case.program() if subject == "program" else case.control()
    build_s = split["build_s"] = time.perf_counter() - t
    held = {}
    if cuda:
        held["built"] = torch.cuda.memory_allocated(dev) - base_bytes

    t = time.perf_counter()
    mix.warmup(subj)
    if cuda:
        torch.cuda.synchronize(dev)
        held["warm"] = torch.cuda.memory_allocated(dev) - base_bytes
    split["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"perfbench: {cell_name} seed {seed} on {_device_name(dev)}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f", setup_s {setup_s:.3f}")
    if held:
        log("perfbench: MiB allocated beyond the harness's own: after the "
            f"build {held['built'] / MIB:.3f}, after the warm-up "
            f"{held['warm'] / MIB:.3f}")
    for k, v in subj.info.items():
        log(f"perfbench: {k}: {v}")

    span_file = None
    if trace and subject == "program":
        from repro_torch import obs
        fd, span_file = tempfile.mkstemp(prefix="perfbench-spans-",
                                         suffix=".jsonl")
        os.close(fd)
        obs.configure_trace(span_file)
    gc.collect()
    gc.freeze()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    wall0 = time.time()
    prof = None
    if trace:
        rec = mix.run(subj, seconds - TRACED_S) if seconds > TRACED_S else None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        with prof, torch.profiler.record_function("perfbench.window"):
            traced = mix.run(subj, min(seconds, TRACED_S))
        rec = mix.merge(rec, traced) if rec else traced
    else:
        rec = mix.run(subj, seconds)
    wall1 = time.time()
    gc.unfreeze()
    if after_window is not None:
        after_window()

    run = dict(rec, setup_s=setup_s, build_s=build_s, setup_split=split,
               dtype=str(case.dtype).replace("torch.", ""),
               rows=case.d_out, cols=case.d_in)
    if cuda:
        window_peak = torch.cuda.max_memory_allocated(dev)
        run["device_mib"] = (window_peak - base_bytes) / MIB
        run["memory_peak_bytes"] = max(setup_peak, window_peak)
    if subject == "program":
        run["counters"] = _counters()
    if span_file is not None:
        from repro_torch import obs
        obs.configure_trace(None)
        run["spans"] = _spans(span_file, wall0, wall1)
        os.unlink(span_file)
    if prof is not None:
        run["timeline"] = timeline.collect(prof)
        del prof

    produced = mix.produced()
    del subj
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = case.compare(produced)
    run["compare_s"] = time.perf_counter() - t
    run["nnz"] = case.nnz
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    wanted = (manifest.per_layer(bench, cell_name) if trace
              else manifest.end_to_end(bench, cell_name))
    for m in wanted:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"correct": correct, "attempted": rec["attempted"], "failed": 0,
            "metrics": metrics, "checks": checks, "run": run}


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
