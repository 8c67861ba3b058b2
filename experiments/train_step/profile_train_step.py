#!/usr/bin/env python3
"""Where a training step of SmolLM-135M at full width spends its time on
one GPU.

    python3 experiments/train_step/profile_train_step.py [--steps N] \
        [--json PATH]

The trainer of ``chip_smoke.py`` phase 4j (30 layers, d_model 576, 9 / 3
heads, d_ff 1536, vocab 49152, tied; bfloat16 with float32 masters, no
remat, TF32 off; AdamW, 2 microbatches of 8 x 512; weights from a
generator seeded 0). After 3 warm-up steps:

- ``N`` steps timed by CUDA events (percentiles 10 / 50 / 90);
- ``N`` steps under ``torch.profiler`` (CPU and CUDA): the device's busy
  time a step (the union of its kernels' and copies' intervals), the
  launches a step, the idle share against the event-timed step, the
  device time by kernel class (GEMM, elementwise, reduction, softmax,
  indexing, copies, other) and the 15 kernels with the most device time;
- parts timed alone by CUDA events (median of 5 after a warm-up), each at
  the step's shapes: the float32 head with the loss, forward and backward,
  at one microbatch; one layer's forward and backward at one microbatch;
  the embedding's; the AdamW update of every parameter.

``--json PATH`` also writes every number to PATH; every line gives the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.optim.tree import leaves_of, like  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

BATCH, SEQ, MICRO = 16, 512, 2
CLASSES = (("GEMM", ("gemm", "sm90_", "cutlass", "xmma", "cublas")),
           ("softmax", ("softmax",)),
           ("reduction", ("reduce", "logsumexp")),
           ("indexing", ("index", "scatter", "gather", "embedding")),
           ("elementwise", ("elementwise", "vectorized", "unrolled")),
           ("copy", ("memcpy", "memset", "copy")))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def events_ms(fn, reps: int = 5) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return out


def kind(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def profile(trainer, steps: int) -> dict:
    """Device busy time, launches and time by kernel class of ``steps``
    steps under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.run(trainer.step + steps, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_class, by_name = [], {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.time_range
        spans.append((t.start, t.end))
        us = t.end - t.start
        by_class[kind(e.name)] = by_class.get(kind(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    spans.sort()
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "busy_ms_per_step": busy / 1e3 / steps,
            "launches_per_step": len(spans) / steps,
            "ms_per_step_by_class": {k: v / 1e3 / steps
                                     for k, v in sorted(by_class.items())},
            "top": [{"name": n[:120], "ms_per_step": v / 1e3 / steps}
                    for n, v in top]}


class Head(nn.Module):
    """The model's float32 head alone, as `api.loss_fn` sees a model:
    (logits of the hidden states in ``batch["h"]``, aux 0)."""

    def __init__(self, embed):
        super().__init__()
        self.embed = embed

    def forward(self, batch):
        return (layers.lm_head(self.embed, batch["h"]),
                torch.zeros((), device=batch["h"].device))


def parts(trainer, cfg) -> dict:
    """Each part of a step alone, by CUDA events."""
    model, dev = trainer.model, trainer.device
    mb = BATCH // MICRO
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((mb, SEQ, cfg.d_model), generator=g, device=dev,
                    dtype=cfg.param_dtype, requires_grad=True)
    tgt = torch.randint(0, cfg.vocab, (mb, SEQ), generator=g, device=dev)
    head = Head(model.embed)

    def head_step():
        loss, _ = api.loss_fn(head, cfg, {"h": h, "targets": tgt})
        torch.autograd.grad(loss, [h, model.embed.tok])

    rot = model._prompt_rope(SEQ)
    layer = model.layers[0]
    gout = torch.randn_like(h)

    def layer_step():
        out, _, _ = layer(h, rot)
        torch.autograd.grad(out, [h, *layer.parameters()], gout)

    toks = torch.randint(0, cfg.vocab, (mb, SEQ), generator=g, device=dev)

    def embed_step():
        out = model.embed(toks)
        torch.autograd.grad(out, [model.embed.tok], gout)

    grads = like(trainer.leaves, [torch.zeros_like(p, dtype=torch.float32)
                                  for p in leaves_of(trainer.leaves)])
    state = trainer.opt_state

    def opt_step():
        trainer.opt.update(grads, state, trainer.leaves)

    out = {}
    for name, fn, per_step in (
            ("head_and_loss", head_step, MICRO),
            ("layer", layer_step, MICRO * cfg.n_layers),
            ("embedding", embed_step, MICRO),
            ("adamw", opt_step, 1)):
        runs = events_ms(fn)
        out[name] = {"ms": statistics.median(runs), "runs": runs,
                     "per_step": per_step,
                     "ms_per_step": statistics.median(runs) * per_step}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: torch sees no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    cfg = configs.get("smollm-135m").with_(remat=False)
    pipe = SyntheticTokens(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                          global_batch=BATCH, seed=0))
    trainer = Trainer(cfg, TrainConfig(optimizer="adamw", lr=3e-4,
                                       microbatches=MICRO), pipe,
                      device="cuda",
                      generator=torch.Generator().manual_seed(0))
    trainer.run(3, log_every=0)
    ms = []
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        trainer.run(trainer.step + 1, log_every=0)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    q = statistics.quantiles(ms, n=10) if len(ms) > 1 else [ms[0]] * 9
    step = {"runs": ms, "p10": q[0], "p50": statistics.median(ms),
            "p90": q[-1]}
    print(f"step (events, {args.steps} steps): p10 {step['p10']:.2f} / p50 "
          f"{step['p50']:.2f} / p90 {step['p90']:.2f} ms | {name}",
          flush=True)
    prof = profile(trainer, args.steps)
    idle = 1.0 - prof["busy_ms_per_step"] / step["p50"]
    print(f"profiled: device busy {prof['busy_ms_per_step']:.2f} ms a step "
          f"({idle:.1%} idle against the event-timed p50), "
          f"{prof['launches_per_step']:.0f} kernels and copies a step; wall "
          f"under the profiler {prof['wall_ms_per_step']:.2f} ms | {name}",
          flush=True)
    for k, v in prof["ms_per_step_by_class"].items():
        print(f"  {k:12s} {v:8.2f} ms a step", flush=True)
    for t in prof["top"]:
        print(f"  {t['ms_per_step']:8.2f} ms  {t['name']}", flush=True)
    part = parts(trainer, cfg)
    for k, v in part.items():
        print(f"part {k:14s} {v['ms']:8.3f} ms x {v['per_step']} = "
              f"{v['ms_per_step']:.2f} ms a step | {name}", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"card": name, "step": step, "profile": prof,
             "idle_share": idle, "parts": part}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
