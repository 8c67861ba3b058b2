#!/usr/bin/env python3
"""Times a data-parallel training step of SmolLM-135M at full width on one
or more GPUs, against the one-rank `Trainer` on the same global batch.

    python3 experiments/data_parallel/time_dp_step.py [--ranks 4] \\
        [--backend nccl|gloo] [--steps 6] [--json PATH]

The model and batch of `chip_smoke.py`'s phase 4j (SmolLM-135M in bf16
with f32 masters, remat off, AdamW lr 3e-4, `SyntheticTokens` 16 x 512,
seed 0). ``--ranks`` ranks (`repro_torch.launch.mesh.spawn`; rank r on
card r modulo the cards) train ``--steps`` steps of `DataParallelTrainer`
over a ``"data"`` mesh, 16 / ranks rows each in one microbatch; every
step runs between CUDA events, with events around its all-reduces. Then
a one-rank `Trainer` on card 0 takes the same steps on the concatenated
shard batches in ``--ranks`` microbatches, and every step's loss must
agree within `LOSS_RTOL`. The backend defaults to NCCL where there is a
card a rank, else gloo (which stages through the host). Prints step
p10 / 50 / 90 (steps 1 on), the all-reduces' share, peak memory, and the
cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.train.data_parallel import DataParallelTrainer  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

SEED, BATCH, SEQ, LR = 0, 16, 512, 3e-4
# bf16 weights: another sum order of the f32 gradients can flip a
# weight's bf16 rounding (2^-8 of it), which moves a loss far less
LOSS_RTOL = 1e-3


def cards() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line)


def _cfg():
    return configs.get("smollm-135m").with_(remat=False)


def _pipe(cfg):
    return SyntheticTokens(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                          global_batch=BATCH, seed=SEED))


def _events():
    return [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def rank_body(mesh, steps: int) -> dict:
    """One rank: `steps` steps between CUDA events, the all-reduces' own
    events summed a step."""
    cfg = _cfg()
    t = DataParallelTrainer(cfg, TrainConfig(optimizer="adamw", lr=LR),
                            _pipe(cfg), mesh,
                            generator=torch.Generator().manual_seed(SEED),
                            device="cuda")
    reduce, pending = t._all_reduce, []

    def timed(flat):
        ev = _events()
        ev[0].record()
        reduce(flat)
        ev[1].record()
        pending.append(ev)
    t._all_reduce = timed
    torch.cuda.reset_peak_memory_stats()
    step_ms, ar_ms = [], []
    for step in range(steps):
        pending.clear()
        ev = _events()
        ev[0].record()
        t.run(step + 1, log_every=0)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
        ar_ms.append(sum(a.elapsed_time(b) for a, b in pending))
    return {"rank": t.rank, "history": t.history, "step_ms": step_ms,
            "all_reduce_ms": ar_ms,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo (default: nccl with a card a rank)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_dp_step: torch sees no CUDA card")
    n_cards = torch.cuda.device_count()
    backend = args.backend or ("nccl" if n_cards >= args.ranks else "gloo")
    print(f"[dp] {args.ranks} ranks over {backend} on {n_cards} card(s) | "
          f"{cards()}", flush=True)
    t0 = time.perf_counter()
    ranks = spawn(args.ranks, rank_body, args.steps, backend=backend,
                  device_type="cuda", axes=("data",), timeout_s=900.0)
    ranks_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg()
    pipe = _pipe(cfg)
    ref = Trainer(cfg, TrainConfig(optimizer="adamw", lr=LR,
                                   microbatches=args.ranks), pipe,
                  device="cuda", generator=torch.Generator().manual_seed(SEED))
    want = []
    for step in range(args.steps):
        parts = [pipe.batch(step, shard=j, num_shards=args.ranks)
                 for j in range(args.ranks)]
        want.append(float(ref.train_step(
            {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        )["loss"]))
    got = ranks[0]["history"]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    assert all(r["history"] == got for r in ranks), "ranks disagree"
    ms = np.asarray([r["step_ms"][1:] for r in ranks])
    ar = np.asarray([r["all_reduce_ms"][1:] for r in ranks])
    q = np.percentile(ms[0], [10, 50, 90])
    share = float(ar[0].sum() / ms[0].sum())
    print(f"[dp] step (CUDA events, rank 0, steps 1-{args.steps - 1}) p10 "
          f"{q[0]:.1f} / p50 {q[1]:.1f} / p90 {q[2]:.1f} ms; the all-reduces "
          f"{ar[0].mean():.1f} ms a step ({share:.1%}); every rank's p50 "
          f"{[round(float(np.median(m)), 1) for m in ms]} ms; peak "
          f"{max(r['peak_bytes'] for r in ranks) / 2**30:.2f} GiB a rank; "
          f"{BATCH * SEQ / (q[1] / 1e3):,.0f} tokens/s | {cards()}",
          flush=True)
    print(f"[dp] losses {[round(v, 4) for v in got]}; against the one-rank "
          f"Trainer on the concatenated shards max rel diff {rel:.2e} "
          f"(limit {LOSS_RTOL:g}); {ranks_s:.1f} s for the ranks", flush=True)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "ranks": ranks, "backend": backend, "want": want, "rel": rel,
            "p10_50_90_ms": q.tolist(), "all_reduce_share": share,
            "cards": cards()}, indent=1))
    assert rel <= LOSS_RTOL, (got, want)
    return 0


if __name__ == "__main__":
    sys.exit(main())
