#!/usr/bin/env python3
"""Times `chip_smoke.py`'s phase 4n, tensor parallelism at full width,
over NCCL with a card a rank, against the one-card model.

    python3 experiments/tensor_parallel/time_tp_step.py [--backend nccl] \\
        [--json PATH]

Needs 3 cards for NCCL (a host with four H100s; rank r on card r). The
model and data of phase 4n: 4g's SmolLM-135M (f32, TF32 off, seed 0, the
tied embedding phase 4's weight) on a (1 data, 3 model) mesh, 4g's 8
prompts prefilled and 16 greedy decode steps through the 3-shard
compressed head; three f32 `TensorParallelTrainer` steps (8 x 512) and
five of 4j's bf16 configuration (16 x 512, 2 microbatches). Phase 4n's
own checks hold (`chip_smoke.phase_tp`): exact parameter bytes, the head
bitwise the one-device loop, logits against the one-device model, the
Megatron count of collectives, the losses against the one-rank
`Trainer`. Beside it, on card 0 alone, the one-card model's decode step
(`decode_hidden` of the same 8-slot pool, by CUDA events over the same
16 steps) and 4j's bf16 train step (`Trainer`, 5 steps). Prints both,
with the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
import torch  # noqa: E402

from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402


def one_card() -> dict:
    """The one-card model on card 0: `decode_hidden` of 4g's 8 prompts as
    one pool over `TP_DECODE_STEPS` greedy steps (`chip_smoke._tp_serve`;
    the dense head picks the tokens), and 4j's bf16 train step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    prng = np.random.default_rng(c.SEED + 7)
    prompts = [prng.integers(0, c.VOCAB, size=n) for n in c.ENGINE_PROMPTS]
    model = c._smollm(c._head_weight())
    with torch.no_grad():
        run = c._tp_serve(model, None, prompts)
    out = {"prefill_ms": run["prefill_ms"], "model_ms": run["model_ms"]}
    del model, run
    torch.cuda.empty_cache()
    cfg = c._train_cfg()
    t = Trainer(cfg, TrainConfig(optimizer="adamw", lr=c.TRAIN_LR,
                                 microbatches=2),
                SyntheticTokens(PipelineConfig(
                    vocab=cfg.vocab, seq_len=c.TRAIN_SEQ,
                    global_batch=c.TRAIN_BATCH, seed=c.SEED)),
                device="cuda", generator=torch.Generator().manual_seed(
                    c.SEED))
    out["train_ms"] = []
    for step in range(c.TP_BF16_STEPS):
        ev = c._events()
        ev[0].record()
        t.train_step(t.batch(step))
        ev[1].record()
        out["train_ms"].append(c._elapsed(ev))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    c.phase_device()
    c.phase_build()
    if args.backend == "nccl" and torch.cuda.device_count() < c.TP_RANKS:
        raise SystemExit(f"NCCL needs {c.TP_RANKS} cards, a rank each; "
                         f"this host has {torch.cuda.device_count()}")
    one = one_card()
    c.phase_tp(backend=args.backend)
    tp = c.RESULTS["tp"]
    one_model = statistics.median(one["model_ms"][2:])
    tp_model = statistics.median(tp["model_ms"][2:])
    one_train = statistics.median(one["train_ms"][1:])
    tp_train = statistics.median(tp["train"]["bf16"]["step_ms"][1:])
    c.log(f"[tp-time] {args.backend}, {c.TP_RANKS} ranks: decode_hidden "
          f"(B=8) p50 {tp_model:.1f} ms against one card's "
          f"{one_model:.1f} ms ({tp_model / one_model:.2f}x); bf16 train "
          f"step (16 x 512, 2 microbatches) p50 {tp_train:.1f} ms against "
          f"one card's {one_train:.1f} ms ({tp_train / one_train:.2f}x); "
          f"one card's prefill p50 "
          f"{statistics.median(one['prefill_ms']):.1f} ms | "
          f"{c.RESULTS['device']['nvidia_smi']}")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"one_card": one, "tp": tp},
                                        indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
