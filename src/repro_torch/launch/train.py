"""Training launcher: the port of the reference's `launch/train.py`, its
real-execution mode, with ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 20 --ckpt-dir DIR                 # on the card (default)
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 20 --device cpu           # reduced config, CPU

Fault tolerance: ``--restore`` resumes from the newest valid checkpoint
in ``--ckpt-dir`` (examples/train_lm_torch.py injects a failure and
resumes).
"""

from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.kernels.pack import check_device
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> Trainer:
    """Train ``--steps`` steps; returns the trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = check_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    pipe = SyntheticTokens(PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=0, frontend_tokens=(cfg.n_frontend_tokens
                                 if cfg.family in ("vlm", "encdec") else 0),
        d_model=cfg.d_model))
    tcfg = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                       microbatches=args.microbatches,
                       grad_compress=args.grad_compress,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, tcfg, pipe, device=dev)
    if args.restore and trainer.try_restore():
        print(f"restored from step {trainer.step}")
    hist = trainer.run(args.steps, log_every=max(1, args.steps // 5))
    print(f"done: {trainer.step} steps, final loss {hist[-1]:.4f}")
    if trainer.straggler_steps:
        print(f"straggler steps: {trainer.straggler_steps}")
    return trainer


if __name__ == "__main__":
    main()
