"""Training launcher: the port of the reference's `launch/train.py`, its
real-execution mode, with ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 20 --ckpt-dir DIR                 # on the card (default)
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 20 --device cpu           # reduced config, CPU

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 20 --ranks 2 --device cpu # data-parallel, 2 ranks

Fault tolerance: ``--restore`` resumes from the newest valid checkpoint
in ``--ckpt-dir`` (examples/train_lm_torch.py injects a failure and
resumes).

``--ranks K`` trains data-parallel (`train.data_parallel`): K ranks, each
a process of its own, over one ``"data"`` mesh; ``--batch`` is the global
batch, drawn as K pipeline shards. The ranks join over NCCL where there
are K cards, and over gloo otherwise (on the CPU, or several ranks on one
card: NCCL refuses two ranks on one GPU).

``--ranks K --model-ranks M`` trains tensor-parallel
(`train.tensor_parallel`) on a ``(K / M, M)`` (data, model) mesh with the
arch's train knobs (`launch.steps.train_knobs`: its optimizer and the
optimizer's settings unless ``--optimizer`` names another, its
accumulation dtype, ZeRO-1, and FSDP or sequence parallelism where the
knobs set them): the model's weights and
optimizer state placed by the sharding rules, each microbatch split over
the data axis. Its checkpoints hold whole tensors, so ``--restore``
resumes on any ``K`` and ``M``, or on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 3 --ranks 4 --model-ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.kernels.pack import check_device
from repro_torch.launch.mesh import spawn
from repro_torch.launch.steps import train_knobs
from repro_torch.train.data_parallel import DataParallelTrainer
from repro_torch.train.tensor_parallel import TensorParallelTrainer
from repro_torch.train.trainer import TrainConfig, Trainer


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default=None,
                    choices=["adamw", "adafactor"],
                    help="default adamw; tensor-parallel: the arch's knobs'")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks (default 1): data-parallel, or with "
                         "--model-ranks the whole (data, model) mesh")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="tensor-parallel ranks of the mesh's model axis "
                         "(default 1: data parallelism only)")
    return ap


def _setup(args, knobs: dict | None = None) -> tuple:
    """(config, pipeline, `TrainConfig`) of ``args``; ``knobs`` (a
    tensor-parallel run's `train_knobs`) give the optimizer where
    ``--optimizer`` does not, and the accumulation dtype."""
    knobs = knobs or {}
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    pipe = SyntheticTokens(PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=0, frontend_tokens=(cfg.n_frontend_tokens
                                 if cfg.family in ("vlm", "encdec") else 0),
        d_model=cfg.d_model))
    tcfg = TrainConfig(optimizer=(args.optimizer
                                  or knobs.get("optimizer", "adamw")),
                       lr=args.lr, microbatches=args.microbatches,
                       acc_dtype=knobs.get("acc_dtype", "float32"),
                       grad_compress=args.grad_compress,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)
    return cfg, pipe, tcfg


def _train(trainer, args, log: bool) -> None:
    if args.restore and trainer.try_restore() and log:
        print(f"restored from step {trainer.step}")
    hist = trainer.run(args.steps,
                       log_every=max(1, args.steps // 5) if log else 0)
    if log:
        print(f"done: {trainer.step} steps, final loss {hist[-1]:.4f}")
        if trainer.straggler_steps:
            print(f"straggler steps: {trainer.straggler_steps}")


def _rank(mesh, argv) -> dict:
    """One data-parallel rank of ``--ranks``; data rank 0 logs."""
    args = _parser().parse_args(argv)
    cfg, pipe, tcfg = _setup(args)
    t = DataParallelTrainer(cfg, tcfg, pipe, mesh, device=args.device)
    _train(t, args, log=t.rank == 0)
    return {"rank": t.rank, "step": t.step, "history": t.history,
            "straggler_steps": t.straggler_steps}


def _tp_rank(mesh, argv) -> dict:
    """One rank of ``--ranks K --model-ranks M``; the mesh's first rank
    logs."""
    args = _parser().parse_args(argv)
    knobs = train_knobs(args.arch)
    cfg, pipe, tcfg = _setup(args, knobs)
    t = TensorParallelTrainer(
        cfg, tcfg, pipe, mesh, device=args.device, fsdp=knobs["fsdp"],
        seq_axis=knobs["seq_axis"],
        opt_kwargs=(knobs["opt_kwargs"]
                    if tcfg.optimizer == knobs["optimizer"] else {}))
    first = not any(mesh.get_coordinate())
    _train(t, args, log=first)
    return {"coord": tuple(mesh.get_coordinate()), "step": t.step,
            "history": t.history, "optimizer": tcfg.optimizer,
            "fsdp": t.rules.fsdp, "seq": t.model.logical["seq"]}


def main(argv=None):
    """Train ``--steps`` steps; returns the trainer, or with ``--ranks``
    above 1 the ranks' results (step, loss history), the first rank
    first."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    dev = check_device(args.device)
    if args.model_ranks > 1 and args.ranks % args.model_ranks:
        raise ValueError(f"--model-ranks {args.model_ranks} does not "
                         f"divide --ranks {args.ranks}")
    if args.ranks > 1:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        backend = "nccl" if cards >= args.ranks else "gloo"
        if args.model_ranks > 1:
            m = args.model_ranks
            return spawn(args.ranks, _tp_rank, argv, device_type=dev.type,
                         backend=backend, axes=("data", "model"),
                         shape=(args.ranks // m, m))
        return spawn(args.ranks, _rank, argv, device_type=dev.type,
                     backend=backend, axes=("data",))
    cfg, pipe, tcfg = _setup(args)
    trainer = Trainer(cfg, tcfg, pipe, device=dev)
    _train(trainer, args, log=True)
    return trainer


if __name__ == "__main__":
    main()
