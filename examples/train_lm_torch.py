"""Train a SmolLM-family model on the PyTorch/CUDA port (`src/repro_torch`)
and score its trained head compressed: the steps of `examples/train_lm.py`,
on the card by default.

Training runs on the synthetic pipeline with checkpoints, an injected
mid-run failure and a restore from the last checkpoint (the
fault-tolerance demo). Then the tied LM head is swapped for a pruned,
entropy-coded `SparseLinear` and the eval loss recomputed with every
hidden state of a training-shaped batch (B = batch * seq rows) contracted
through the dtANS SpMM in one call.

Full run (SmolLM-135M at full width, batch 16 x 512, on the card):
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300

Reduced config:
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --steps 30 \\
        [--device cpu]
"""

import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import get, get_smoke
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.kernels.pack import check_device
from repro_torch.models import api
from repro_torch.serving.sparse_linear import SparseLinear
from repro_torch.train.trainer import TrainConfig, Trainer


def masked_ce(logits, targets, mask=None) -> float:
    """Masked next-token cross entropy over (B, S, V) logits: the
    `repro_torch.models.api.loss_fn` formula, for logits from any head
    (dense or sparse)."""
    return float(api.masked_ce(logits, targets, mask)[0])


def sparse_head_eval(model, cfg, batch, *, sparsity: float = 0.5,
                     value_bits: int = 8, pipeline: bool = False):
    """Eval loss with the LM head replaced by a compressed head.

    The (d_model, vocab) head (the tied ``embed.tok.T`` or an untied
    ``embed.head``) is magnitude-pruned, codebook-quantized and
    CSR-dtANS-encoded into a `SparseLinear` on the model's device; the
    model's hidden states for the whole batch flatten to a
    training-shaped pool of B * S rows and contract through `ops.spmm`
    (the dtANS SpMM kernel on the card) in one `apply`, column-tiled
    inside the kernel.

    Returns ``(dense_loss, sparse_loss, head, hidden, logits)``: the two
    losses agree to the compression error; ``hidden`` (B, S, d) float32 is
    the pool and ``logits`` (B, S, vocab) the compressed head's."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        hidden, _ = model.forward_hidden(batch)
        w = model.embed.head_weight().detach().float()      # (d_model, V)
        head = SparseLinear.from_dense(w, sparsity=sparsity,
                                       value_bits=value_bits, device=dev)
        hidden = hidden.float()
        logits = head.apply(hidden, pipeline=pipeline)      # (B, S, V)
        dense = masked_ce(model(batch)[0], batch["targets"],
                          batch.get("mask"))
    sparse = masked_ce(logits, batch["targets"], batch.get("mask"))
    return dense, sparse, head, hidden, logits


def main(argv=None) -> Trainer:
    """Train, crash, restore, finish and score the compressed head;
    returns the trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance "
                         "demo); the run resumes from the last checkpoint")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--head-sparsity", type=float, default=0.5,
                    help="prune fraction of the compressed LM head "
                         "evaluated after training")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    if args.tiny:
        cfg = get_smoke("smollm-135m").with_(vocab=512)
        batch, seq = 8, 64
    else:
        cfg = get("smollm-135m").with_(remat=False)   # ~135M params
        batch, seq = 16, 512

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="train_lm_torch_")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        pipe = SyntheticTokens(PipelineConfig(
            vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
        tcfg = TrainConfig(optimizer="adamw", lr=3e-4, microbatches=2,
                           ckpt_every=args.ckpt_every, ckpt_dir=ckpt)
        trainer = Trainer(cfg, tcfg, pipe, device=dev)
        n_params = sum(p.numel() for p in trainer.params)
        print(f"arch={cfg.name} params~{n_params / 1e6:.1f}M "
              f"batch={batch} seq={seq} device={dev}")

        try:
            trainer.run(args.steps, log_every=5, fail_at=args.fail_at)
        except RuntimeError as e:
            print(f"!! {e} - restoring from checkpoint and resuming")
            restored = trainer.try_restore()
            print(f"restored={restored} at step {trainer.step}")
            trainer.run(args.steps, log_every=5)
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt, ignore_errors=True)

    h = trainer.history
    k = max(3, len(h) // 5)
    print(f"loss: first-{k}-avg {sum(h[:k])/k:.4f} -> "
          f"last-{k}-avg {sum(h[-k:])/k:.4f}")
    if not sum(h[-k:]) < sum(h[:k]):
        raise RuntimeError("loss did not decrease")
    print("training loss decreased: OK")
    if trainer.straggler_steps:
        print(f"straggler steps detected: {trainer.straggler_steps}")

    # The serving story at training shapes: swap the head for a
    # compressed SparseLinear and re-score one training batch, all
    # batch * seq hidden rows in one SpMM call.
    dense, sparse, head, _, _ = sparse_head_eval(
        trainer.model, cfg, pipe.batch(trainer.step),
        sparsity=args.head_sparsity)
    print(f"sparse head: {head.compression_vs_dense:.1f}x vs dense "
          f"({head.compressed_bytes} B), pool B={batch * seq}")
    print(f"eval loss: dense-head {dense:.4f}  sparse-head {sparse:.4f}")
    return trainer


if __name__ == "__main__":
    main()
