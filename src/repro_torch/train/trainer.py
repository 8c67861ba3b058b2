"""Training loop with microbatched gradient accumulation, fault tolerance
and straggler monitoring: the port of the reference's `train/trainer.py`.

  * gradient accumulation over ``microbatches`` sequential backward
    passes, summed in ``acc_dtype`` (the reference scans them with
    `lax.scan`); the peak activation memory is one microbatch's;
  * gradient compression (bf16 + error feedback) before the optimizer;
  * async checkpoint every ``ckpt_every`` steps + restore-from-latest;
  * straggler monitor: a per-step wall-time EMA; steps slower than
    ``straggler_factor`` x EMA are logged.

The step is eager: the model's parameters are updated in place by the
optimizer, and the only host read is the loss the loop logs.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.kernels.pack import check_device
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.optim import make_optimizer
from repro_torch.optim.grad_compress import compress, init_error_state
from repro_torch.optim.tree import leaves_of, like
from repro_torch.train.checkpoint import (AsyncCheckpointer, flatten,
                                          restore_latest)


@dataclasses.dataclass
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    microbatches: int = 1
    acc_dtype: str = "float32"   # grad-accumulation dtype (bf16 halves
                                 # the accumulator's memory)
    grad_compress: bool = False
    ckpt_every: int = 50
    ckpt_dir: str = ""
    straggler_factor: float = 3.0


class Trainer:
    """Single-controller training loop (the examples and
    `launch.train`). The model is ``model`` if given (the tests pass one
    carrying the reference's weights), else `api.build_model` of ``cfg``
    drawn from ``generator`` (default: seeded 0) on ``device``. Its
    parameters are unfrozen here. ``opt_kwargs`` go to the optimizer
    (`optim.make_optimizer`)."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainConfig, pipeline, *,
                 model=None, generator: torch.Generator | None = None,
                 device="cuda", opt_kwargs: dict | None = None):
        self.cfg, self.tcfg, self.pipeline = cfg, tcfg, pipeline
        if model is None:
            gen = (generator if generator is not None
                   else torch.Generator().manual_seed(0))
            model = api.build_model(cfg, generator=gen,
                                    device=check_device(device))
        self.model = model.requires_grad_(True)
        self.device = next(model.parameters()).device
        self.leaves = api.reference_leaves(model, cfg)
        self.params = leaves_of(self.leaves)
        self.opt = make_optimizer(tcfg.optimizer, lr=tcfg.lr,
                                  **(opt_kwargs or {}))
        self.opt_state = self.opt.init(self.leaves)
        self.err = (init_error_state(self.leaves)
                    if tcfg.grad_compress else {})
        self.step = 0
        self.ckpt = (AsyncCheckpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.writes_ckpt = True
        self._ema = None
        self.straggler_steps: list[int] = []
        self.history: list[float] = []

    def state(self) -> dict:
        """What a checkpoint holds: the parameters (by module name), the
        optimizer state and the compression residual."""
        return {"params": dict(self.model.named_parameters()),
                "opt": self.opt_state, "err": self.err}

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on ``batch`` (numpy or torch, leading dim
        split into ``microbatches``); returns the metrics ``loss`` (the
        mean of the microbatch losses) and ``gnorm`` (of the gradients the
        optimizer got), as device tensors."""
        n = self.tcfg.microbatches
        acc_dt = getattr(torch, self.tcfg.acc_dtype)
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        b = batch["inputs"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        gsum = [torch.zeros_like(p, dtype=acc_dt) for p in self.params]
        lsum = torch.zeros((), device=self.device)
        for i in range(n):
            mb = self.place({k: v[i * b // n:(i + 1) * b // n]
                             for k, v in batch.items()})
            loss, _ = api.loss_fn(self.model, self.cfg, mb)
            grads = torch.autograd.grad(loss, self.params,
                                        allow_unused=True)
            for s, g in zip(gsum, grads):
                if g is not None:
                    s.add_(g.to(acc_dt))
            lsum = lsum + loss.detach()
        grads = like(self.leaves, [s.to(torch.float32) / n for s in gsum])
        if self.tcfg.grad_compress:
            grads, self.err = compress(grads, self.err)
        grads, loss = self.reduce(grads, lsum / n)
        self.opt_state = self.opt.update(grads, self.opt_state, self.leaves)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in leaves_of(grads)))
        return {"loss": loss, "gnorm": gnorm}

    def reduce(self, grads: dict, loss: torch.Tensor) -> tuple:
        """The gradients the optimizer takes and the loss logged, from this
        process's own: itself on one device (`DataParallelTrainer`
        averages them over its data replicas)."""
        return grads, loss

    def place(self, mb: dict) -> dict:
        """A microbatch as this process's model takes it: itself on one
        device (`TensorParallelTrainer` shards its rows over the data
        axis)."""
        return mb

    def batch(self, step: int) -> dict:
        """The batch this process trains on at ``step``."""
        return self.pipeline.batch(step)

    # --- fault tolerance --------------------------------------------------
    def checkpoint(self) -> None:
        """An asynchronous save of `state` at this step, where this process
        writes checkpoints."""
        if self.writes_ckpt:
            self.ckpt.save_async(self.step, self.state())

    def try_restore(self) -> bool:
        """Load the newest valid checkpoint into the live tensors
        (parameters, optimizer state with its step, masters and moments,
        and the compression residual); False where there is none."""
        if not self.ckpt:
            return False
        self.ckpt.wait()   # an async save may still be in flight
        live = self.state()
        step, tree = restore_latest(self.tcfg.ckpt_dir, live)
        if step is None:
            return False
        with torch.no_grad():
            for t, saved in zip(flatten(live).values(),
                                flatten(tree).values()):
                t.copy_(saved)
        self.step = step
        return True

    def run(self, num_steps: int, log_every: int = 10,
            fail_at: int | None = None) -> list[float]:
        """Train; ``fail_at`` injects a simulated crash (tests/examples)."""
        while self.step < num_steps:
            if fail_at is not None and self.step == fail_at:
                fail_at = None
                raise RuntimeError(f"injected failure at step {self.step}")
            t0 = time.perf_counter()
            metrics = self.train_step(self.batch(self.step))
            loss = float(metrics["loss"])
            self.history.append(loss)
            dt = time.perf_counter() - t0
            if self._ema is None:
                self._ema = dt
            if dt > self.tcfg.straggler_factor * self._ema:
                self.straggler_steps.append(self.step)
            self._ema = 0.9 * self._ema + 0.1 * dt
            self.step += 1
            if self.ckpt and self.step % self.tcfg.ckpt_every == 0:
                self.checkpoint()
            if log_every and self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
        if self.ckpt:
            self.ckpt.wait()
        return self.history
