"""Tensor-parallel training on a (data, model) `DeviceMesh`.

The reference trains tensor-parallel by jitting its step with
`NamedSharding` parameters under its logical rules (`launch/steps.py::
Cell.lower`); XLA partitions every layer and inserts the collectives.
Here the model's parameters are DTensors placed by the same specs
(`api.distribute`, `zero1=False`, `fsdp=False`), its annotations place
the activations as the reference's do, and DTensor's sharding propagation
inserts the collectives:

  * every rank builds the whole model from the same seed and keeps its
    own slices (no communication); the optimizer state (AdamW's masters
    and moments, Adafactor's factored moments) follows the parameters'
    placements;
  * each microbatch is placed ``Shard(0)`` on ``"data"`` (the rules'
    `batch_spec`; each rank keeps its data shard of the rows), so the
    loss is the mean over the whole global batch and every gradient is
    already the global one: its partial sums over ``"data"`` are the data-
    parallel all-reduce, done where a gradient meets its parameter's
    placement;
  * `reduce` redistributes every gradient to its parameter's placements
    (DTensor may hand back a replicated gradient of a sharded weight) and
    brings the loss whole to every rank;
  * the step, optimizer included, runs under `sharding.tp_context`.

Checkpoints of DTensor state are not written here yet (ROADMAP A11): a
`TrainConfig` with a ``ckpt_dir`` is refused.
"""

from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.sharding import full, is_dtensor, tp_context
from repro_torch.optim.tree import leaves_of, like
from repro_torch.train.trainer import Trainer


class TensorParallelTrainer(Trainer):
    """`Trainer` as one rank of a (data, model) ``mesh`` (every rank of
    the mesh runs one). The model is ``model`` if given, else
    `api.build_model` of ``cfg`` from ``generator`` (default seeded 0) on
    ``device``; every rank must pass the same whole weights. It is placed
    on ``mesh`` by `api.distribute`, the batch axis chosen for the
    pipeline's global batch. ``tcfg.microbatches`` splits the global
    batch."""

    def __init__(self, cfg, tcfg, pipeline, mesh, *, model=None,
                 generator=None, device="cuda"):
        if tcfg.ckpt_dir:
            raise ValueError("checkpoints of a tensor-parallel trainer's "
                             "DTensor state are not written yet (A11)")
        if model is None:
            gen = (generator if generator is not None
                   else torch.Generator().manual_seed(0))
            model = api.build_model(cfg, generator=gen, device=device)
        api.distribute(model, cfg, mesh, global_batch=pipeline.cfg.global_batch
                       // max(1, tcfg.microbatches))
        self.mesh = mesh
        self.rules = model.tp_rules
        with tp_context(model.logical):
            super().__init__(cfg, tcfg, pipeline, model=model)
        self.writes_ckpt = False

    def place(self, mb: dict) -> dict:
        """A microbatch ``Shard(0)`` on the data axis (`batch_spec`)."""
        return self.rules.distribute_batch(mb)

    def train_step(self, batch: dict) -> dict:
        """`Trainer.train_step` under `tp_context`; the metrics come back
        whole (plain tensors) on every rank."""
        with tp_context(self.model.logical):
            out = super().train_step(batch)
            return {k: full(v) for k, v in out.items()}

    def reduce(self, grads: dict, loss: torch.Tensor) -> tuple:
        """Every gradient in its parameter's placements, the loss whole."""
        flat = [g.redistribute(p.device_mesh, p.placements)
                if is_dtensor(g) else g
                for g, p in zip(leaves_of(grads), self.params)]
        return like(grads, flat), full(loss)
