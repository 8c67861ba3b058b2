"""Tensor-parallel training on a (data, model) `DeviceMesh`, with ZeRO-1,
FSDP, sequence parallelism and checkpoints that restore onto another mesh.

The reference trains tensor-parallel by jitting its step with
`NamedSharding` parameters and optimizer state under its logical rules
(`launch/steps.py::build_cell`, `Cell.lower`); XLA partitions every layer
and inserts the collectives. Here the model's parameters are DTensors
placed by the same specs (`api.distribute` with the cell's ``fsdp``,
``zero1`` and ``seq_axis``; `launch.steps.train_knobs` gives an arch's),
its annotations place the activations as
the reference's do, and DTensor's sharding propagation inserts the
collectives:

  * every rank builds the whole model from the same seed and keeps its
    own slices (no communication);
  * the optimizer state is placed by `ShardingRules.state_spec`, as the
    reference places it: with ``zero1`` (the default) a stacked leaf's
    state is one tensor whose dim 0, the layer axis, is split over the
    data axis where the parameter is not (ZeRO-1; each rank's bytes are
    the dry-run's ``opt_bytes``); with FSDP the state follows the
    parameters' specs; with ``zero1=False`` it takes its parameters'
    placements (`optim.adamw`, `optim.adafactor`);
  * each microbatch is placed ``Shard(0)`` on ``"data"`` (the rules'
    `batch_spec`; each rank keeps its data shard of the rows), so the
    loss is the mean over the whole global batch and every gradient is
    already the global one: its partial sums over ``"data"`` are the data-
    parallel all-reduce (FSDP's reduce-scatter where the weight is split
    over ``"data"``), done where a gradient meets its parameter's
    placement;
  * `reduce` redistributes every gradient to its parameter's placements
    (DTensor may hand back a replicated gradient of a sharded weight) and
    brings the loss whole to every rank;
  * the step, optimizer included, runs under `sharding.tp_context`.

Checkpoints hold the one-device `Trainer`'s layout: every rank joins the
`full_tensor` of each leaf (`state`) and the mesh's first rank writes it
(`train.checkpoint`), so a checkpoint restores onto a mesh of any shape or
onto one device, and a one-device checkpoint onto any mesh: `try_restore`
places each whole leaf as the live one is placed.
"""

from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.sharding import full, is_dtensor, tp_context
from repro_torch.optim.tree import as_local, leaves_of, like
from repro_torch.train.checkpoint import (flatten, restore_latest,
                                          unflatten_like)
from repro_torch.train.trainer import Trainer

def _map(fn, tree):
    """``fn`` over every tensor of a tree of dicts and lists."""
    return unflatten_like(tree, {k: fn(t) for k, t in flatten(tree).items()})


def place_as(t: torch.Tensor, live):
    """The whole tensor ``t`` placed as the DTensor ``live`` is (partial
    sums read as replicated), each rank keeping its own block; ``t`` on
    ``live``'s device where ``live`` is a plain tensor."""
    t = t.to(live.device)
    if not is_dtensor(live):
        return t
    from torch.distributed.tensor import Replicate, distribute_tensor
    pl = [Replicate() if p.is_partial() else p for p in live.placements]
    return distribute_tensor(t, live.device_mesh, pl, src_data_rank=None)


def _placed_as(whole, live):
    """The tree ``whole`` with each leaf placed as ``live``'s
    (`place_as`)."""
    flat = flatten(whole)
    return unflatten_like(live, {k: place_as(flat[k], t)
                                 for k, t in flatten(live).items()})


def state_bytes(state: dict) -> int:
    """This rank's bytes of an optimizer state: every tensor but the step
    counter (the dry-run's ``opt_bytes``)."""
    return sum(as_local(t).nbytes for k, t in flatten(state).items()
               if k != "step")


class TensorParallelTrainer(Trainer):
    """`Trainer` as one rank of a (data, model) ``mesh`` (every rank of
    the mesh runs one). The model is ``model`` if given, else
    `api.build_model` of ``cfg`` from ``generator`` (default seeded 0) on
    ``device``; every rank must pass the same whole weights. It is placed
    on ``mesh`` by `api.distribute`, the batch axis chosen for the
    pipeline's global batch. ``tcfg.microbatches`` splits the global
    batch.

    ``zero1`` (ZeRO-1, on by default), ``fsdp`` (None: where the model's
    size asks for it, `ShardingRules.should_fsdp`) and ``seq_axis``
    (``"model"``: sequence parallelism) are the rules' as `build_cell`
    takes them; ``opt_kwargs`` go to the optimizer. An arch's train cell
    sets them by `launch.steps.train_knobs`, as `launch.train` does."""

    def __init__(self, cfg, tcfg, pipeline, mesh, *, model=None,
                 generator=None, device="cuda", zero1=True, fsdp=None,
                 seq_axis=None, opt_kwargs=None):
        opt_kwargs = dict(opt_kwargs or {})
        if model is None:
            gen = (generator if generator is not None
                   else torch.Generator().manual_seed(0))
            model = api.build_model(cfg, generator=gen, device=device)
        api.distribute(model, cfg, mesh, fsdp=fsdp, zero1=zero1,
                       seq_axis=seq_axis,
                       global_batch=pipeline.cfg.global_batch
                       // max(1, tcfg.microbatches))
        self.mesh = mesh
        self.rules = model.tp_rules
        if zero1:
            opt_kwargs["place"] = self._place_state
        with tp_context(model.logical):
            super().__init__(cfg, tcfg, pipeline, model=model,
                             opt_kwargs=opt_kwargs)
        self.writes_ckpt = not any(mesh.get_coordinate())

    def _place_state(self, t, leaf):
        return self.rules.place(t, self.rules.state_spec(leaf, t.shape))

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

    def state_bytes(self) -> int:
        """This rank's bytes of optimizer state (`state_bytes`)."""
        return state_bytes(self.opt_state)

    # --- checkpoints --------------------------------------------------------
    def _layout(self, fn) -> dict:
        """``fn`` of every tensor of the trainer's state, in the one-device
        `Trainer`'s layout (the same state, each tensor placed)."""
        return {"params": {n: fn(p) for n, p in
                           self.model.named_parameters()},
                "opt": _map(fn, self.opt_state), "err": _map(fn, self.err)}

    def state(self) -> dict:
        """What a checkpoint holds, whole (every rank joins each
        `full_tensor`), in the one-device `Trainer`'s layout."""
        with torch.no_grad():
            return self._layout(lambda t: full(t).detach())

    def checkpoint(self) -> None:
        """Every rank gathers the state; the mesh's first rank writes
        it."""
        tree = self.state()
        if self.writes_ckpt:
            self.ckpt.save_async(self.step, tree)

    def _sync(self) -> None:
        """A barrier over the mesh: one along each of its dims."""
        import torch.distributed as dist
        for i in range(self.mesh.ndim):
            dist.barrier(group=self.mesh.get_group(i))

    def try_restore(self) -> bool:
        """Every rank reads the newest valid checkpoint (written on any
        mesh or on one device) and places each leaf as its live one is
        placed; False where there is none."""
        if not self.ckpt:
            return False
        self.ckpt.wait()
        self._sync()               # the first rank's write is complete
        shapes = self._layout(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta"))
        step, tree = restore_latest(self.tcfg.ckpt_dir, shapes)
        if step is None:
            return False
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                as_local(p).copy_(as_local(place_as(tree["params"][name],
                                                    p)))
            self.opt_state = _placed_as(tree["opt"], self.opt_state)
            self.err = _placed_as(tree["err"], self.err)
        self.step = step
        return True
