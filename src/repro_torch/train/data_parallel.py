"""Data-parallel training on a `DeviceMesh`, with elastic shrink.

The reference trains data-parallel by jitting its step over a batch
sharded on the mesh's ``"data"`` axis; XLA inserts the gradient
all-reduce. Here each rank runs `Trainer.train_step` on its own share of
the batch and `DataParallelTrainer.reduce` does the reduction explicitly:

  * the global batch of a step is the ``data_shards`` pipeline shards of
    that step, ``pipeline.batch(step, shard=j, num_shards=data_shards)``;
    data rank r of k takes shards ``r * data_shards // k`` up to the
    next rank's, concatenated. The shards are stateless functions of
    (seed, step, shard), so the global batch is the same whatever the
    number of ranks, and a resize moves no data;
  * where ``grad_compress`` is on, each replica's gradients are cast to
    bf16 with its own error residual first (the reference's
    `optim/grad_compress.py`), so the reduction moves bf16;
  * the gradients are summed by ``dist.all_reduce`` over the mesh's
    ``"data"`` group, in one flat bucket per dtype, and divided by k;
    the logged loss is all-reduced the same way (4 bytes more);
  * the parameters start equal on all ranks (a broadcast from data rank
    0) and stay replicated: every rank applies the same reduced
    gradients, so the optimizer state is replicated too;
  * data rank 0 alone writes checkpoints; every rank can `try_restore`.

Every rank of the world calls `resize` with a smaller ``"data"`` mesh built
on all of them: the state is re-placed with `elastic.reshard` (all of it
replicated: `ShardingRules(dp_only=True, zero1=False)` gives every leaf
``None``), the local batch recomputed with `elastic.shrink_data_axis` so
the global batch is kept (with proportionally more microbatches, so a
microbatch keeps its size), and the ranks outside the new mesh idle
(`run` returns at once). A restart at a smaller size is the other route:
a k-rank run's checkpoint restored into a k'-rank spawn with the same
``data_shards``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_shape
from repro_torch.optim.grad_compress import init_error_state
from repro_torch.optim.tree import leaves_of, like
from repro_torch.train.elastic import reshard, shrink_data_axis
from repro_torch.train.trainer import Trainer


def _replicated(tree):
    """A spec tree replicating every tensor of ``tree``."""
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicated(v) for v in tree]
    return (None,) * tree.dim()


def _locals(tree):
    """``tree`` with every DTensor replaced by its local tensor."""
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_locals(v) for v in tree]
    return tree.to_local()


def _buckets(tensors: list) -> dict:
    """Indices of ``tensors`` by dtype, in their order."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def _data_size(mesh) -> int:
    shape = mesh_shape(mesh)
    if "data" not in shape:
        raise ValueError(f"data parallelism runs over a mesh's 'data' dim; "
                         f"this mesh has {tuple(shape)}")
    return shape["data"]


class DataParallelTrainer(Trainer):
    """`Trainer` as one rank of data parallelism over ``mesh``'s ``"data"``
    dim (every rank of the mesh runs one). ``data_shards`` (default: the
    data dim's size) is the number of pipeline shards a global batch is
    drawn as; keep it across a resize or a restart. The trainer's own
    ``tcfg.microbatches`` splits this rank's local batch."""

    def __init__(self, cfg, tcfg, pipeline, mesh, *, data_shards=None,
                 model=None, generator=None, device="cuda"):
        super().__init__(cfg, tcfg, pipeline, model=model,
                         generator=generator, device=device)
        self.data_shards = data_shards or _data_size(mesh)
        self._attach(mesh)
        if self.active:
            with torch.no_grad():
                self._bucketed(self.params, self._broadcast)
        # the masters and the residual follow the broadcast weights
        self.opt_state = self.opt.init(self.leaves)
        if tcfg.grad_compress:
            self.err = init_error_state(self.leaves)

    def _attach(self, mesh) -> None:
        self.mesh = mesh
        self.k = _data_size(mesh)
        if self.data_shards % self.k:
            raise ValueError(f"{self.data_shards} pipeline shards do not "
                             f"split over {self.k} data ranks")
        coord = mesh.get_coordinate()
        self.active = coord is not None
        names = tuple(mesh.mesh_dim_names)
        self.rank = coord[names.index("data")] if self.active else None
        self.group = mesh.get_group("data") if self.active else None
        self.writes_ckpt = self.rank == 0

    # --- the data ---------------------------------------------------------
    def shards(self) -> range:
        """The pipeline shards this rank trains on."""
        per = self.data_shards // self.k
        return range(self.rank * per, (self.rank + 1) * per)

    def batch(self, step: int) -> dict:
        parts = [self.pipeline.batch(step, shard=j,
                                     num_shards=self.data_shards)
                 for j in self.shards()]
        return {key: np.concatenate([p[key] for p in parts])
                for key in parts[0]}

    # --- the reduction ----------------------------------------------------
    def _broadcast(self, flat: torch.Tensor) -> None:
        dist.broadcast(flat, group=self.group, group_src=0)

    def _all_reduce(self, flat: torch.Tensor) -> None:
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.k)

    def _bucketed(self, tensors: list, op) -> list:
        """``op`` on one flat bucket per dtype of ``tensors``; returns them
        with the bucket's values (parameters are written back in place)."""
        out = list(tensors)
        for idx in _buckets(tensors).values():
            parts = [tensors[i] for i in idx]
            flat = torch.cat([t.reshape(-1) for t in parts])
            op(flat)
            for i, piece in zip(idx, flat.split([t.numel() for t in parts])):
                piece = piece.view_as(tensors[i])
                if isinstance(tensors[i], torch.nn.Parameter):
                    tensors[i].copy_(piece)
                else:
                    out[i] = piece
        return out

    def reduce(self, grads: dict, loss: torch.Tensor) -> tuple:
        """The mean over the data ranks of the gradients (in their own
        dtype: bf16 after compression) and of the loss."""
        flat = self._bucketed(leaves_of(grads), self._all_reduce)
        loss = loss.reshape(1).clone()
        self._all_reduce(loss)
        return like(grads, flat), loss[0]

    # --- elasticity -------------------------------------------------------
    def resize(self, mesh) -> None:
        """Continue on ``mesh`` (a smaller ``"data"`` mesh that every rank
        of the world built): the state re-placed onto it, the local batch
        and the microbatches recomputed so the global batch is kept. Ranks
        outside ``mesh`` go idle."""
        if self.ckpt:
            self.ckpt.wait()
        old_k, n = self.k, self.tcfg.microbatches
        state = {"params": self.params, "opt": self.opt_state,
                 "err": self.err}
        moved = reshard(state, mesh, _replicated(state))
        self._attach(mesh)
        if not self.active:
            return
        moved = _locals(moved)
        with torch.no_grad():
            for p, new in zip(self.params, moved["params"]):
                p.copy_(new)
        self.opt_state, self.err = moved["opt"], moved["err"]
        g = self.pipeline.cfg.global_batch
        local = shrink_data_axis(g, old_k, self.k)
        n_new = n * local * old_k // g
        self.tcfg = dataclasses.replace(self.tcfg, microbatches=n_new)

    def run(self, num_steps: int, log_every: int = 10,
            fail_at: int | None = None) -> list[float]:
        """`Trainer.run` on this rank; a rank outside the mesh idles."""
        if not self.active:
            return self.history
        return super().run(num_steps, log_every, fail_at)
