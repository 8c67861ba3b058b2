"""Elastic scaling & straggler mitigation: the port of the JAX package's
`train/elastic.py`.

On a real fleet the control plane detects node failure / slow replicas and
the job must (a) continue with fewer data-parallel replicas or (b) absorb
new ones. Because every piece of run state here is either replicated
(step), deterministic-by-construction (data pipeline: batch = f(seed, step,
shard)) or a tree of tensors with sharding specs (params/optimizer),
elasticity reduces to ONE operation: re-placing the state trees under a
new mesh.

`reshard(tree, new_mesh, spec_tree)` is that operation: each leaf becomes a
DTensor on the new mesh with the placements of its spec (the reference's
``device_put`` with a ``NamedSharding``). Every rank of the world calls it
after building the new `DeviceMesh` (building a mesh is collective); a rank
outside the smaller mesh gets a DTensor whose local shard is empty.
`shrink_data_axis` recomputes the per-shard batch split — the pipeline
needs no migration because shards are stateless functions.

Straggler mitigation (monitor implemented in trainer.py): a per-step
deadline of straggler_factor x EMA(step time) records slow steps; at scale
a replica that misses K consecutive deadlines is ejected (this module's
reshard with the data axis reduced); checkpoints bound lost work to
ckpt_every steps, and the data pipeline replays the exact token stream
after restore.
"""

from __future__ import annotations

import torch

from repro_torch.launch.sharding import placements


def _leaf(x, mesh, spec):
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        full = x.full_tensor()    # collective over the mesh it is on
        # a rank outside that mesh holds nothing; it takes part with a
        # placeholder of the right shape (the data come from the source)
        x = full if full.shape == x.shape else torch.empty(
            x.shape, dtype=x.dtype, device=full.device)
    return distribute_tensor(x.detach(), mesh, placements(spec, mesh))


def reshard(tree, mesh, spec_tree):
    """Re-place a state tree (dicts and lists of tensors) onto ``mesh``
    with the matching specs (a tree of the same structure whose leaves are
    spec tuples). A leaf that is a DTensor on another mesh is gathered
    whole first. The values come from the new mesh's first rank
    (`distribute_tensor`'s source), which must hold the leaf: a plain
    tensor as that rank has it, a DTensor on a mesh that rank is in."""
    if isinstance(tree, dict):
        return {k: reshard(v, mesh, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [reshard(v, mesh, s) for v, s in zip(tree, spec_tree)]
    if not torch.is_tensor(tree):
        raise TypeError(f"a state leaf is a tensor; got {type(tree)}")
    return _leaf(tree, mesh, spec_tree)


def shrink_data_axis(global_batch: int, old_shards: int,
                     new_shards: int) -> int:
    """Per-shard batch after an elastic resize; global batch is preserved
    when divisible, otherwise rounded down to the nearest multiple."""
    if global_batch % new_shards == 0:
        return global_batch // new_shards
    return max(1, global_batch // new_shards)
