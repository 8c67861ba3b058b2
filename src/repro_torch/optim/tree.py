"""The parameter trees the optimizers walk.

A tree here is `api.reference_leaves`'s: a dict from the reference's leaf
name to a tensor, or to the list of a stacked leaf's per-layer tensors.
Gradients, error states and AdamW's moments share its structure; the
optimizers and `grad_compress` walk it with these helpers.
"""

from __future__ import annotations

import torch


def leaves_of(tree: dict) -> list:
    """Every tensor of ``tree``, in its order (a stacked leaf's layers in
    turn)."""
    out = []
    for v in tree.values():
        out.extend(v if isinstance(v, list) else [v])
    return out


def like(tree: dict, flat: list) -> dict:
    """``flat`` (as `leaves_of` orders it) in the structure of ``tree``."""
    it = iter(flat)
    out = {k: [next(it) for _ in v] if isinstance(v, list) else next(it)
           for k, v in tree.items()}
    if next(it, None) is not None:
        raise ValueError("more tensors than the tree has leaves")
    return out


def stacked(leaf) -> torch.Tensor:
    """A leaf as the reference holds it: a stacked leaf's layers stacked on
    a new first axis (a copy), any other leaf itself."""
    return torch.stack(leaf) if isinstance(leaf, list) else leaf


def _shifted(placements) -> tuple:
    """The placements of a layer's DTensor for the stack of the layers:
    each ``Shard(d)`` one dim further on."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                 for p in placements)


def as_local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a DTensor; a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """DTensor ``t`` redistributed to the placements of the DTensor
    ``like``; ``t`` itself where ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor) or t.placements == like.placements:
        return t
    return t.redistribute(like.device_mesh, like.placements)


def stack_local(leaf) -> torch.Tensor:
    """`stacked` without communication: a stacked leaf of DTensors is
    stacked rank by rank (each rank its own blocks), placed as its layers
    are one dim further on."""
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, list) or not isinstance(leaf[0], DTensor):
        return stacked(leaf)
    return DTensor.from_local(torch.stack([t.to_local() for t in leaf]),
                              leaf[0].device_mesh,
                              _shifted(leaf[0].placements), run_check=False)


def write_leaf(leaf, w: torch.Tensor) -> None:
    """``w``, the new value of ``leaf`` (stacked for a stacked leaf), copied
    into the leaf's tensors in place (cast to their dtype). A DTensor ``w``
    is first brought to the leaf's placements: from a placement sharded
    over more axes (ZeRO-1's state) that is the all-gather of the updated
    weights. Then each rank copies its own block."""
    from torch.distributed.tensor import DTensor
    ts = leaf if isinstance(leaf, list) else [leaf]
    if isinstance(w, DTensor):
        pl = ts[0].placements
        w = w.redistribute(ts[0].device_mesh,
                           _shifted(pl) if isinstance(leaf, list) else pl
                           ).to_local()
    if isinstance(leaf, list):
        for i, t in enumerate(leaf):
            as_local(t).copy_(w[i])
    else:
        as_local(leaf).copy_(w)
