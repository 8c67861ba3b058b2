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
