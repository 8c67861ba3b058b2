"""Gradient compression with error feedback.

Casting gradients to bf16 before the data-parallel reduction halves the
all-reduce bytes; the quantization error is carried in an fp32 residual
and re-injected the next step (error feedback). ``.to(torch.bfloat16)``
rounds to nearest even, as JAX's cast does, so this is bitwise the
reference's. The trees are `api.reference_leaves`'s structure
(`optim.tree`).
"""

from __future__ import annotations

import torch

from repro_torch.optim.tree import leaves_of, like


def init_error_state(leaves: dict) -> dict:
    return like(leaves, [torch.zeros_like(p, dtype=torch.float32)
                         for p in leaves_of(leaves)])


def compress(grads: dict, err: dict) -> tuple[dict, dict]:
    """Returns (bf16 grads to reduce, new fp32 residual)."""
    comp, new_err = [], []
    for g, e in zip(leaves_of(grads), leaves_of(err)):
        g32 = g.to(torch.float32) + e
        gc = g32.to(torch.bfloat16)
        comp.append(gc)
        new_err.append(g32 - gc.to(torch.float32))
    return like(grads, comp), like(grads, new_err)


def with_error_feedback(grads: dict, err: dict) -> tuple[dict, dict]:
    comp, new_err = compress(grads, err)
    return like(comp, [g.to(torch.float32) for g in leaves_of(comp)]), \
        new_err
