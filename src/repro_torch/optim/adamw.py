"""AdamW with fp32 master weights over (possibly bf16) parameters.

Interface (shared by the optimizers here, as in the reference):
  init(leaves)                   -> state
  update(grads, state, leaves)   -> state
``leaves`` is `api.reference_leaves`'s tree of the model's parameters and
``grads`` a tree of the same structure (`optim.tree`). ``update`` writes
the new weights into the parameters in place, under ``torch.no_grad()``,
where the reference returns new ones. The state is a dict of tensors on
the parameters' device (its ``step`` too, so nothing is read back to the
host); its masters are float32 copies that never alias a float32
parameter.

AdamW is elementwise, so it runs per tensor: its state lists one master
and one pair of moments per tensor, in `tree.leaves_of`'s order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim.tree import leaves_of


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def f32_copy(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of ``t`` that never shares its storage (``.float()``
    of a float32 tensor would)."""
    return t.detach().to(torch.float32, copy=True)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(leaves):
        ps = leaves_of(leaves)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=ps[0].device),
            "master": [f32_copy(p) for p in ps],
            "m": [torch.zeros_like(p, dtype=torch.float32) for p in ps],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in ps],
        }

    def update(grads, state, leaves):
        step = state["step"] + 1
        t = step.to(torch.float32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        with torch.no_grad():
            for p, g, m, v, w in zip(leaves_of(leaves), leaves_of(grads),
                                     state["m"], state["v"],
                                     state["master"]):
                g = g.to(torch.float32)
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                u = (m / c1) / (torch.sqrt(v / c2) + eps)
                w.sub_(lr * (u + weight_decay * w))
                p.copy_(w)
        return {**state, "step": step}

    return Optimizer(init=init, update=update)
