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

AdamW is elementwise; its state lists one master and one pair of moments
per reference leaf (`api.reference_leaves`), a stacked leaf's as one
stacked tensor, as the reference holds them. `update` stacks each
gradient as its leaf's state, updates the state and copies the new
weights into the leaf's tensors (`tree.write_leaf`).

Placed state (``place``, a tensor-parallel trainer's ZeRO-1): each state
tensor is placed by ``place(t, leaf)`` (`ShardingRules.state_spec`:
ZeRO-1 splits dim 0, the layer axis of a stacked leaf, over the data
axis). `update` then brings each gradient to its state's placement (from
a replicated one, a local slice), updates this rank's block of the state,
and writes the weights back in the parameters' placements
(`tree.write_leaf`: ZeRO-1's all-gather). The arithmetic is element for
element that of unplaced state, so the weights are bitwise the same.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.optim.tree import (as_local, placed_like, stack_local,
                                    write_leaf)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def f32_copy(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of ``t`` that never shares its storage (``.float()``
    of a float32 tensor would)."""
    return t.detach().to(torch.float32, copy=True)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, place: Callable | None = None
          ) -> Optimizer:
    """``place(t, leaf)``: the state placed (see the module's doc); None
    leaves it on the parameters' device, unplaced."""
    def init(leaves):
        ws = [f32_copy(stack_local(p)) for p in leaves.values()]
        if place is not None:
            ws = [place(w, k) for w, k in zip(ws, leaves)]
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=ws[0].device),
                "master": ws,
                "m": [torch.zeros_like(w) for w in ws],
                "v": [torch.zeros_like(w) for w in ws]}

    def step_(g, m, v, w, c1, c2):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        w.sub_(lr * (u + weight_decay * w))

    def update(grads, state, leaves):
        step = state["step"] + 1
        t = step.to(torch.float32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        with torch.no_grad():
            for p, g, m, v, w in zip(leaves.values(), grads.values(),
                                     state["m"], state["v"],
                                     state["master"]):
                g = placed_like(stack_local(g), w)
                step_(*map(as_local, (g, m, v, w)), c1, c2)
                write_leaf(p, w)
        return {**state, "step": step}

    return Optimizer(init=init, update=update)
