"""Adafactor (factored second moment): O(n+m) state for an (n, m) matrix
instead of O(nm), plus fp32 master weights (``master=False`` drops them).

It runs over the reference's leaves, not per tensor: the reference factors
each leaf over its last two axes and clips the RMS of the update over the
whole leaf, and its layer leaves are stacked over the layers. So a stacked
leaf's layers are stacked for the update (`tree.stacked`) and written back
layer by layer: a norm scale of (n_layers, d) is factored, with one ``vc``
of (d,) for all the layers, and the clip couples every layer of a stack,
as in the reference. The second-moment state is a list aligned with the
tree's leaves; the masters, where kept, are the stacked float32 leaves.

Placed state (``place``, a tensor-parallel trainer's ZeRO-1): every state
tensor is placed by ``place(t, leaf)`` (`ShardingRules.state_spec`: the
masters by their leaf's spec, the moments, ``leaf`` None, replicated;
then ZeRO-1 splits dim 0 over the data axis). The factored statistics and
the clip need the whole leaf, so the update direction is computed as
with unplaced state, on the gradient in its parameter's placements, each
old moment first brought to its new statistic's placement (`_like`).
Only exact moves change a placement (slices, gathers), and partial sums
over the model axis are kept partial as the unplaced update keeps them,
so the weights are bitwise those of unplaced state. Then the direction is
brought to the master's placement (a local slice), this rank's block of
the master updated, and the weights written back in the parameters'
placements (`tree.write_leaf`: ZeRO-1's all-gather).
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import Optimizer, f32_copy
from repro_torch.optim.tree import placed_like, stacked, write_leaf


def _like(old, new):
    """The old moment ``old`` in the placements of its new statistic
    ``new`` (from a spec's placement: an all-gather over the data axis, a
    slice or nothing on the model axis); a replicated dim stays so where
    ``new`` holds partial sums (the first step's zeros, met as the unplaced
    update meets them)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(old, DTensor) or not isinstance(new, DTensor):
        return old
    pl = tuple(o if n.is_partial() and not o.is_partial() else n
               for o, n in zip(old.placements, new.placements))
    return old if pl == tuple(old.placements) else old.redistribute(
        old.device_mesh, pl)


def _stored(x, old):
    """A new moment ``x`` in the placements of the old one ``old`` (its
    spec's, partial sums read as replicated), each mesh dim where ``x``
    holds partial sums that the spec leaves replicated kept partial: every
    rank holds the spec's bytes, and the sums are reduced where the next
    update uses them, as without placed state."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    pl = []
    for c, o in zip(x.placements, old.placements):
        want = Replicate() if o.is_partial() else o
        pl.append(c if c.is_partial() and isinstance(want, Replicate)
                  else want)
    pl = tuple(pl)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def adafactor(lr: float, decay: float = 0.8, eps: float = 1e-30,
              clip_rms: float = 1.0, weight_decay: float = 0.0,
              master: bool = True, place=None) -> Optimizer:
    """master=False drops the fp32 master copy (updates are applied in the
    parameters' own dtype), saving 4 bytes a parameter. ``place(t,
    leaf)``: the state placed (see the module's doc)."""
    def _factored(shape):
        return len(shape) >= 2

    def init(leaves):
        def state_for(p):
            z = dict(dtype=torch.float32, device=p.device)
            shapes = ({"vr": p.shape[:-1],
                       "vc": p.shape[:-2] + p.shape[-1:]}
                      if _factored(p.shape) else {"v": p.shape})
            return {k: (torch.zeros(s, **z) if place is None
                        else place(torch.zeros(s, **z), None))
                    for k, s in shapes.items()}

        with torch.no_grad():
            ps = [stacked(p) for p in leaves.values()]
            state = {"step": torch.zeros((), dtype=torch.int32,
                                         device=ps[0].device),
                     "v": [state_for(p) for p in ps]}
            if master:
                state["master"] = [
                    f32_copy(p) if place is None else place(f32_copy(p), k)
                    for k, p in zip(leaves, ps)]
        return state

    def update(grads, state, leaves):
        step = state["step"] + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-decay)
        like = _like if place is not None else (lambda old, new: old)

        def direction(g, v):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(g.shape):
                mr, mc = g2.mean(dim=-1), g2.mean(dim=-2)
                vr = beta * like(v["vr"], mr) + (1 - beta) * mr
                vc = beta * like(v["vc"], mc) + (1 - beta) * mc
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = g / torch.sqrt(torch.clamp(r[..., None] * vc[..., None, :],
                                               min=eps))
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta * like(v["v"], g2) + (1 - beta) * g2}
                u = g / torch.sqrt(torch.clamp(nv["v"], min=eps))
            # RMS update clipping, over the whole (stacked) leaf
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            return nv, u / torch.clamp(rms / clip_rms, min=1.0)

        def apply(u, w):
            if place is not None:
                u = placed_like(u, w)
            return w - lr * (u + weight_decay * w)

        with torch.no_grad():
            masters = (state["master"] if master else
                       [stacked(p).to(torch.float32)
                        for p in leaves.values()])
            out = []
            for g, v, w in zip(grads.values(), state["v"], masters):
                nv, u = direction(stacked(g), v)
                if place is not None:
                    nv = {k: _stored(x, v[k]) for k, x in nv.items()}
                out.append((nv, apply(u, w)))
            for p, (_, w) in zip(leaves.values(), out):
                if place is not None:
                    write_leaf(p, w)
                elif isinstance(p, list):
                    for i, t_i in enumerate(p):
                        t_i.copy_(w[i])
                else:
                    p.copy_(w)
        new_state = {"step": step, "v": [o[0] for o in out]}
        if master:
            new_state["master"] = [o[1] for o in out]
        return new_state

    return Optimizer(init=init, update=update)
