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
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import Optimizer, f32_copy
from repro_torch.optim.tree import stacked


def adafactor(lr: float, decay: float = 0.8, eps: float = 1e-30,
              clip_rms: float = 1.0, weight_decay: float = 0.0,
              master: bool = True) -> Optimizer:
    """master=False drops the fp32 master copy (updates are applied in the
    parameters' own dtype), saving 4 bytes a parameter."""
    def _factored(shape):
        return len(shape) >= 2

    def init(leaves):
        def state_for(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        with torch.no_grad():
            ps = [stacked(p) for p in leaves.values()]
            state = {"step": torch.zeros((), dtype=torch.int32,
                                         device=ps[0].device),
                     "v": [state_for(p) for p in ps]}
            if master:
                state["master"] = [f32_copy(p) for p in ps]
        return state

    def update(grads, state, leaves):
        step = state["step"] + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-decay)

        def upd(g, v, w):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(g.shape):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = g / torch.sqrt(torch.clamp(r[..., None] * vc[..., None, :],
                                               min=eps))
                nv = {"vr": vr, "vc": vc}
            else:
                nv = {"v": beta * v["v"] + (1 - beta) * g2}
                u = g / torch.sqrt(torch.clamp(nv["v"], min=eps))
            # RMS update clipping, over the whole (stacked) leaf
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_rms, min=1.0)
            return nv, w - lr * (u + weight_decay * w)

        with torch.no_grad():
            masters = (state["master"] if master else
                       [stacked(p).to(torch.float32)
                        for p in leaves.values()])
            out = [upd(stacked(g), v, w) for g, v, w in zip(
                grads.values(), state["v"], masters)]
            for p, (_, w) in zip(leaves.values(), out):
                if isinstance(p, list):
                    for i, t_i in enumerate(p):
                        t_i.copy_(w[i])
                else:
                    p.copy_(w)
        new_state = {"step": step, "v": [o[0] for o in out]}
        if master:
            new_state["master"] = [o[1] for o in out]
        return new_state

    return Optimizer(init=init, update=update)
