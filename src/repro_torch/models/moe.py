"""Mixture-of-Experts block: top-k routing with per-expert capacity.

A port of the JAX package's `models/moe.py`, with the same routing,
capacity, drops and load-balance loss (Switch Transformer eq. 4). Each
assignment's rank within its expert comes from one cumsum over the
(T*K, E) one-hot routing matrix (the reference scans it in chunks of
65536 assignments to bound TPU memory; the ranks are the same).
Assignments past an expert's capacity are dropped: they all land on the
dump slot ``E * capacity``, which is discarded, and their gate weight
becomes 0 (the kept weights are not renormalized).

The reference's annotations sit at its sites: the dispatched ``xe`` and
the experts' ``ye`` on ("experts", "moe_capacity", "d_model") (a launcher
maps one of the two to the model axis), the gathered rows batch-major and
the output on ("batch", "seq", "d_model").
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dense_init, _f32
from repro_torch.models.sharding import merge_dims, shard, split_dim


class MoE(nn.Module):
    """``router`` (d, E) in float32; ``wi``, ``wg`` (E, d, d_ff) and
    ``wo`` (E, d_ff, d) in the config's dtype."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        self.cfg = cfg
        E, d, ff, dt = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.router = _dense_init(generator, (d, E), torch.float32, device)
        self.wi = _dense_init(generator, (E, d, ff), dt, device,
                              scale=1.0 / math.sqrt(d))
        self.wg = _dense_init(generator, (E, d, ff), dt, device,
                              scale=1.0 / math.sqrt(d))
        self.wo = _dense_init(generator, (E, ff, d), dt, device,
                              scale=1.0 / math.sqrt(ff))

    def forward(self, x: torch.Tensor):
        """x: (B, S, d) -> (out (B, S, d), aux_loss ())."""
        cfg = self.cfg
        B, S, d = x.shape
        E, K = cfg.n_experts, cfg.top_k
        T = B * S
        xt = merge_dims(x, 0)

        probs = torch.softmax(_f32(xt) @ self.router, dim=-1)     # (T, E)
        gate_vals, gate_idx = torch.topk(probs, K, dim=-1)        # (T, K)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

        # --- capacity + ranks ---------------------------------------------
        capacity = int(np.ceil(T * K / E * cfg.capacity_factor))
        flat_e = gate_idx.reshape(-1)                             # (T*K,)
        oh = torch.nn.functional.one_hot(flat_e, E)               # (T*K, E)
        within = torch.cumsum(oh, dim=0) - oh
        ranks = within.gather(1, flat_e[:, None])[:, 0]
        keep = ranks < capacity

        # --- dispatch: gather tokens into (E, C, d) -------------------------
        slot = torch.where(keep, flat_e * capacity + ranks, E * capacity)
        tok_ids = torch.arange(T * K, device=x.device) // K
        tok_of_slot = slot.new_zeros(E * capacity + 1, dtype=torch.long)
        tok_of_slot[slot] = tok_ids           # dropped ones hit the dump slot
        xe = xt[tok_of_slot[:-1]].reshape(E, capacity, d)
        xe = shard(xe, "experts", "moe_capacity", "d_model")

        # --- expert computation: float32 accumulation ------------------------
        h = torch.nn.functional.silu(
            torch.einsum("ecd,edf->ecf", _f32(xe), _f32(self.wg))
        ).to(x.dtype)
        h = h * torch.einsum("ecd,edf->ecf", _f32(xe),
                             _f32(self.wi)).to(x.dtype)
        ye = torch.einsum("ecf,efd->ecd", _f32(h),
                          _f32(self.wo)).to(x.dtype)
        ye = shard(ye, "experts", "moe_capacity", "d_model")

        # --- combine: gather back and weight --------------------------------
        flat = ye.reshape(E * capacity, d)
        gathered = flat[slot.clamp(0, E * capacity - 1)]
        gathered = torch.where(keep[:, None], gathered, 0)
        # the combine's rows batch-major (T is B*S flattened)
        gathered = shard(gathered.reshape(T, K, d), "batch", None, None
                         ).reshape(T * K, d)
        w = (gate_vals.reshape(-1) * keep).to(x.dtype)
        out = (gathered.reshape(T, K, d)
               * w.reshape(T, K, 1)).sum(dim=1).to(x.dtype)

        # --- Switch load-balance aux loss -----------------------------------
        me = probs.mean(dim=0)                                    # (E,)
        # kept assignments per expert, by index_add_: `bincount` would
        # read its maximum back to the host, a sync in every decode step
        # (``new_zeros`` of ``probs``: a DTensor where the routing is one)
        ce = probs.new_zeros(E).index_add_(0, flat_e, _f32(keep)) \
            / max(T * K, 1)
        aux = E * torch.sum(me * ce)
        return shard(split_dim(out, 0, B, S), "batch", "seq", "d_model"), \
            aux
