"""Mamba2 stacks: the ssm family (mamba2, attention-free) and the hybrid
family (Zamba2-style [arXiv:2411.15242]: one shared attention + MLP block
applied every ``attn_every`` SSM layers).

A port of the JAX package's `models/hybrid.py`. The shared block
concatenates the current hidden state with the original embedding
(Zamba's residual trick) and projects it back to d_model before its norm,
attention and MLP, all at d_model. Its weights are stored once; each of
its applications has its own KV line at decode time. Layout: ``n_groups``
groups of ``attn_every`` SSM layers, the shared block after each group,
then the ``n_tail`` remaining SSM layers (`_plan`). The reference scans
each group; here a Python loop runs the layers.

The decode cache keeps the reference's tree: ``ssm.{conv, state}`` stacked
over the layers (L, B, ...), the pass-through ``x0`` (B, 1, d) and, with
groups, ``attn.{k, v}`` of (n_groups, B, Smax, Hk, hd). The decode entry
points write it IN PLACE and return it; a slot at position -1 keeps the
bits of every line.

The entry points run under `sharding.tp_context` on a model that
`api.distribute` placed on a mesh; the shared block's attention carries
`layers.Attention`'s annotations, and the caches made and returned are
placed by the rules' `cache_spec`.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.pack import check_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (MLP, Attention, Embedding, RMSNorm,
                                       _dense_init, cache_write, insert_slot,
                                       lm_head, matmul, pos_vector, remat,
                                       rope_tables)
from repro_torch.models.sharding import pad, place_cache, sharded
from repro_torch.models.ssm import SSM, ssm_cache_init


def _plan(cfg: ArchConfig) -> tuple[int, int, int]:
    """(attn_every, n_groups, n_tail); the ssm family has no group."""
    every = cfg.attn_every or cfg.n_layers + 1
    n_groups = cfg.n_layers // every
    return every, n_groups, cfg.n_layers - n_groups * every


class SSMLayer(nn.Module):
    """Pre-norm residual Mamba2 block: ``ln``, ``ssm``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        self.ln = RMSNorm(cfg, device=device)
        self.ssm = SSM(cfg, generator, device=device)

    def forward(self, x, **kw):
        out, cache = self.ssm(self.ln(x), **kw)
        return x + out, cache


class SharedBlock(nn.Module):
    """``in_proj`` (2 d, d) over ``[x, x0]``, then ``ln1``, causal
    ``attn``, ``ln2``, ``mlp`` at d_model."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        d = cfg.d_model
        self.in_proj = _dense_init(generator, (2 * d, d), cfg.param_dtype,
                                   device)
        self.ln1 = RMSNorm(cfg, device=device)
        self.attn = Attention(cfg, generator, device=device)
        self.ln2 = RMSNorm(cfg, device=device)
        self.mlp = MLP(cfg, generator, device=device)

    def forward(self, x, x0, rot, **kw):
        h = self.ln1(matmul(torch.cat([x, x0], dim=-1), self.in_proj))
        attn_out, cache = self.attn(h, rot, **kw)
        x = x + attn_out
        return x + self.mlp(self.ln2(x)), cache


class Hybrid(nn.Module):
    """Weights drawn from ``generator`` at the reference's scales, on
    ``device`` (``"cuda"`` unless the caller asks for the CPU). Module
    names follow the reference's parameter tree: ``embed``,
    ``layers.<i>.{ln,ssm}``, ``final_norm`` and, for the hybrid family,
    ``shared_attn.{in_proj,ln1,attn,ln2,mlp}``. Every weight is built
    frozen, for serving; a trainer unfreezes its model. With ``cfg.remat``
    each SSM layer is checkpointed while grad is enabled (the shared block
    is not, as in the reference)."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        if cfg.family not in ("ssm", "hybrid"):
            raise ValueError(f"Hybrid serves the ssm and hybrid families, "
                             f"not {cfg.family!r}")
        dev = check_device(device)
        self.cfg = cfg
        self.device = dev
        self.embed = Embedding(cfg, generator, device=dev)
        self.layers = nn.ModuleList(SSMLayer(cfg, generator, device=dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, device=dev)
        self.shared_attn = SharedBlock(cfg, generator, device=dev) \
            if cfg.attn_every else None

    def _run(self, x, rot, *, ssm_kw, attn_kw):
        """The layers in `_plan`'s order: ``ssm_kw(i)`` and ``attn_kw(g)``
        give the keywords of SSM layer i and of the shared block's g-th
        application; returns (x, the layers' caches, the applications')."""
        every, n_groups, _ = _plan(self.cfg)
        x0 = x
        ssm_caches, attn_caches = [], []
        for i, layer in enumerate(self.layers):
            x, c = remat(self.cfg, layer, x, **ssm_kw(i))
            ssm_caches.append(c)
            g = i // every
            if g < n_groups and i % every == every - 1:
                x, c = self.shared_attn(x, x0, rot, **attn_kw(g))
                attn_caches.append(c)
        return x, ssm_caches, attn_caches

    def _prompt_rope(self, S: int):
        """The shared block's rotary tables of positions 0..S-1 (None
        without a shared block)."""
        if self.shared_attn is None:
            return None
        pos = torch.arange(S, dtype=torch.int32, device=self.device)
        return rope_tables(pos, self.cfg.hd, self.cfg.rope_theta)

    @sharded
    def forward(self, batch):
        """Returns (float32 logits over the token positions, aux = 0)."""
        x = self.embed(torch.as_tensor(batch["inputs"], device=self.device))
        x, _, _ = self._run(x, self._prompt_rope(x.shape[1]),
                            ssm_kw=lambda i: {}, attn_kw=lambda g: {})
        return (lm_head(self.embed, self.final_norm(x)),
                torch.zeros((), device=self.device))

    @sharded
    def prefill(self, batch, max_seq: int | None = None):
        """Returns (last-position logits (B, 1, vocab), cache, next pos):
        every layer's final SSD state and conv tail, a zero ``x0`` and
        each application's K/V, padded with zeros to ``max_seq``."""
        x = self.embed(torch.as_tensor(batch["inputs"], device=self.device))
        B, S, _ = x.shape
        x, ssm_c, attn_c = self._run(
            x, self._prompt_rope(S),
            ssm_kw=lambda i: {"return_cache": True},
            attn_kw=lambda g: {"return_cache": True})
        caches = {"ssm": {n: torch.stack([c[n] for c in ssm_c])
                          for n in ("conv", "state")},
                  "x0": torch.zeros((B, 1, self.cfg.d_model),
                                    dtype=self.cfg.param_dtype,
                                    device=self.device)}
        if attn_c:
            widths = (0, 0, 0, 0, 0, max(0, (max_seq or S) - S))
            caches["attn"] = {n: pad(
                torch.stack([c[n] for c in attn_c]), widths)
                for n in ("k", "v")}
        x = self.final_norm(x)
        caches = place_cache(self, caches)
        return lm_head(self.embed, x[:, -1:, :]), caches, S

    @sharded
    def decode_hidden(self, caches, token, pos):
        """One serving step up to and including the final norm: the
        (B, 1, d) hidden states an LM head consumes. ``pos`` a scalar or a
        (B,) vector of per-slot positions; -1 marks an inactive slot,
        whose SSM state, conv tail and KV lines keep their bits.
        ``caches`` is written in place and returned."""
        token = torch.as_tensor(token, device=self.device)
        x = self.embed(token)
        B = token.shape[0]
        pos = pos_vector(pos, B, self.device)
        active = pos >= 0
        ssm, attn = caches["ssm"], caches.get("attn")
        rot = write = None
        if attn is not None:
            rot = rope_tables(pos[:, None], self.cfg.hd, self.cfg.rope_theta)
            write = cache_write(pos, B, 1, attn["k"].shape[2], self.device)
        x, _, _ = self._run(
            x, rot,
            ssm_kw=lambda i: {"cache": {n: c[i] for n, c in ssm.items()},
                              "active": active},
            attn_kw=lambda g: {"kv_cache": {n: c[g] for n, c in
                                            attn.items()},
                               "write": write})
        return self.final_norm(x), caches

    @sharded
    def decode_step(self, caches, token, pos):
        """``lm_head`` of `decode_hidden`: (float32 logits (B, 1, vocab),
        caches)."""
        x, caches = self.decode_hidden(caches, token, pos)
        return lm_head(self.embed, x), caches

    def make_decode_cache(self, batch: int, seq_len: int, dtype=None):
        """Zeroed cache on the model's device: the SSM lines in
        `ssm_cache_init`'s dtypes, ``x0`` in the config's, the KV lines in
        ``dtype`` (default: the config's)."""
        cfg = self.cfg
        _, n_groups, _ = _plan(cfg)
        one = ssm_cache_init(cfg, batch, device=self.device)
        out = {"ssm": {n: c.expand((cfg.n_layers,) + c.shape).contiguous()
                       for n, c in one.items()},
               "x0": torch.zeros((batch, 1, cfg.d_model),
                                 dtype=cfg.param_dtype, device=self.device)}
        if n_groups:
            shape = (n_groups, batch, seq_len, cfg.n_kv_heads, cfg.hd)
            out["attn"] = {n: torch.zeros(shape,
                                          dtype=dtype or cfg.param_dtype,
                                          device=self.device)
                           for n in ("k", "v")}
        return place_cache(self, out)

    @staticmethod
    def cache_insert_slot(pool, req, slot: int):
        """Write a batch-size-1 cache ``req`` into batch slot ``slot`` of
        ``pool``, in place; returns ``pool``. The SSM and KV lines carry
        the batch on axis 1, ``x0`` on axis 0. Every line of the slot is
        overwritten, so no state of its previous occupant survives."""
        for n in pool["ssm"]:
            insert_slot(pool["ssm"][n], req["ssm"][n], slot, 1)
        insert_slot(pool["x0"], req["x0"], slot, 0)
        for n in pool.get("attn", {}):
            insert_slot(pool["attn"][n], req["attn"][n], slot, 1)
        return pool
