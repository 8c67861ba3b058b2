"""Decoder-only LM backbone (llama-style): the dense, moe and vlm families.

A port of the JAX package's `models/transformer.py`. The reference stacks
its layers and drives them with `lax.scan`; here each layer is its own
module in an `nn.ModuleList`, run by a Python loop. The KV cache keeps the
reference's stacked layout, ``{k, v}`` of (n_layers, B, Smax, Hk, hd), and
the decode entry points write it IN PLACE (layer l works on the views
``cache["k"][l]``, ``cache["v"][l]``) and return the same dict, where the
reference returns a new cache.

The entry points run under `sharding.tp_context` on a model that
`api.distribute` placed on a mesh (`sharding.sharded`); there the caches
they make and return are placed by the rules' `cache_spec`.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.pack import check_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (MLP, Attention, Embedding, RMSNorm,
                                       cache_write, insert_slot, lm_head,
                                       pos_vector, remat, rope_tables)
from repro_torch.models.moe import MoE
from repro_torch.models.sharding import pad, place_cache, shard, sharded


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg, device=device)
        self.attn = Attention(cfg, generator, device=device)
        self.ln2 = RMSNorm(cfg, device=device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, generator, device=device)
        else:
            self.mlp = MLP(cfg, generator, device=device)

    def forward(self, x, rot, kv_cache=None, write=None,
                return_cache=False):
        attn_out, new_cache = self.attn(
            self.ln1(x), rot, kv_cache=kv_cache, write=write,
            return_cache=return_cache)
        x = x + attn_out
        h = self.ln2(x)
        if self.cfg.family == "moe":
            ff, aux = self.moe(h)
        else:
            ff, aux = self.mlp(h), 0.0
        return x + ff, aux, new_cache


class Transformer(nn.Module):
    """Weights drawn from ``generator`` at the reference's scales (dense
    1/sqrt(fan_in), embedding std 0.02), on ``device`` (``"cuda"`` unless
    the caller asks for the CPU; a CUDA request without a card raises).
    Module names follow the reference's parameter tree: ``embed.tok``
    (``embed.head`` when untied), ``layers.<i>.{ln1,attn,ln2,mlp|moe}``,
    ``final_norm``. Every weight is built frozen, for serving; a trainer
    unfreezes its model. With ``cfg.remat`` each layer of `forward_hidden`
    is checkpointed while grad is enabled."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"Transformer serves the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        dev = check_device(device)
        self.cfg = cfg
        self.device = dev
        self.embed = Embedding(cfg, generator, device=dev)
        self.layers = nn.ModuleList(Block(cfg, generator, device=dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, device=dev)

    def _embed_inputs(self, batch):
        """Token embedding, with the vlm family's frontend-stub embeddings
        (precomputed patch embeddings (B, P, d)) prepended."""
        x = self.embed(torch.as_tensor(batch["inputs"], device=self.device))
        if self.cfg.family == "vlm" and "frontend" in batch:
            fe = torch.as_tensor(batch["frontend"], device=self.device)
            fe = shard(fe.to(x.dtype), "batch", "seq", "d_model")
            x = torch.cat([fe, x], dim=1)
        return x

    def _rope(self, positions: torch.Tensor) -> tuple:
        return rope_tables(positions, self.cfg.hd, self.cfg.rope_theta)

    def _prompt_rope(self, S: int) -> tuple:
        """The rotary tables of positions 0..S-1, shared by every row."""
        return self._rope(torch.arange(S, dtype=torch.int32,
                                       device=self.device))

    @sharded
    def forward_hidden(self, batch):
        """(hidden, aux): the (B, S, d_model) LM-head input over the token
        positions (after the final norm); `forward` is
        ``lm_head(embed, hidden)``."""
        x = self._embed_inputs(batch)
        rot = self._prompt_rope(x.shape[1])
        aux = torch.zeros((), device=self.device)
        for layer in self.layers:
            x, a, _ = remat(self.cfg, layer, x, rot)
            aux = aux + a
        x = self.final_norm(x)
        if self.cfg.family == "vlm" and "frontend" in batch:
            x = x[:, batch["frontend"].shape[1]:, :]   # text positions only
        return x, aux

    @sharded
    def forward(self, batch):
        """Returns (float32 logits over the token positions, aux)."""
        x, aux = self.forward_hidden(batch)
        return lm_head(self.embed, x), aux

    @sharded
    def prefill(self, batch, max_seq: int | None = None):
        """Returns (last-position logits (B, 1, vocab), cache, next pos);
        the cache is padded with zeros to ``max_seq`` along its sequence
        dimension."""
        x = self._embed_inputs(batch)
        S = x.shape[1]
        rot = self._prompt_rope(S)
        ks, vs = [], []
        for layer in self.layers:
            x, _, c = layer(x, rot, return_cache=True)
            ks.append(c["k"])
            vs.append(c["v"])
        caches = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if max_seq is not None and max_seq > S:
            caches = {n: pad(c, (0, 0, 0, 0, 0, max_seq - S))
                      for n, c in caches.items()}
        x = self.final_norm(x)
        caches = place_cache(self, caches)
        return lm_head(self.embed, x[:, -1:, :]), caches, S

    @sharded
    def decode_hidden(self, caches, token, pos):
        """One serving step up to and including the final norm: the
        (B, 1, d) hidden states an LM head (dense `lm_head` or a
        compressed `SparseLinear`) consumes. ``token`` (B, 1) int; ``pos``
        a scalar write position or a (B,) vector of per-slot positions
        (-1: inactive slot, no cache write). ``caches`` is written in
        place and returned. What depends on the positions alone (the
        rotary tables, the write rows, the key mask) is computed once here
        for all the layers."""
        token = torch.as_tensor(token, device=self.device)
        x = self.embed(token)
        B = token.shape[0]
        pos = pos_vector(pos, B, self.device)
        rot = self._rope(pos[:, None])
        write = cache_write(pos, B, 1, caches["k"].shape[2], self.device)
        for i, layer in enumerate(self.layers):
            x, _, _ = layer(x, rot,
                            kv_cache={"k": caches["k"][i],
                                      "v": caches["v"][i]},
                            write=write)
        return self.final_norm(x), caches

    @sharded
    def decode_step(self, caches, token, pos):
        """``lm_head`` of `decode_hidden`: (float32 logits (B, 1, vocab),
        caches)."""
        x, caches = self.decode_hidden(caches, token, pos)
        return lm_head(self.embed, x), caches

    def make_decode_cache(self, batch: int, seq_len: int, dtype=None):
        """Zeroed stacked KV cache on the model's device (default dtype:
        the config's)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.hd)
        dtype = dtype or cfg.param_dtype
        return place_cache(self, {n: torch.zeros(shape, dtype=dtype,
                                                 device=self.device)
                                  for n in ("k", "v")})

    @staticmethod
    def cache_insert_slot(pool, req, slot: int):
        """Write a batch-size-1 cache ``req`` (e.g. `prefill`'s, padded to
        the pool's length) into batch slot ``slot`` of ``pool``, in place,
        cast to the pool's dtype; returns ``pool``. A ``req`` as long as
        the pool overwrites the slot's whole line, so no K/V of its
        previous occupant survives."""
        for n, p in pool.items():
            insert_slot(p, req[n], slot, 1)
        return pool
