"""Encoder-decoder backbone (SeamlessM4T-style): a bidirectional encoder over
precomputed frame embeddings (the speech frontend is a stub) and a causal
decoder with cross-attention on the encoder's output.

A port of the JAX package's `models/encdec.py`. The decode cache keeps the
reference's tree: ``kv.{k, v}`` of the decoder's self-attention, stacked
over its layers (n_dec, B, Smax, Hk, hd), and the encoder's ``memory``
(B, Se, d). Cross-attention projects its keys and values from ``memory``
in every step, as the reference does. The decode entry points write the
cache IN PLACE and return it; a slot at position -1 keeps its bits.

The entry points run under `sharding.tp_context` on a model that
`api.distribute` placed on a mesh: the encoder's input carries the
reference's annotation, each attention `layers.Attention`'s, and the
caches made and returned are placed by the rules' `cache_spec`.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.pack import check_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (MLP, Attention, Embedding, RMSNorm,
                                       cache_write, insert_slot, lm_head,
                                       pos_vector, remat, rope_tables)
from repro_torch.models.sharding import pad, place_cache, shard, sharded

# the dry-run's prefill: the long input is the audio side and the decoder
# prefills a short prefix of this many tokens (the reference's constant)
DEC_PREFILL_LEN = 1024


class EncLayer(nn.Module):
    """``ln1``, non-causal ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        self.ln1 = RMSNorm(cfg, device=device)
        self.attn = Attention(cfg, generator, device=device)
        self.ln2 = RMSNorm(cfg, device=device)
        self.mlp = MLP(cfg, generator, device=device)

    def forward(self, x, rot):
        a, _ = self.attn(self.ln1(x), rot, causal=False)
        x = x + a
        return x + self.mlp(self.ln2(x))


class DecLayer(nn.Module):
    """``ln1``, causal ``self_attn``, ``lnx``, ``cross_attn`` on the
    memory, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        self.ln1 = RMSNorm(cfg, device=device)
        self.self_attn = Attention(cfg, generator, device=device)
        self.lnx = RMSNorm(cfg, device=device)
        self.cross_attn = Attention(cfg, generator, device=device)
        self.ln2 = RMSNorm(cfg, device=device)
        self.mlp = MLP(cfg, generator, device=device)

    def forward(self, x, rot, memory, **kw):
        a, cache = self.self_attn(self.ln1(x), rot, **kw)
        x = x + a
        a, _ = self.cross_attn(self.lnx(x), None, kv=memory)
        x = x + a
        return x + self.mlp(self.ln2(x)), cache


class EncDec(nn.Module):
    """Weights drawn from ``generator`` at the reference's scales, on
    ``device`` (``"cuda"`` unless the caller asks for the CPU). Module
    names follow the reference's parameter tree: ``embed``,
    ``enc_layers.<i>``, ``enc_norm``, ``dec_layers.<i>``, ``dec_norm``.
    Every weight is built frozen, for serving; a trainer unfreezes its
    model. With ``cfg.remat`` each encoder and decoder layer is
    checkpointed while grad is enabled."""

    def __init__(self, cfg: ArchConfig, *, generator: torch.Generator,
                 device="cuda"):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDec serves the encdec family, not "
                             f"{cfg.family!r}")
        dev = check_device(device)
        self.cfg = cfg
        self.device = dev
        self.n_dec = cfg.n_dec_layers or cfg.n_layers
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, generator, device=dev)
            for _ in range(cfg.n_enc_layers or cfg.n_layers))
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, generator, device=dev) for _ in range(self.n_dec))
        self.embed = Embedding(cfg, generator, device=dev)
        self.enc_norm = RMSNorm(cfg, device=dev)
        self.dec_norm = RMSNorm(cfg, device=dev)

    def _rope(self, positions):
        return rope_tables(positions, self.cfg.hd, self.cfg.rope_theta)

    def _prompt_rope(self, S: int):
        return self._rope(torch.arange(S, dtype=torch.int32,
                                       device=self.device))

    @sharded
    def encode(self, frames):
        """frames: (B, Se, d) precomputed frontend embeddings -> the memory
        (B, Se, d) in the config's dtype."""
        x = torch.as_tensor(frames, device=self.device).to(
            self.cfg.param_dtype)
        x = shard(x, "batch", "seq", "d_model")
        rot = self._prompt_rope(x.shape[1])
        for layer in self.enc_layers:
            x = remat(self.cfg, layer, x, rot)
        return self.enc_norm(x)

    def _decode_prompt(self, batch, **kw):
        memory = self.encode(batch["frontend"])
        x = self.embed(torch.as_tensor(batch["inputs"], device=self.device))
        rot = self._prompt_rope(x.shape[1])
        caches = []
        for layer in self.dec_layers:
            x, c = remat(self.cfg, layer, x, rot, memory, **kw)
            caches.append(c)
        return self.dec_norm(x), memory, caches

    @sharded
    def forward(self, batch):
        """batch: ``frontend`` (B, Se, d), ``inputs`` (B, S). Returns
        (float32 logits over the token positions, aux = 0)."""
        x, _, _ = self._decode_prompt(batch)
        return lm_head(self.embed, x), torch.zeros((), device=self.device)

    @sharded
    def prefill(self, batch, max_seq: int | None = None):
        """Returns (last-position logits (B, 1, vocab), {``kv``: the
        decoder's K/V padded with zeros to ``max_seq``, ``memory``}, next
        pos)."""
        x, memory, caches = self._decode_prompt(batch, return_cache=True)
        S = x.shape[1]
        widths = (0, 0, 0, 0, 0, max(0, (max_seq or S) - S))
        kv = {n: pad(torch.stack([c[n] for c in caches]), widths)
              for n in ("k", "v")}
        return (lm_head(self.embed, x[:, -1:, :]),
                place_cache(self, {"kv": kv, "memory": memory}), S)

    @sharded
    def decode_hidden(self, caches, token, pos):
        """One decoder step up to and including the final norm: the
        (B, 1, d) hidden states an LM head consumes. ``pos`` a scalar or a
        (B,) vector of per-slot positions (-1: inactive slot, no cache
        write). ``caches`` is written in place and returned."""
        token = torch.as_tensor(token, device=self.device)
        x = self.embed(token)
        B = token.shape[0]
        pos = pos_vector(pos, B, self.device)
        kv, memory = caches["kv"], caches["memory"]
        rot = self._rope(pos[:, None])
        write = cache_write(pos, B, 1, kv["k"].shape[2], self.device)
        for i, layer in enumerate(self.dec_layers):
            x, _ = layer(x, rot, memory,
                         kv_cache={n: c[i] for n, c in kv.items()},
                         write=write)
        return self.dec_norm(x), caches

    @sharded
    def decode_step(self, caches, token, pos):
        """``lm_head`` of `decode_hidden`: (float32 logits (B, 1, vocab),
        caches)."""
        x, caches = self.decode_hidden(caches, token, pos)
        return lm_head(self.embed, x), caches

    def make_decode_cache(self, batch: int, seq_len: int, dtype=None):
        """Zeroed cache on the model's device: the K/V lines in ``dtype``
        (default: the config's), a memory of ``n_frontend_tokens`` frames
        in the config's dtype."""
        cfg = self.cfg
        shape = (self.n_dec, batch, seq_len, cfg.n_kv_heads, cfg.hd)
        return place_cache(self, {
            "kv": {n: torch.zeros(shape, dtype=dtype or cfg.param_dtype,
                                  device=self.device) for n in ("k", "v")},
            "memory": torch.zeros((batch, cfg.n_frontend_tokens,
                                   cfg.d_model), dtype=cfg.param_dtype,
                                  device=self.device)})

    @staticmethod
    def cache_insert_slot(pool, req, slot: int):
        """Write a batch-size-1 cache ``req`` into batch slot ``slot`` of
        ``pool``, in place; returns ``pool``. The K/V lines carry the
        batch on axis 1, the memory on axis 0."""
        for n in pool["kv"]:
            insert_slot(pool["kv"][n], req["kv"][n], slot, 1)
        insert_slot(pool["memory"], req["memory"], slot, 0)
        return pool
