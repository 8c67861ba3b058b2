"""Shared layers: RMSNorm, RoPE, GQA attention, SwiGLU / GELU MLP, embedding.

A port of the JAX package's `models/layers.py`. Weights keep the
reference's layout and names (a projection is ``(d_in, d_out)``, applied
as ``x @ w``), so `repro_torch.convert.model_from_jax_params` copies them
across leaf by leaf. Products accumulate in float32 and are cast back to
the activation dtype, as the reference's ``preferred_element_type``
does; where JAX promotes mixed dtypes silently (bfloat16 weights against
a float32 cache), the operands are cast to float32 here.

Masks use ``-1e30``, never ``-inf``: a slot whose every key is masked
(position -1, an empty serving slot) then gets a uniform softmax and
finite values, not NaN, which would reach its column of the compressed
head's product.

Activations carry the reference's logical-axis annotations (`shard`) at
its own sites: q, k, v after their reshape, the attention and MLP
outputs, the MLP's hidden, the embedding and the logits. They are the
identity on a model that was not distributed (`api.distribute`); on a
distributed one they place each activation as the reference's
``with_sharding_constraint`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import (insert_local, is_dtensor,
                                         local_heads, local_like,
                                         local_offset, merge_dims, pad,
                                         rewrap, shard, split_dim,
                                         whole_along)

NEG = -1e30                 # the reference's masking constant


def _dense_init(generator: torch.Generator | None, shape, dtype, device,
                scale=None) -> nn.Parameter:
    """Normal weights of std ``scale`` (default 1/sqrt(fan_in)), drawn in
    float32 from ``generator`` and cast to ``dtype``; frozen, since the
    serving path takes no gradients (a trainer unfreezes its own model with
    ``requires_grad_(True)``). Without a generator (the shape-only build
    of `api.build_model` on the meta device) nothing is drawn."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                            requires_grad=False)
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    return nn.Parameter(w.to(device=device, dtype=dtype),
                        requires_grad=False)


def remat(cfg: ArchConfig, fn, *args, **kw):
    """``fn(*args, **kw)``, its activations recomputed in the backward where
    ``cfg.remat`` is set and grad is enabled: the reference's
    ``jax.checkpoint`` around a layer. Without grad (serving) it is a plain
    call."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)
    return fn(*args, **kw)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in float32, in x's dtype."""
    if x.dtype == w.dtype:
        return x @ w
    return (_f32(x) @ _f32(w)).to(x.dtype)


# --- RMSNorm ----------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = _f32(x)
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * _f32(scale)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.param_dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


# --- RoPE -------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, hd: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotary angles at ``positions`` (..., S), float32,
    shaped (..., S, 1, hd // 2) to broadcast over heads. A model computes
    them once per call and hands them to every layer."""
    half = hd // 2
    freq = (1.0 / theta) ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half)
    ang = _f32(positions)[..., None] * freq          # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, rot: tuple) -> torch.Tensor:
    """x: (..., S, H, hd) rotated by ``rot = (cos, sin)`` of
    `rope_tables`: the two halves of each head (not interleaved pairs), in
    float32."""
    cos, sin = rot
    half = x.shape[-1] // 2
    x1, x2 = _f32(x[..., :half]), _f32(x[..., half:])
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


def pos_vector(pos, batch: int, device) -> torch.Tensor:
    """A decode position as a per-slot (B,) int32 vector on ``device``: a
    scalar broadcasts to every row, a (B,) vector passes through. Entry -1
    marks an inactive slot: attention skips its cache write and masks out
    every key."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return p.expand(batch) if p.ndim == 0 else p


# --- GQA attention ------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, hk, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, hk, n_rep, hd).reshape(
        b, s, hk * n_rep, hd)


class CacheWrite(NamedTuple):
    """Where a decode step writes its K/V and which keys it attends, from
    its write position; computed once a step (`cache_write`) and shared by
    every layer."""
    rows: torch.Tensor          # scalar form: the (S,) cache rows written;
    #                             per-slot: each slot's (B,) clamped row
    slots: torch.Tensor | None  # per-slot: arange(B); None: scalar form
    hit: torch.Tensor | None    # per-slot: (B, 1, 1), False where the
    #                             position lies outside [0, Smax)
    keys: torch.Tensor          # (B or 1, 1, 1, 1, Smax): keys attended


def cache_write(cache_pos, B: int, S: int, Smax: int,
                device) -> CacheWrite:
    """The `CacheWrite` of ``cache_pos`` into a (B, Smax) cache. A scalar
    writes the S rows from ``cache_pos`` (clamped so they fit, as
    `dynamic_update_slice` clamps) and every query attends keys
    ``<= cache_pos``. A (B,) vector (S == 1) writes row b at
    ``cache_pos[b]`` and slot b attends keys ``<= cache_pos[b]``; a
    position outside ``[0, Smax)`` (-1: an inactive slot) writes nothing
    and attends nothing. Neither form reads the positions on the host."""
    cp = torch.as_tensor(cache_pos, dtype=torch.int32, device=device)
    kpos = torch.arange(Smax, dtype=torch.int32, device=device)
    if cp.ndim == 0:
        rows = cp.clamp(0, Smax - S) + torch.arange(S, device=device)
        return CacheWrite(rows, None, None,
                          (kpos <= cp)[None, None, None, None, :])
    return CacheWrite(cp.clamp(0, Smax - 1).long(),
                      torch.arange(B, device=device),
                      ((cp >= 0) & (cp < Smax))[:, None, None],
                      (kpos[None, :] <= cp[:, None])[:, None, None, None, :])


def _write_cache(cache: torch.Tensor, new: torch.Tensor,
                 w: CacheWrite) -> None:
    """Write ``new`` (B, S, Hk, hd) into ``cache`` (B, Smax, Hk, hd) in
    place at ``w``; a slot that misses reads its row at the clamped
    position and writes it back unchanged, so its line keeps its bits."""
    new = new.to(cache.dtype)
    if is_dtensor(cache):
        _write_local(cache, new, w)
        return
    if w.slots is None:
        cache.index_copy_(1, w.rows, new)
        return
    at = (w.slots, w.rows)
    cache[at] = torch.where(w.hit, new[:, 0], cache[at])


def _write_local(cache, new, w: CacheWrite) -> None:
    """`_write_cache` into a DTensor cache: each rank writes its own block
    in place. ``new`` comes in the cache's placements but whole along the
    sequence, and a row is written by the rank whose block of the
    sequence holds its position (a head-sharded cache: every rank, its
    own heads; a sequence-sharded one: the rank that owns the row)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in cache.placements]
    c = cache.to_local()
    n = local_like(new, cache, pl)
    b0, s0 = local_offset(cache, 0), local_offset(cache, 1)
    Bl, Sl = c.shape[0], c.shape[1]
    if w.slots is None:
        if Sl == cache.shape[1]:
            c.index_copy_(1, w.rows, n)
            return
        for j, row in enumerate(w.rows - s0):
            hit = (row >= 0) & (row < Sl)
            r = row.clamp(0, Sl - 1)
            c[:, r] = torch.where(hit, n[:, j], c[:, r])
        return
    rows = w.rows[b0:b0 + Bl] - s0
    hit = w.hit[b0:b0 + Bl] & ((rows >= 0) & (rows < Sl))[:, None, None]
    at = (torch.arange(Bl, device=c.device), rows.clamp(0, Sl - 1))
    c[at] = torch.where(hit, n[:, 0], c[at])


class Attention(nn.Module):
    """GQA attention; weights ``wq``, ``wk``, ``wv`` (d, heads x hd) and
    ``wo`` (H x hd, d). Causal self-attention by default; ``causal=False``
    (an encoder) drops the mask, and ``kv=`` (cross-attention) takes keys
    and values from another sequence, unrotated and unmasked."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        self.cfg = cfg
        d, hd, dt = cfg.d_model, cfg.hd, cfg.param_dtype
        self.H, self.Hk = cfg.n_heads, cfg.n_kv_heads
        self.wq = _dense_init(generator, (d, self.H * hd), dt, device)
        self.wk = _dense_init(generator, (d, self.Hk * hd), dt, device)
        self.wv = _dense_init(generator, (d, self.Hk * hd), dt, device)
        self.wo = _dense_init(generator, (self.H * hd, d), dt, device)

    def forward(self, x, rot, *, causal=True, kv=None, kv_cache=None,
                write=None, return_cache=False):
        """x: (B, S, d); ``rot``: `rope_tables` of the positions of x, for
        queries and keys alike (the reference rotates a cached step's
        keys at ``cache_pos``, which its callers set to those positions).

        ``kv``: cross-attention memory (B, Sk, d); its keys and values are
        projected from it, neither q nor k is rotated (``rot`` is unused)
        and no key is masked, as in the reference (``causal and kv is
        None``).

        ``kv_cache``: optional dict {k, v: (B, Smax, Hk, hd)}, written IN
        PLACE at ``write`` (a `CacheWrite`; the step attends the keys it
        names) and returned as the new cache; the reference returns a
        fresh cache instead. ``return_cache=True`` (prefill) returns this
        call's {k, v}. Returns (out, cache or None)."""
        H, Hk, hd = self.H, self.Hk, self.cfg.hd
        B, S, _ = x.shape
        src = x if kv is None else kv
        q = split_dim(matmul(x, self.wq), -1, H, hd)
        k = split_dim(matmul(src, self.wk), -1, Hk, hd)
        v = split_dim(matmul(src, self.wv), -1, Hk, hd)
        q = shard(q, "batch", "seq", "heads", None)
        k = shard(k, "batch", "seq", "kv_heads", None)
        v = shard(v, "batch", "seq", "kv_heads", None)
        if kv is None:                   # self-attention: rotary embedding
            q, k = apply_rope(q, rot), apply_rope(k, rot)
        causal = causal and kv is None

        new_cache = {"k": k, "v": v} if return_cache else None
        if kv_cache is not None:
            _write_cache(kv_cache["k"], k, write)
            _write_cache(kv_cache["v"], v, write)
            new_cache = kv_cache
            k, v = kv_cache["k"], kv_cache["v"]

        keys = write.keys if kv_cache is not None else None
        kw = dict(decode=kv_cache is not None, causal=causal, dtype=x.dtype)
        local = local_heads(q, k, v)
        if local is None:
            out = _attend(q, k, v, keys, **kw)
        else:
            # each rank attends with its own heads (and batch rows)
            if keys is not None and keys.shape[0] > 1:
                b0 = local_offset(q, 0)
                keys = keys[b0:b0 + local[0].shape[0]]
            out = rewrap(_attend(*local, keys, **kw), q)
        out = matmul(merge_dims(out, 2), self.wo)
        return shard(out, "batch", "seq", "d_model"), new_cache


def _attend(q, k, v, keys, *, decode: bool, causal: bool, dtype):
    """Attention of q (B, S, H, hd) over k, v (B, Sk, Hk, hd), GQA: against
    a decode cache (``decode``: grouped, no head-replicated K/V, the keys
    ``keys`` attended), blocked with an online softmax past
    `FLASH_THRESHOLD` queries, else dense (``causal``: each query the keys
    up to its own position). Returns (B, S, H, hd) in ``dtype``."""
    B, S, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    n_rep = H // Hk
    scale = 1.0 / math.sqrt(hd)
    if decode:
        qg = split_dim(q, 2, Hk, n_rep)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", _f32(qg),
                              _f32(k)) * scale
        logits = torch.where(keys, logits, NEG)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bqgrd",
                           _f32(probs.to(dtype)), _f32(v))
        return out.to(dtype).reshape(B, S, H, hd)
    if S > FLASH_THRESHOLD:
        return _flash_attention(q, _repeat_kv(k, n_rep),
                                _repeat_kv(v, n_rep), causal=causal)
    kf, vf = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", _f32(q), _f32(kf)) * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where((ki <= qi)[None, None], logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, _f32(vf)).to(dtype)


FLASH_THRESHOLD = 2048   # above this, use blocked attention
FLASH_BLOCK_Q = 2048
FLASH_BLOCK_K = 1024


def _flash_attention(q, k, v, *, causal, block_q=None, block_k=None):
    """Blocked attention with online softmax: q (B, Sq, H, hd); k, v
    (B, Sk, H, hd). Peak memory per step is O(block_q x block_k), as in
    the reference's `_flash_attention`, whose arithmetic this repeats:
    products accumulate in float32, the probability block is cast to v's
    dtype for the PV product, padded keys and (with ``causal``) later
    keys are masked with -1e30."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    bq = min(block_q or FLASH_BLOCK_Q, Sq)
    bk = min(block_k or FLASH_BLOCK_K, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qb = pad(q, (0, 0, 0, 0, 0, nq * bq - Sq))
    kb = pad(k, (0, 0, 0, 0, 0, nk * bk - Sk))
    vb = pad(v, (0, 0, 0, 0, 0, nk * bk - Sk))
    qb = qb.reshape(B, nq, bq, H, hd).permute(1, 0, 3, 2, 4)
    kb = kb.reshape(B, nk, bk, H, hd).permute(1, 0, 3, 2, 4)
    vb = vb.reshape(B, nk, bk, H, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qpos = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), -math.inf, dtype=torch.float32,
                       device=dev)
        s = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            logits = torch.einsum("bhqd,bhkd->bhqk", _f32(qb[qi]),
                                  _f32(kb[ki])) * scale
            kpos = ki * bk + torch.arange(bk, device=dev)
            mask = (kpos < Sk)[None, :]
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            logits = torch.where(mask[None, None], logits, NEG)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            s = s * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", _f32(p.to(vb.dtype)), _f32(vb[ki]))
            m = m_new
        outs.append(acc / torch.clamp(s[..., None], min=1e-30))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, nq * bq, H, hd)
    return out[:, :Sq].to(q.dtype)


# --- SwiGLU / GELU MLP ----------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``wi``, ``wg``, ``wo``) or, with ``cfg.mlp_gated`` False,
    the 2-matrix GELU MLP (tanh approximation, as ``jax.nn.gelu``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.wi = _dense_init(generator, (d, ff), dt, device)
        self.wg = _dense_init(generator, (d, ff), dt, device) \
            if cfg.mlp_gated else None
        self.wo = _dense_init(generator, (ff, d), dt, device)

    def forward(self, x):
        if self.wg is not None:
            h = torch.nn.functional.silu(_f32(matmul(x, self.wg))
                                         ).to(x.dtype)
            h = h * matmul(x, self.wi)
        else:
            h = torch.nn.functional.gelu(_f32(matmul(x, self.wi)),
                                         approximate="tanh").to(x.dtype)
        h = shard(h, "batch", "seq", "ff")
        return shard(matmul(h, self.wo), "batch", "seq", "d_model")


# --- Embedding / LM head --------------------------------------------------------

class Embedding(nn.Module):
    """``tok`` (vocab, d), std 0.02; an untied config adds ``head``
    (d, vocab)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        dt = cfg.param_dtype
        self.tok = _dense_init(generator, (cfg.vocab, cfg.d_model), dt,
                               device, scale=0.02)
        self.head = None if cfg.tie_embeddings else _dense_init(
            generator, (cfg.d_model, cfg.vocab), dt, device)

    def forward(self, tokens):
        """The rows of ``tok``: ``tok[tokens]``, and on a DTensor table
        `F.embedding`, which keeps a vocab-sharded table sharded (each
        rank looks up its own rows) where the indexing would gather it
        whole. A table whose d_model is sharded too (FSDP over ``"data"``)
        is gathered along it first; its vocab stays sharded. A plain table
        keeps the indexing: `F.embedding`'s gradient adds up repeated rows
        in another order."""
        out = (torch.nn.functional.embedding(tokens,
                                             whole_along(self.tok, 1))
               if is_dtensor(self.tok) else self.tok[tokens])
        return shard(out, "batch", "seq", "d_model")

    def head_weight(self) -> torch.Tensor:
        """The LM head as (d, vocab): ``head``, or ``tok.T`` when tied."""
        return self.head if self.head is not None else self.tok.T


def lm_head(embedding: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (the reference's ``preferred_element_type``)."""
    logits = _f32(x) @ _f32(embedding.head_weight())
    return shard(logits, "batch", "seq", "vocab")


# --- pooled caches -----------------------------------------------------------

def insert_slot(pool: torch.Tensor, req: torch.Tensor, slot: int,
                axis: int) -> None:
    """Write ``req`` (batch size 1 on ``axis``) into batch slot ``slot`` of
    ``pool``, in place and cast to the pool's dtype, at offset 0 on every
    other axis (`dynamic_update_slice_in_dim`'s semantics); a DTensor
    pool is written shard by shard (`sharding.insert_local`)."""
    if is_dtensor(pool):
        insert_local(pool, req, slot, axis)
        return
    at = tuple(slice(0, n) for n in req.shape)
    at = at[:axis] + (slice(slot, slot + req.shape[axis]),) + at[axis + 1:]
    pool[at] = req.to(pool.dtype)
