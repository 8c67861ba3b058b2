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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models.config import ArchConfig

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
    if w.slots is None:
        cache.index_copy_(1, w.rows, new)
        return
    at = (w.slots, w.rows)
    cache[at] = torch.where(w.hit, new[:, 0], cache[at])


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
        q = matmul(x, self.wq).reshape(B, S, H, hd)
        k = matmul(src, self.wk).reshape(B, src.shape[1], Hk, hd)
        v = matmul(src, self.wv).reshape(B, src.shape[1], Hk, hd)
        if kv is None:                   # self-attention: rotary embedding
            q, k = apply_rope(q, rot), apply_rope(k, rot)
        causal = causal and kv is None

        new_cache = {"k": k, "v": v} if return_cache else None
        if kv_cache is not None:
            _write_cache(kv_cache["k"], k, write)
            _write_cache(kv_cache["v"], v, write)
            new_cache = kv_cache
            k, v = kv_cache["k"], kv_cache["v"]

        n_rep = H // Hk
        Sk = k.shape[1]
        scale = 1.0 / math.sqrt(hd)
        if kv_cache is not None:
            # decode: grouped-GQA attention against the cache, no
            # head-replicated K/V
            qg = q.reshape(B, S, Hk, n_rep, hd)
            logits = torch.einsum("bqgrd,bkgd->bgrqk", _f32(qg),
                                  _f32(k)) * scale
            logits = torch.where(write.keys, logits, NEG)
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("bgrqk,bkgd->bqgrd",
                               _f32(probs.to(x.dtype)), _f32(v))
            out = out.to(x.dtype).reshape(B, S, H, hd)
        elif S > FLASH_THRESHOLD:
            # long-sequence prefill: blocked online-softmax attention
            out = _flash_attention(q, _repeat_kv(k, n_rep),
                                   _repeat_kv(v, n_rep), causal=causal)
        else:
            kf, vf = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
            logits = torch.einsum("bqhd,bkhd->bhqk", _f32(q),
                                  _f32(kf)) * scale
            if causal:
                qi = torch.arange(S, device=x.device)[:, None]
                ki = torch.arange(Sk, device=x.device)[None, :]
                logits = torch.where((ki <= qi)[None, None], logits, NEG)
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs,
                               _f32(vf)).to(x.dtype)
        out = matmul(out.reshape(B, S, H * hd), self.wo)
        return out, new_cache


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
    qb = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * bq - Sq))
    kb = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * bk - Sk))
    vb = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * bk - Sk))
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
        return matmul(h, self.wo)


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
        return self.tok[tokens]

    def head_weight(self) -> torch.Tensor:
        """The LM head as (d, vocab): ``head``, or ``tok.T`` when tied."""
        return self.head if self.head is not None else self.tok.T


def lm_head(embedding: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (the reference's ``preferred_element_type``)."""
    return _f32(x) @ _f32(embedding.head_weight())


# --- pooled caches -----------------------------------------------------------

def insert_slot(pool: torch.Tensor, req: torch.Tensor, slot: int,
                axis: int) -> None:
    """Write ``req`` (batch size 1 on ``axis``) into batch slot ``slot`` of
    ``pool``, in place and cast to the pool's dtype, at offset 0 on every
    other axis (`dynamic_update_slice_in_dim`'s semantics)."""
    at = tuple(slice(0, n) for n in req.shape)
    at = at[:axis] + (slice(slot, slot + req.shape[axis]),) + at[axis + 1:]
    pool[at] = req.to(pool.dtype)
