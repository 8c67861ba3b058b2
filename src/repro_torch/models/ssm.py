"""Mamba2 block: the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060] for a prompt, and the single-token recurrence for
decoding.

A port of the JAX package's `models/ssm.py`. The chunked scan keeps the
reference's four steps (intra-chunk outputs in the quadratic dual form,
chunk summaries, the inter-chunk recurrence, the off-diagonal outputs); the
reference's `lax.scan` over chunks is a Python loop here. State per head:
(headdim x d_state); one B/C group. ``A_log``, ``D`` and ``dt_bias`` stay
float32 whatever the config's dtype, as in the reference. A decode step
writes the conv tail and the state IN PLACE, through ``torch.where`` on the
slots that are active, so nothing is read back to the host.

The reference's annotations sit at its sites: ``z`` and ``xBC`` after the
split, ``xs`` and the decays ``a`` on the SSM heads, the output on
("batch", "seq", "d_model"). ``in_proj``'s spec shards the concatenated
``[z | xBC | dt]`` projection, so the split slices across shard
boundaries; DTensor gathers there, as XLA reshards there. The decode
branch annotates its ``xs`` and ``a`` too (the reference leaves them to
XLA's propagation), so the state update runs on each rank's heads, the
heads the state's cache spec gives it; its conv tail and state are written
shard by shard (`sharding.write_local`).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import _dense_init, _f32, matmul, rmsnorm
from repro_torch.models.sharding import merge_dims, pad, shard, write_local

F = torch.nn.functional


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (torch's
    `softplus` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., T). out[..., i, j] = sum_{k=j+1..i} a_k where i >= j, else
    -inf."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(T, device=a.device)
    return torch.where(i[:, None] >= i[None, :], seg, -torch.inf)


def _ssd_chunked(x, a, Bm, Cm, chunk: int):
    """x: (b, s, h, p) f32; a: (b, s, h) f32 (negative decays); Bm, Cm:
    (b, s, n) f32 (one group, broadcast over heads); s a multiple of
    ``chunk``. Returns (y (b, s, h, p), final state (b, h, p, n))."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)      # (b,h,nc,T)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)

    a_cum = torch.cumsum(ac, dim=-1)                         # (b,h,nc,T)
    L = torch.exp(_segsum(ac))                               # (b,h,nc,T,T)

    # 1. intra-chunk (diagonal blocks)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, L, xc)

    # 2. chunk summaries (state contribution of each chunk)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)        # (b,h,nc,T)
    states = torch.einsum("bcsn,bhcs,bcshp->bchpn", Bc, decay_states, xc)

    # 3. inter-chunk recurrence S_c = S_{c-1} * exp(sum a_c) + states_c;
    # chunk c's outputs read the state before it
    chunk_decay = torch.exp(a_cum[..., -1])                  # (b,h,nc)
    state = x.new_zeros((b, h, p, n))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[..., c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (b,nc,h,p,n)

    # 4. off-diagonal (previous chunks -> this chunk's outputs)
    state_decay = torch.exp(a_cum)                           # (b,h,nc,T)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    return (y_diag + y_off).reshape(b, s, h, p), state


def ssm_cache_init(cfg: ArchConfig, batch: int, *, device) -> dict:
    """A zeroed decode cache of one block: ``conv`` (B, wc - 1, channels)
    in the config's dtype, ``state`` (B, H, P, N) in float32."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=cfg.param_dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }


class SSM(nn.Module):
    """One Mamba2 block; weights named as the reference's ``ssm_init``:
    ``in_proj`` (d, 2 d_inner + 2 N + H), ``conv_w`` (wc, d_inner + 2 N),
    ``conv_b``, ``A_log`` / ``D`` / ``dt_bias`` (H, float32), ``norm``
    (d_inner), ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, *,
                 device):
        super().__init__()
        self.cfg = cfg
        d, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        wc, dt = cfg.conv_width, cfg.param_dtype
        conv_ch = din + 2 * N        # x, B, C go through the depthwise conv

        def param(t):
            return nn.Parameter(t.to(device), requires_grad=False)
        self.in_proj = _dense_init(generator, (d, 2 * din + 2 * N + H), dt,
                                   device)
        self.conv_w = _dense_init(generator, (wc, conv_ch), dt, device,
                                  scale=1.0 / wc)
        self.conv_b = param(torch.zeros(conv_ch, dtype=dt))
        self.A_log = param(torch.log(torch.arange(1, H + 1,
                                                  dtype=torch.float32)))
        self.D = param(torch.ones(H, dtype=torch.float32))
        self.dt_bias = param(torch.zeros(H, dtype=torch.float32))
        self.norm = param(torch.ones(din, dtype=dt))
        self.out_proj = _dense_init(generator, (din, d), dt, device)

    def _split(self, zxbcdt):
        din, N, H = self.cfg.d_inner, self.cfg.ssm_state, self.cfg.ssm_heads
        return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * N],
                zxbcdt[..., -H:])

    def forward(self, u, *, cache=None, active=None, return_cache=False):
        """u: (B, S, d). Without ``cache`` (forward, prefill) the chunked
        scan, padded to a multiple of ``chunk = min(ssm_chunk, S)`` with
        x = 0 and a = 0; ``return_cache=True`` also returns the cache for
        decoding: the last wc - 1 raw conv inputs and the final state.
        With ``cache`` (decode, S == 1; `ssm_cache_init`'s layout) the
        single-token recurrence, which writes the conv tail and the state
        IN PLACE and returns ``cache``; it needs ``active`` (B,) bool, and
        keeps the bits of every slot where it is False. Returns (out,
        cache or None)."""
        cfg = self.cfg
        B, S, _ = u.shape
        din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_headdim
        wc = cfg.conv_width
        z, xBC, dtr = self._split(matmul(u, self.in_proj))
        z = shard(z, "batch", "seq", "ff")
        xBC = shard(xBC, "batch", "seq", None)
        A = -torch.exp(self.A_log)                               # (H,)
        dt_f = softplus(_f32(dtr) + self.dt_bias)                # (B,S,H)
        w, bias = _f32(self.conv_w), _f32(self.conv_b)

        new_cache = None
        if cache is None:
            # causal depthwise conv over the (x, B, C) channels
            xp = pad(xBC, (0, 0, wc - 1, 0))
            conv = sum(_f32(xp[:, k:k + S]) * w[k] for k in range(wc)) + bias
            xBC_c = F.silu(conv)
            xs = shard(xBC_c[..., :din].reshape(B, S, H, P),
                       "batch", "seq", "ssm_heads", None)
            Bm, Cm = xBC_c[..., din:din + N], xBC_c[..., din + N:]
            a = shard(dt_f * A, "batch", "seq", "ssm_heads")     # (B,S,H)
            xdt = xs * dt_f[..., None]
            chunk = min(cfg.ssm_chunk, S)
            pad_s = (-S) % chunk
            # pad with x = 0 (no contribution) and a = 0 (decay 1, state
            # kept)
            y, state = _ssd_chunked(pad(xdt, (0, 0, 0, 0, 0, pad_s)),
                                    pad(a, (0, 0, 0, pad_s)),
                                    pad(Bm, (0, 0, 0, pad_s)),
                                    pad(Cm, (0, 0, 0, pad_s)), chunk)
            y = y[:, :S] + self.D[:, None] * xs
            if return_cache:
                new_cache = {"conv": xp[:, S:S + wc - 1].to(u.dtype),
                             "state": state}
        else:
            if active is None:
                raise TypeError("the decode branch needs active=")
            conv_st = cache["conv"]                              # (B,wc-1,ch)
            common = torch.promote_types(conv_st.dtype, xBC.dtype)
            window = torch.cat([conv_st.to(common), xBC.to(common)], dim=1)
            conv = (_f32(window) * w[None]).sum(dim=1) + bias
            xBC_c = F.silu(conv)                                 # (B, ch)
            xs = shard(xBC_c[:, :din].reshape(B, H, P),
                       "batch", "ssm_heads", None)
            Bm, Cm = xBC_c[:, din:din + N], xBC_c[:, din + N:]
            a = shard(torch.exp(dt_f[:, 0] * A), "batch", "ssm_heads")
            upd = torch.einsum("bhp,bn->bhpn", xs * dt_f[:, 0, :, None], Bm)
            state = cache["state"] * a[..., None, None] + upd
            y = torch.einsum("bhpn,bn->bhp", state, Cm)
            y = (y + self.D[:, None] * xs)[:, None]
            tail = torch.where(active[:, None, None], window[:, 1:],
                               conv_st)
            state = torch.where(active[:, None, None, None], state,
                                cache["state"])
            write_local(cache["conv"], tail)
            write_local(cache["state"], state)
            new_cache = cache

        y = merge_dims(y, 2).to(u.dtype)
        # gated RMSNorm (mamba2): norm(y * silu(z)), the gate cast first
        y = y * F.silu(_f32(z)).to(u.dtype)
        y = rmsnorm(self.norm, y, cfg.norm_eps)
        return shard(matmul(y, self.out_proj), "batch", "seq", "d_model"), \
            new_cache
