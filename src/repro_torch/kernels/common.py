"""The plain lock-step dtANS decoder, in torch.

`segment_step` decodes ONE segment on every lane of every slice at once.
It is the CPU path of the decode kernels, and the oracle that the CUDA
kernels (`csrc/dtans_spmv.cu`) are held against on the card: the kernels
run the same claims, escapes, limb arithmetic and refills per thread.

Layout: the JAX package vmaps its decoder over slices; here the slice is
an explicit leading dimension. Per-lane arrays are ``(S, L)``, the limb
state ``(3, S, L)``, the stream cursor ``(S,)`` and the escape cursors
``(T, S)``. A Python loop runs over segments (`iter_segments`), never
over slices.

Integer story (paper Section IV-F "Positioning of checks"): the decoder
state d (and radix r) is held in three 32-bit limbs. Digits are
accumulated in groups whose radix product fits in 32 bits, then folded
into the limbs with one 64-bit multiply-add per limb. torch has no
uint64 arithmetic, so every 64-bit lane is an ``int64`` bit pattern:
multiplies and adds wrap exactly as uint64 would, and every ``>> 32`` is
masked with ``& 0xFFFFFFFF`` because ``>>`` on int64 is arithmetic.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from repro_torch.core.params import DtansParams
from repro_torch.kernels.pack import DeviceMatrix

_M32 = 0xFFFFFFFF


class DecodeArrays(NamedTuple):
    """Every slice's arrays, widened to int64 for the limb arithmetic."""
    stream: torch.Tensor      # (S, Wmax) int64, values < 2^32
    esc: torch.Tensor         # (T, S, Emax) int64, uint64 bit patterns
    tab_symbol: torch.Tensor  # (T, K) int64, uint64 bit patterns
    tab_digit: torch.Tensor   # (T, K) int64
    tab_base: torch.Tensor    # (T, K) int64
    tab_is_esc: torch.Tensor  # (T, K) bool
    ns: torch.Tensor          # (S, L) int64
    nnz: torch.Tensor         # (S, L) int64


class DecodeState(NamedTuple):
    w: torch.Tensor           # (S, L, o) int64 words
    d: torch.Tensor           # (3, S, L) int64 limbs
    r: torch.Tensor           # (3, S, L) int64 limbs
    cursor: torch.Tensor      # (S,) int64 — common stream cursor per slice
    esc_cur: torch.Tensor     # (T, S) int64
    col: torch.Tensor         # (S, L) int64 — running column per lane
    nsegs: torch.Tensor       # (S, L) int64


def decode_arrays(dm: DeviceMatrix) -> DecodeArrays:
    i64 = torch.int64
    return DecodeArrays(
        stream=dm.stream.to(i64) & _M32,
        esc=dm.esc,
        tab_symbol=dm.tab_symbol,
        tab_digit=dm.tab_digit.to(i64),
        tab_base=dm.tab_base.to(i64),
        tab_is_esc=dm.tab_is_esc > 0,
        ns=dm.ns.to(i64),
        nnz=dm.nnz.to(i64),
    )


def limb_mul_add(d: torch.Tensor, m: torch.Tensor,
                 a: torch.Tensor) -> torch.Tensor:
    """(3, ...) limbs: d * m + a, with m <= 2^32 and a < 2^32."""
    t0 = d[0] * m + a
    c0 = (t0 >> 32) & _M32
    t1 = d[1] * m + c0
    c1 = (t1 >> 32) & _M32
    t2 = d[2] * m + c1
    return torch.stack([t0 & _M32, t1 & _M32, t2 & _M32])


def _limb_ge_w(r: torch.Tensor, w_bits: int) -> torch.Tensor:
    hi = (r[1] > 0) | (r[2] > 0)
    if w_bits == 32:
        return hi
    return hi | ((r[0] >> w_bits) > 0)


def _limb_shr(d: torch.Tensor, w_bits: int) -> torch.Tensor:
    full0 = d[0] | (d[1] << 32)
    full1 = d[1] | (d[2] << 32)
    return torch.stack([(full0 >> w_bits) & _M32, (full1 >> w_bits) & _M32,
                        d[2] >> w_bits])


def _claim(stream: torch.Tensor, cursor: torch.Tensor, take: torch.Tensor):
    """Consumption-order claim: in each slice, the lanes with ``take`` read
    consecutive words from that slice's ``cursor`` on, in lane order."""
    rank = torch.cumsum(take.to(torch.int64), dim=1) - 1
    idx = (cursor[:, None] + rank).clamp(0, stream.shape[1] - 1)
    words = torch.gather(stream, 1, idx)
    return words, cursor + take.sum(dim=1)


def init_state(arr: DecodeArrays, params: DtansParams) -> DecodeState:
    l, o = params.l, params.o
    S, L = arr.ns.shape
    T = arr.esc.shape[0]
    dev = arr.ns.device
    nsegs = (arr.ns + (l - 1)) // l
    live = arr.ns > 0
    cursor = torch.zeros(S, dtype=torch.int64, device=dev)
    ws = []
    for _ in range(o):
        words, cursor = _claim(arr.stream, cursor, live)
        ws.append(torch.where(live, words, 0))
    zeros = torch.zeros((3, S, L), dtype=torch.int64, device=dev)
    r = zeros.clone()
    r[0] = 1
    return DecodeState(
        w=torch.stack(ws, dim=-1),
        d=zeros,
        r=r,
        cursor=cursor,
        esc_cur=torch.zeros((T, S), dtype=torch.int64, device=dev),
        col=torch.zeros((S, L), dtype=torch.int64, device=dev),
        nsegs=nsegs,
    )


def segment_step(j: int, state: DecodeState, arr: DecodeArrays,
                 params: DtansParams, pattern: tuple):
    """Decode segment ``j`` on all lanes of all slices.

    Returns (new_state, cols, vals_bits, valid):
      cols      (l//2, S, L) int64 — absolute column index per nonzero
      vals_bits (l//2, S, L) int64 — raw value bit patterns
      valid     (l//2, S, L) bool  — nonzero exists (tail masking)
    """
    W_bits, K_bits = params.w_bits, params.k_bits
    l, o, f = params.l, params.o, params.f
    Km1 = params.K - 1
    Wm1 = params.W - 1
    Emax = arr.esc.shape[2]
    active = j < state.nsegs

    # ---- unpack + table lookups (static unroll over l positions) --------
    wle = state.w.flip(-1)  # little-endian word view
    syms, digs, bass = [], [], []
    esc_cur = list(state.esc_cur.unbind(0))
    for k in range(l):
        lo = k * K_bits
        wi, sh = lo // W_bits, lo % W_bits
        pair = wle[..., wi]
        if wi + 1 < o:
            pair = pair | (wle[..., wi + 1] << W_bits)
        slot = (pair >> sh) & Km1
        t = pattern[k]
        sym = arr.tab_symbol[t][slot]
        is_esc = arr.tab_is_esc[t][slot] & active
        rank = torch.cumsum(is_esc.to(torch.int64), dim=1) - 1
        eidx = (esc_cur[t][:, None] + rank).clamp(0, Emax - 1)
        esym = torch.gather(arr.esc[t], 1, eidx)
        sym = torch.where(is_esc, esym, sym)
        esc_cur[t] = esc_cur[t] + is_esc.sum(dim=1)
        digs.append(torch.where(active, arr.tab_digit[t][slot], 0))
        bass.append(torch.where(active, arr.tab_base[t][slot], 1))
        syms.append(sym)

    # ---- positions: even = delta, odd = value bits -----------------------
    cols, vals_bits, valid = [], [], []
    col = state.col
    for i in range(l // 2):
        q = j * (l // 2) + i                      # nonzero index in row
        ok = (q < arr.nnz) & active
        col = col + torch.where(ok, syms[2 * i], 0)
        cols.append(col)
        vals_bits.append(syms[2 * i + 1])
        valid.append(ok)

    # ---- fold digits into limb state (groups fit 32 bits) ---------------
    d, r = state.d, state.r
    g = max(1, 32 // params.m_bits)
    for g0 in range(0, l, g):
        gacc = torch.zeros_like(syms[0])
        racc = torch.ones_like(syms[0])
        for k in range(g0, min(g0 + g, l)):
            gacc = gacc * bass[k] + digs[k]
            racc = racc * bass[k]
        d = limb_mul_add(d, racc, gacc)
        r = limb_mul_add(r, racc, torch.zeros_like(racc))

    # ---- refill ----------------------------------------------------------
    refill = active & (j < state.nsegs - 1)
    ws = list(state.w.unbind(-1))
    cursor = state.cursor
    for k in range(o):
        if k < f:
            cond = _limb_ge_w(r, W_bits) & refill
            wk = d[0] & Wm1
            d = torch.where(cond, _limb_shr(d, W_bits), d)
            r = torch.where(cond, _limb_shr(r, W_bits), r)
            popl = refill & ~cond
        else:
            wk = torch.zeros_like(ws[k])
            popl = refill
        popped, cursor = _claim(arr.stream, cursor, popl)
        wk = torch.where(popl, popped, wk)
        ws[k] = torch.where(refill, wk, ws[k])

    new_state = DecodeState(w=torch.stack(ws, dim=-1), d=d, r=r,
                            cursor=cursor, esc_cur=torch.stack(esc_cur),
                            col=col, nsegs=state.nsegs)
    return (new_state, torch.stack(cols), torch.stack(vals_bits),
            torch.stack(valid))


def iter_segments(dm: DeviceMatrix) -> Iterator[tuple]:
    """Decode every segment of a packed matrix in order: yields
    ``(j, cols, vals_bits, valid)`` for j in ``range(max_nseg)``."""
    arr = decode_arrays(dm)
    state = init_state(arr, dm.params)
    for j in range(dm.max_nseg):
        state, cols, vbits, valid = segment_step(j, state, arr, dm.params,
                                                 dm.pattern)
        yield j, cols, vbits, valid


def bits_to_value(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret raw int64 symbol bits as float32/float64 values."""
    if dtype == torch.float64:
        return bits.view(torch.float64)
    if dtype == torch.float32:
        low = bits & _M32
        low = torch.where(low >= 2 ** 31, low - 2 ** 32, low)
        return low.to(torch.int32).view(torch.float32)
    raise TypeError(f"unsupported dtype {dtype}")
