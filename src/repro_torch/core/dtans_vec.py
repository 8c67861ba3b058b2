"""Lane-vectorized dtANS decode + consumption-order stream interleaving.

This is the numpy twin of the CUDA kernels (`repro_torch.kernels.dtans_spmv`)
and the host-side decode path. A *slice* of ``lanes`` independent streams
(one matrix row per lane, paper: 32 GPU threads; default here: 128) is
decoded in lock step. All lanes share ONE word stream laid out in
*consumption order*: at every load point, the lanes that need a word claim
consecutive positions, ordered by lane id — the paper's
``__ballot_sync``+``popc`` prefix-sum claim, written as a cumsum.

Arithmetic: decoder state d (and radix r) live in three 32-bit limbs held in
uint64 containers — the vector analogue of the paper's
"word-size multiplication + __umul_hi" trick. Digits are first accumulated
in groups whose radix product fits 32 bits (paper: "accumulate 4 returned
digits into a 4-byte digit/base pair"), then folded into the limb state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dtans import EncodedStream
from repro_torch.core.params import DtansParams
from repro_torch.core.tables import CodingTable

_M32 = np.uint64(0xFFFFFFFF)


@dataclasses.dataclass
class StackedTables:
    """Table arrays stacked over domains, gather-ready for kernels."""
    symbol: np.ndarray   # (T, K) uint64
    digit: np.ndarray    # (T, K) uint32
    base: np.ndarray     # (T, K) uint32
    is_esc: np.ndarray   # (T, K) bool

    @classmethod
    def stack(cls, tables: list[CodingTable]) -> "StackedTables":
        return cls(
            symbol=np.stack([t.slot_symbol for t in tables]),
            digit=np.stack([t.slot_digit for t in tables]),
            base=np.stack([t.slot_base for t in tables]),
            is_esc=np.stack([t.slot_is_esc for t in tables]),
        )

    @property
    def T(self) -> int:
        return self.symbol.shape[0]


@dataclasses.dataclass
class InterleavedSlice:
    """One slice's interleaved streams (the CSR-dtANS on-device layout)."""
    stream: np.ndarray        # (n_words,) uint64 (< 2^32), claim order
    esc_streams: list[np.ndarray]  # per-table uint64, claim order
    ns: np.ndarray            # (lanes,) int64 — symbols per lane


def interleave_slice(encs: list[EncodedStream], params: DtansParams,
                     n_tables: int) -> InterleavedSlice:
    """Merge per-lane encoded streams into one claim-ordered stream.

    Claim schedule (must mirror ``decode_lanes`` exactly):
      - initial load: for k = 0..o-1, every live lane pops, lane-ascending;
      - per segment j (lock step), refill for k = 0..o-1: lanes active in
        segment j+1... (i.e. lanes with j < nseg-1) pop unless the branch
        schedule says extract; lane-ascending within each k;
      - escape words: claimed at (segment, position k, lane) order.
    """
    l, o, f = params.l, params.o, params.f
    lanes = len(encs)
    ns = np.asarray([e.n for e in encs], dtype=np.int64)
    nsegs = (ns + l - 1) // l
    max_nseg = int(nsegs.max()) if lanes else 0
    cursors = [0] * lanes
    out: list[int] = []

    def pop(i: int) -> None:
        e = encs[i]
        out.append(int(e.words[cursors[i]]))
        cursors[i] += 1

    # initial load, k-major, lane-ascending
    for _ in range(o):
        for i in range(lanes):
            if ns[i] > 0:
                pop(i)
    # per-segment refills (segment j refills for consumption at j+1)
    for j in range(max_nseg):
        for k in range(o):
            for i in range(lanes):
                if j >= nsegs[i] - 1:   # lane done (or within last segment)
                    continue
                if k < f and encs[i].branch[j, k]:
                    continue            # extracted from state, no pop
                pop(i)
    for i in range(lanes):
        assert cursors[i] == encs[i].n_words, (
            f"lane {i}: {cursors[i]} != {encs[i].n_words}")
    return InterleavedSlice(
        stream=np.asarray(out, dtype=np.uint64),
        esc_streams=[np.zeros(0, dtype=np.uint64) for _ in range(n_tables)],
        ns=ns,
    )


def interleave_slice_with_pattern(
        encs: list[EncodedStream], params: DtansParams,
        pattern: np.ndarray, n_tables: int) -> InterleavedSlice:
    """Like ``interleave_slice`` but also interleaves escape streams
    according to ``pattern`` (table index per in-segment position)."""
    base = interleave_slice([_strip_esc(e) for e in encs], params, n_tables)
    l = params.l
    lanes = len(encs)
    ns = base.ns
    nsegs = (ns + l - 1) // l
    max_nseg = int(nsegs.max()) if lanes else 0
    esc_out: list[list[int]] = [[] for _ in range(n_tables)]
    esc_cursors = np.zeros((lanes, n_tables), dtype=np.int64)
    for j in range(max_nseg):
        for k in range(l):
            t = int(pattern[k])
            for i in range(lanes):
                if j >= nsegs[i]:
                    continue
                e = encs[i]
                if e.esc_mask is None or not e.esc_mask[j * l + k]:
                    continue
                esc_out[t].append(int(e.esc[t][esc_cursors[i, t]]))
                esc_cursors[i, t] += 1
    return InterleavedSlice(
        stream=base.stream,
        esc_streams=[np.asarray(e, dtype=np.uint64) for e in esc_out],
        ns=ns,
    )


def _strip_esc(e: EncodedStream) -> EncodedStream:
    return EncodedStream(words=e.words, esc=[], n=e.n, branch=e.branch,
                         esc_mask=None)


# ---------------------------------------------------------------------------
# Vectorized lock-step decode
# ---------------------------------------------------------------------------

def decode_lanes(sl: InterleavedSlice, params: DtansParams,
                 st: StackedTables, pattern: np.ndarray) -> np.ndarray:
    """Decode an interleaved slice; returns (lanes, max_n_padded) uint64.

    Positions beyond each lane's ``ns`` are padding garbage (mirrors the
    device kernel, which masks them in the SpMVM accumulation).
    """
    W_bits, K_bits = params.w_bits, params.k_bits
    W = np.uint64(params.W)
    Wm1 = np.uint64(params.W - 1)
    Km1 = np.uint64(params.K - 1)
    l, o, f = params.l, params.o, params.f
    lanes = sl.ns.size
    ns = sl.ns
    nsegs = (ns + l - 1) // l
    max_nseg = int(nsegs.max()) if lanes else 0
    if max_nseg == 0:
        return np.zeros((lanes, 0), dtype=np.uint64)

    stream = sl.stream
    cursor = 0
    esc_cursor = [0] * st.T

    # digit-group size: product of <=g bases stays < 2^32
    g = max(1, 32 // params.m_bits)

    w = np.zeros((lanes, o), dtype=np.uint64)
    live = ns > 0
    for k in range(o):
        take = live
        cnt = int(take.sum())
        idx = cursor + np.cumsum(take) - 1
        w[take, k] = stream[idx[take]]
        cursor += cnt

    d = np.zeros((3, lanes), dtype=np.uint64)   # limbs, little-endian
    r = np.zeros((3, lanes), dtype=np.uint64)
    r[0] = 1

    out = np.zeros((lanes, max_nseg * l), dtype=np.uint64)

    for j in range(max_nseg):
        active = j < nsegs
        # ---- unpack: slot_k = bits [k*K_bits, (k+1)*K_bits) of
        # N = w_0 * W^(o-1) + ... + w_{o-1}; little-endian word view:
        wle = w[:, ::-1]  # wle[:,0] least significant
        for k in range(l):
            lo = k * K_bits
            wi, sh = lo // W_bits, lo % W_bits
            pair = wle[:, wi].copy()
            if wi + 1 < o:
                pair = pair | (wle[:, wi + 1] << np.uint64(W_bits))
            slot = (pair >> np.uint64(sh)) & Km1
            t = int(pattern[k])
            sym = st.symbol[t][slot]
            esc = st.is_esc[t][slot] & active
            if esc.any():
                take = esc
                cnt = int(take.sum())
                idx = esc_cursor[t] + np.cumsum(take) - 1
                sym = sym.copy()
                sym[take] = sl.esc_streams[t][idx[take]]
                esc_cursor[t] += cnt
            out[:, j * l + k] = sym
            # stash digit/base for grouped accumulation below
            if k == 0:
                digs = np.zeros((l, lanes), dtype=np.uint64)
                bass = np.ones((l, lanes), dtype=np.uint64)
            digs[k] = np.where(active, st.digit[t][slot].astype(np.uint64), 0)
            bass[k] = np.where(active, st.base[t][slot].astype(np.uint64), 1)

        # ---- push digits in groups of g, then fold into limb state
        for g0 in range(0, l, g):
            gacc = np.zeros(lanes, dtype=np.uint64)
            racc = np.ones(lanes, dtype=np.uint64)
            for k in range(g0, min(g0 + g, l)):
                gacc = gacc * bass[k] + digs[k]
                racc = racc * bass[k]
            # d = d * racc + gacc ; r = r * racc  (3-limb multiply-add)
            d = _limb_mul_add(d, racc, gacc)
            r = _limb_mul_add(r, racc, np.zeros(lanes, dtype=np.uint64))

        # ---- refill (skipped for lanes in their last segment)
        refill = active & (j < nsegs - 1)
        if not refill.any():
            continue
        for k in range(o):
            if k < f:
                cond = _limb_ge_w(r, W_bits) & refill      # extract
                wk = d[0] & Wm1
                d = np.where(cond, _limb_shr(d, W_bits), d)
                r = np.where(cond, _limb_shr(r, W_bits), r)
                popl = refill & ~cond
            else:
                cond = np.zeros(lanes, dtype=bool)
                wk = np.zeros(lanes, dtype=np.uint64)
                popl = refill
            if popl.any():
                cnt = int(popl.sum())
                idx = cursor + np.cumsum(popl) - 1
                wk = wk.copy()
                wk[popl] = stream[idx[popl]]
                cursor += cnt
            w[:, k] = np.where(refill, wk, w[:, k])
    return out


def _limb_mul_add(d: np.ndarray, m: np.ndarray, a: np.ndarray) -> np.ndarray:
    """(3, lanes) limb state: d*m + a, with m <= 2^32, a < 2^32."""
    M32 = _M32
    t0 = d[0] * m + a
    l0 = t0 & M32
    c0 = t0 >> np.uint64(32)
    t1 = d[1] * m + c0
    l1 = t1 & M32
    c1 = t1 >> np.uint64(32)
    t2 = d[2] * m + c1
    return np.stack([l0, l1, t2 & M32])


def _limb_ge_w(r: np.ndarray, w_bits: int) -> np.ndarray:
    """r >= 2^w_bits on (3, lanes) limbs (w_bits <= 32)."""
    hi = (r[1] > 0) | (r[2] > 0)
    if w_bits == 32:
        return hi
    return hi | (r[0] >> np.uint64(w_bits) > 0)


def _limb_shr(d: np.ndarray, w_bits: int) -> np.ndarray:
    """d >> w_bits on (3, lanes) limbs."""
    M32 = _M32
    sh = np.uint64(w_bits)
    full0 = d[0] | (d[1] << np.uint64(32))
    full1 = d[1] | (d[2] << np.uint64(32))
    return np.stack([(full0 >> sh) & M32, (full1 >> sh) & M32, d[2] >> sh])
