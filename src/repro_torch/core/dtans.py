"""dtANS scalar codec — the paper's Algorithm 3 and its exact time reversal.

This is the *gold* reference implementation: Python big-int state, one stream,
no vectorization. `repro_torch.core.dtans_vec` (lane-vectorized numpy) and
`repro_torch.kernels.dtans_spmv` (the torch decoder and the CUDA kernels)
are validated against it.

Decoder state (Section IV-D): ``o`` words w_1..w_o, digit accumulator ``d``
and its radix ``r`` (invariant d < r; r < W at every segment boundary).
Per segment of ``l`` symbols:
  1. unpack(w_1..w_o) -> l slots (mixed-radix rewrite, i_1 least significant);
  2. for each slot: emit symbol, push returned digit: d = d*base + digit,
     r = r*base  (escaped slots additionally consume one raw symbol from the
     escape stream of their domain);
  3. refill: for k = 1..f (conditional): if r >= W extract w_k = d mod W,
     d //= W, r //= W; else pop w_k from v. For k = f+1..o pop w_k from v.
     The refill is skipped entirely for the last segment (Section IV-F,
     "Efficient handling of end of row").

Encoding runs the exact op sequence in reverse (Section IV-E):
  * a forward *base pass* fixes r's trajectory — and hence every
    extract-vs-pop branch — from the symbol sequence alone (the branch only
    depends on bases, which are per-symbol constants);
  * a backward *digit pass* starts from d = 0, inverts each op
    (pop -> prepend word; extract -> d = d*W + w; push -> digit = d mod base,
    d //= base, choosing the slot for (symbol, digit)), and emits the stream
    back-to-front. The ANS invariant d < r forces d == 0 at the stream head,
    which is exactly the decoder's initial state.

Multiple tables: ``pattern[k]`` selects the table of position k within a
segment (CSR-dtANS interleaves delta/value symbols; the paper-faithful
configuration uses ONE table shared by both domains — pattern all zeros —
matching the 64 KB table budget in Fig. 6; two separate tables are our
beyond-paper variant).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.params import DtansParams
from repro_torch.core.tables import CodingTable


@dataclasses.dataclass
class EncodedStream:
    """One encoded symbol sequence (a matrix row, for CSR-dtANS).

    ``branch`` and ``esc_mask`` describe the decoder's deterministic
    consumption schedule; the slice interleaver uses them to lay words of
    many lanes into one stream in exactly the order a lock-step decoder
    claims them (paper Section II-A "Interleaving for warps").
    """
    words: np.ndarray          # (n_words,) uint32-valued (stored uint64)
    esc: list[np.ndarray]      # per-table escape symbols, consumption order
    n: int                     # number of real (un-padded) symbols
    branch: np.ndarray = None  # (nseg, f) bool: True = extract (no pop)
    esc_mask: np.ndarray = None  # (nseg*l,) bool: position consumed escape

    @property
    def n_words(self) -> int:
        return int(self.words.size)


def _pad(u: np.ndarray, l: int, tables: list[CodingTable],
         pattern: np.ndarray) -> np.ndarray:
    """Pad tail to a multiple of l with cheap in-table symbols (IV-F)."""
    n = u.size
    if n % l == 0 and n > 0:
        return u
    if n == 0:
        return u  # zero symbols: encoded as empty stream, handled by caller
    n_pad = l - (n % l)
    pads = []
    for i in range(n_pad):
        t = tables[pattern[(n + i) % l]]
        try:
            pads.append(t.pad_symbol)
        except ValueError:
            # all-escape table: pad with the last real symbol; it roundtrips
            # through the escape stream and is dropped by the decoder.
            pads.append(int(u[-1]))
    return np.concatenate([u, np.asarray(pads, dtype=np.uint64)])


def encode_scalar(u: np.ndarray, params: DtansParams,
                  tables: list[CodingTable],
                  pattern: np.ndarray | None = None) -> EncodedStream:
    """Encode symbol sequence ``u`` (uint64) into a dtANS word stream."""
    W, K, l, o, f = params.W, params.K, params.l, params.o, params.f
    if not params.exact_unpack:
        # With K^l > W^o, not every slot combination is representable in o
        # words; supporting that needs constrained digit choice. The paper's
        # production parameters have equality, so we require it.
        raise NotImplementedError("encoder requires K^l == W^o")
    u = np.asarray(u, dtype=np.uint64)
    n = int(u.size)
    if pattern is None:
        pattern = np.zeros(l, dtype=np.int64)
    pattern = np.asarray(pattern, dtype=np.int64)
    assert pattern.size == l
    if n == 0:
        return EncodedStream(words=np.zeros(0, dtype=np.uint64),
                             esc=[np.zeros(0, dtype=np.uint64)
                                  for _ in tables], n=0)
    up = _pad(u, l, tables, pattern)
    nseg = up.size // l

    # ---- base pass (forward): branch schedule ----------------------------
    bases = np.empty(up.size, dtype=np.int64)
    is_esc = np.empty(up.size, dtype=bool)
    for k in range(up.size):
        t = tables[pattern[k % l]]
        sym = int(up[k])
        if t.in_table(sym):
            bases[k] = t.base_of(sym)
            is_esc[k] = False
        else:
            bases[k] = t.esc_base
            is_esc[k] = True
            if t.esc_base <= 0:
                raise ValueError("symbol not in table and no escape slot")
    branch = np.zeros((nseg, f), dtype=bool)  # True = extract (not pop)
    r = 1
    for j in range(nseg):
        for k in range(l):
            r *= int(bases[j * l + k])
        if j < nseg - 1:
            for k in range(f):
                if r >= W:
                    branch[j, k] = True
                    r //= W

    # ---- digit pass (backward) -------------------------------------------
    d = 0
    v_rev: list[int] = []                       # words, reversed order
    esc_rev: list[list[int]] = [[] for _ in tables]
    w_next: list[int] | None = None             # w^{(j+1)} packed at step j+1
    for j in range(nseg - 1, -1, -1):
        if j < nseg - 1:
            assert w_next is not None
            for k in range(o - 1, -1, -1):      # reverse refill order
                wk = w_next[k]
                if k >= f or not branch[j, k]:
                    v_rev.append(wk)            # reverse of pop = prepend
                else:
                    d = d * W + wk              # reverse of extract
        # reverse pushes, k = l-1 .. 0
        slots = [0] * l
        for k in range(l - 1, -1, -1):
            idx = j * l + k
            t = tables[pattern[k]]
            b = int(bases[idx])
            g = d % b
            d //= b
            if is_esc[idx]:
                slots[k] = t.esc_first + g
                esc_rev[pattern[k]].append(int(up[idx]))
            else:
                slots[k] = t.slot_of(int(up[idx]), g)
        # pack slots -> words w^{(j)}   (i_1 = slots[0] least significant)
        N = 0
        for k in range(l - 1, -1, -1):
            N = N * K + slots[k]
        w = [(N >> ((o - 1 - k) * params.w_bits)) % W for k in range(o)]
        w_next = w
    assert d == 0, "ANS invariant violated: d != 0 at stream head"
    words = list(w_next) + v_rev[::-1]
    return EncodedStream(
        words=np.asarray(words, dtype=np.uint64),
        esc=[np.asarray(e[::-1], dtype=np.uint64) for e in esc_rev],
        n=n,
        branch=branch,
        esc_mask=is_esc,
    )


def decode_scalar(enc: EncodedStream, params: DtansParams,
                  tables: list[CodingTable],
                  pattern: np.ndarray | None = None) -> np.ndarray:
    """Algorithm 3: decode ``enc`` back into its symbol sequence."""
    W, K, l, o, f = params.W, params.K, params.l, params.o, params.f
    if pattern is None:
        pattern = np.zeros(l, dtype=np.int64)
    pattern = np.asarray(pattern, dtype=np.int64)
    n = enc.n
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    nseg = (n + l - 1) // l
    v = enc.words
    pos = o
    w = [int(v[k]) for k in range(o)]
    d, r = 0, 1
    esc_pos = [0] * len(tables)
    out = np.empty(nseg * l, dtype=np.uint64)
    for j in range(nseg):
        N = 0
        for k in range(o):
            N = N * W + w[k]
        for k in range(l):
            slot = (N >> (k * params.k_bits)) % K
            t = tables[pattern[k]]
            if t.slot_is_esc[slot]:
                ti = int(pattern[k])
                out[j * l + k] = enc.esc[ti][esc_pos[ti]]
                esc_pos[ti] += 1
            else:
                out[j * l + k] = t.slot_symbol[slot]
            b = int(t.slot_base[slot])
            d = d * b + int(t.slot_digit[slot])
            r *= b
        if j < nseg - 1:
            for k in range(f):
                if r >= W:
                    w[k] = d % W
                    d //= W
                    r //= W
                else:
                    w[k] = int(v[pos])
                    pos += 1
            for k in range(f, o):
                w[k] = int(v[pos])
                pos += 1
    return out[:n]


def encoded_bits(enc: EncodedStream, params: DtansParams,
                 esc_bits_per_table: list[int] | None = None) -> int:
    """Size in bits of the encoded stream (words + escapes), excluding
    tables and the 4-byte length word (accounted at the matrix level)."""
    bits = enc.n_words * params.w_bits
    for ti, e in enumerate(enc.esc):
        per = esc_bits_per_table[ti] if esc_bits_per_table else 32
        bits += int(e.size) * per
    return bits
