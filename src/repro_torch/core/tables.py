"""dtANS coding-table construction (paper Sections III-D, IV-C, IV-F).

A table assigns each in-table symbol a *multiplicity* (number of consecutive
slots), approximating the empirical distribution P by P'(s) = mult(s)/K while
respecting the dtANS cap ``mult(s) <= M`` (Section IV-C). Rare symbols can be
*escaped* (Section IV-F "Escaping rare values"): they share one ESC symbol in
the table and their raw bits go to a separate escape stream.

Slot layout: symbols occupy consecutive slots (digit = 0..mult-1); the ESC
symbol, if present, occupies the trailing slots. The paper additionally
permutes slots to avoid GPU shared-memory bank conflicts; the port reads
its tables from global memory through the read-only cache, so it keeps the
consecutive layout (byte-equal to the JAX package's tables).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.entropy import cross_entropy_bits, entropy_bits
from repro_torch.core.params import DtansParams


@dataclasses.dataclass
class CodingTable:
    """Immutable decode/encode tables for one symbol domain (or a merged one).

    Attributes:
      slot_symbol: (K,) uint64 — symbol decoded at each slot (raw bit pattern).
      slot_digit:  (K,) uint32 — digit returned at each slot.
      slot_base:   (K,) uint32 — radix (multiplicity of the slot's symbol).
      slot_is_esc: (K,) bool   — slot belongs to the escape symbol.
      first_slot:  dict symbol -> first slot index (encode-side inverse).
      esc_first:   first escape slot (or -1), esc_base its multiplicity.
      esc_raw_bits: bits emitted to the escape stream per escaped symbol.
      K, M: table size / multiplicity cap actually used.
    """

    slot_symbol: np.ndarray
    slot_digit: np.ndarray
    slot_base: np.ndarray
    slot_is_esc: np.ndarray
    first_slot: dict
    esc_first: int
    esc_base: int
    esc_raw_bits: int
    K: int
    M: int
    used_slots: int

    def base_of(self, sym: int) -> int:
        """Multiplicity of a symbol (esc multiplicity if escaped)."""
        fs = self.first_slot.get(int(sym), -1)
        if fs >= 0:
            return int(self.slot_base[fs])
        if self.esc_first < 0:
            raise KeyError(f"symbol {sym} not in table and no escape slot")
        return self.esc_base

    def in_table(self, sym: int) -> bool:
        return int(sym) in self.first_slot

    def slot_of(self, sym: int, digit: int) -> int:
        fs = self.first_slot.get(int(sym), -1)
        if fs >= 0:
            return fs + digit
        return self.esc_first + digit

    @property
    def pad_symbol(self) -> int:
        """A cheap in-table symbol used to pad tails (Section IV-F)."""
        if self.used_slots > 0 and not self.slot_is_esc[0]:
            # slot 0 belongs to the highest-multiplicity symbol (cheapest).
            return int(self.slot_symbol[0])
        raise ValueError("table has no non-escape symbol to pad with")

    def nbytes(self, value_bytes: int) -> int:
        """On-accelerator table bytes, paper's accounting (Fig. 6 caption):
        K x (symbol + digit + base) = K x (value_bytes + 4 + 4)."""
        return self.K * (value_bytes + 8)


def build_table(
    symbols: np.ndarray,
    counts: np.ndarray,
    params: DtansParams,
    esc_raw_bits: int = 32,
) -> CodingTable:
    """Build a coding table from empirical symbol counts.

    Chooses (a) which symbols live in the table vs. get escaped and (b) the
    multiplicity of each, minimizing expected bits:
        in-table symbol:  count * -log2(mult/K)
        escaped symbol:   count * (-log2(esc_mult/K) + esc_raw_bits)
    subject to  sum(mult) <= K,  1 <= mult <= M.

    Strategy (greedy, near-optimal, O(S log S)):
      1. keep the (K-1) most frequent symbols in-table at most, rest escape;
      2. water-fill multiplicities proportional to counts, capped at M;
      3. greedily move the worst in-table symbols to escape while that
         reduces expected bits (re-fitting the escape multiplicity);
      4. final exact rebalance of multiplicities by largest-gain increments.
    """
    symbols = np.asarray(symbols, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.int64)
    if symbols.shape != counts.shape or symbols.ndim != 1:
        raise ValueError("symbols/counts must be 1-D and same shape")
    if np.unique(symbols).size != symbols.size:
        raise ValueError("symbols must be unique")
    K, M = params.K, params.M
    order = np.argsort(-counts, kind="stable")
    symbols, counts = symbols[order], counts[order]
    S = symbols.size
    total = max(int(counts.sum()), 1)

    # --- step 1: initial split: at most K-1 in-table (reserve 1 slot for ESC
    # when anything escapes).
    n_in = min(S, K - 1) if S > K - 1 else S
    while True:
        in_counts = counts[:n_in]
        esc_count = int(counts[n_in:].sum())
        have_esc = esc_count > 0 or n_in < S
        # --- step 2: proportional multiplicities, capped, >= 1.
        budget = K
        mults = _waterfill(in_counts, esc_count if have_esc else 0, budget, M)
        in_mults, esc_mult = mults
        # --- step 3: evict in-table symbols whose escape cost is lower.
        # Cost comparison for the marginal (lowest-count) in-table symbol s:
        #   keep:   c_s * -log2(m_s/K)
        #   escape: c_s * (-log2(esc'/K) + esc_raw_bits)   (esc' >= max(1,esc))
        # Eviction also frees m_s slots for everyone else, so we accept any
        # eviction that does not increase the total expected bits.
        if n_in == 0:
            break
        c_s = int(in_counts[-1])
        m_s = int(in_mults[-1])
        esc_now = esc_mult if have_esc else 0
        keep_bits = c_s * -np.log2(m_s / K)
        esc_next = max(1, esc_now)  # at least one ESC slot after eviction
        esc_bits = c_s * (-np.log2(esc_next / K) + esc_raw_bits)
        # Freed slots get re-water-filled; approximate their value as the
        # current marginal gain of one slot (cheap, keeps this O(S)).
        if esc_bits < keep_bits and S > 1:
            n_in -= 1
            continue
        break

    in_counts = counts[:n_in]
    esc_count = int(counts[n_in:].sum())
    have_esc = n_in < S
    in_mults, esc_mult = _waterfill(
        in_counts, esc_count if have_esc else 0, K, M)
    if have_esc and esc_mult == 0:
        esc_mult = 1  # escape path must stay reachable

    # --- assemble slots -------------------------------------------------
    slot_symbol = np.zeros(K, dtype=np.uint64)
    slot_digit = np.zeros(K, dtype=np.uint32)
    slot_base = np.ones(K, dtype=np.uint32)
    slot_is_esc = np.zeros(K, dtype=bool)
    first_slot: dict = {}
    pos = 0
    for i in range(n_in):
        m = int(in_mults[i])
        if m <= 0:
            continue
        first_slot[int(symbols[i])] = pos
        slot_symbol[pos:pos + m] = symbols[i]
        slot_digit[pos:pos + m] = np.arange(m, dtype=np.uint32)
        slot_base[pos:pos + m] = m
        pos += m
    esc_first = -1
    if have_esc:
        esc_first = pos
        slot_symbol[pos:pos + esc_mult] = np.uint64(0)
        slot_digit[pos:pos + esc_mult] = np.arange(esc_mult, dtype=np.uint32)
        slot_base[pos:pos + esc_mult] = esc_mult
        slot_is_esc[pos:pos + esc_mult] = True
        pos += esc_mult
    # Unused trailing slots keep base=1/digit=0; the encoder never selects
    # them, so they are unreachable during decode.
    return CodingTable(
        slot_symbol=slot_symbol,
        slot_digit=slot_digit,
        slot_base=slot_base,
        slot_is_esc=slot_is_esc,
        first_slot=first_slot,
        esc_first=esc_first,
        esc_base=int(esc_mult) if have_esc else 0,
        esc_raw_bits=esc_raw_bits,
        K=K,
        M=M,
        used_slots=pos,
    )


def _waterfill(in_counts: np.ndarray, esc_count: int, budget: int,
               M: int) -> tuple[np.ndarray, int]:
    """Allocate multiplicities (1..M each) to in-table symbols + ESC.

    Proportional seed followed by exact greedy top-up: repeatedly grant one
    slot to the entity with the largest marginal bit saving
    c * (log2(m+1) - log2(m)). Returns (in_mults, esc_mult).
    """
    n = in_counts.size
    ext = np.concatenate([in_counts.astype(np.float64),
                          [float(esc_count)] if esc_count > 0 else []])
    ne = ext.size
    if ne == 0:
        return np.zeros(0, dtype=np.int64), 0
    if budget < ne:
        raise ValueError(f"table too small: K={budget} < symbols+esc={ne}")
    tot = ext.sum()
    seed = np.maximum(1, np.minimum(
        M, np.floor(budget * ext / max(tot, 1.0)).astype(np.int64)))
    # Trim overshoot from the smallest-count entries first.
    overshoot = int(seed.sum()) - budget
    if overshoot > 0:
        for i in range(ne - 1, -1, -1):
            cut = min(overshoot, int(seed[i]) - 1)
            seed[i] -= cut
            overshoot -= cut
            if overshoot == 0:
                break
    # Greedy top-up with a heap on marginal gain.
    import heapq
    free = budget - int(seed.sum())
    heap = []
    for i in range(ne):
        if seed[i] < M and ext[i] > 0:
            gain = ext[i] * (np.log2(seed[i] + 1) - np.log2(seed[i]))
            heap.append((-gain, i))
    heapq.heapify(heap)
    while free > 0 and heap:
        _, i = heapq.heappop(heap)
        if seed[i] >= M:
            continue
        seed[i] += 1
        free -= 1
        if seed[i] < M:
            gain = ext[i] * (np.log2(seed[i] + 1) - np.log2(seed[i]))
            heapq.heappush(heap, (-gain, i))
    if esc_count > 0:
        return seed[:n], int(seed[n])
    return seed, 0


def table_cross_entropy(table: CodingTable, symbols: np.ndarray,
                        counts: np.ndarray) -> float:
    """Achieved bits/symbol of ``table`` on the (symbols, counts) corpus,
    including escape-stream raw bits. Used by tests and benchmarks."""
    symbols = np.asarray(symbols, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return 0.0
    bits = 0.0
    for s, c in zip(symbols, counts):
        if table.in_table(int(s)):
            m = table.base_of(int(s))
            bits += c * -np.log2(m / table.K)
        else:
            bits += c * (-np.log2(table.esc_base / table.K)
                         + table.esc_raw_bits)
    return bits / total


__all__ = [
    "CodingTable", "build_table", "table_cross_entropy",
    "entropy_bits", "cross_entropy_bits",
]
