"""Entropy / cross-entropy utilities (paper Section III-B, eqs. (1)-(2))."""

from __future__ import annotations

import numpy as np


def entropy_bits(counts: np.ndarray) -> float:
    """Shannon entropy H(P) in bits/symbol of an empirical distribution.

    ``counts`` are raw occurrence counts (not normalized); zeros are ignored.
    """
    c = np.asarray(counts, dtype=np.float64)
    c = c[c > 0]
    if c.size == 0:
        return 0.0
    p = c / c.sum()
    return float(-(p * np.log2(p)).sum())


def cross_entropy_bits(counts: np.ndarray, mults: np.ndarray, K: int) -> float:
    """Cross entropy H(P, P') in bits/symbol where P'(s) = mults[s] / K.

    This is the achievable bits/symbol of a (d)tANS table assigning
    ``mults[s]`` of the ``K`` slots to symbol ``s`` (paper eq. (2)). Symbols
    with count > 0 must have mult > 0 (else H' is infinite).
    """
    c = np.asarray(counts, dtype=np.float64)
    m = np.asarray(mults, dtype=np.float64)
    sel = c > 0
    if not sel.any():
        return 0.0
    if (m[sel] <= 0).any():
        return float("inf")
    p = c[sel] / c[sel].sum()
    q = m[sel] / float(K)
    return float(-(p * np.log2(q)).sum())


def stream_entropy_bits(symbols: np.ndarray) -> float:
    """Empirical entropy of a raw symbol stream."""
    _, counts = np.unique(np.asarray(symbols), return_counts=True)
    return entropy_bits(counts)
