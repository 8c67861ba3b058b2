"""A frozen copy of the port's magnitude prune and quantile codebook.

The same arithmetic as ``repro_torch.sparse.prune`` (`magnitude_prune`,
then `codebook_quantize`), written over a dense matrix: the entries whose
magnitude is at or below the k-th smallest, k = round(sparsity * size), are
zeroed, and the survivors are snapped to the nearer of 2^bits uniform
quantiles of their values (ties to the lower). Kept here so that the
benchmark's yardstick does not move when the port does.
"""

from __future__ import annotations

import numpy as np


def magnitude_prune(w: np.ndarray, sparsity: float) -> np.ndarray:
    """``w`` with its smallest-magnitude share ``sparsity`` set to zero."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError("sparsity in [0, 1)")
    mag = np.abs(w)
    k = int(round(sparsity * mag.size))
    if k == 0:
        return w.copy()
    thresh = np.partition(mag.ravel(), k - 1)[k - 1]
    return np.where(mag <= thresh, 0.0, w).astype(w.dtype)


def codebook_snap(w: np.ndarray, bits: int) -> np.ndarray:
    """The nonzeros of ``w`` snapped to 2^bits quantiles of their values."""
    mask = w != 0
    vals = w[mask]
    centroids = np.unique(np.quantile(vals, np.linspace(0.0, 1.0, 1 << bits)))
    idx = np.clip(np.searchsorted(centroids, vals), 1, centroids.size - 1)
    left, right = centroids[idx - 1], centroids[idx]
    out = np.zeros_like(w)
    out[mask] = np.where(np.abs(vals - left) <= np.abs(right - vals),
                         left, right).astype(w.dtype)
    return out


def pruned_quantized(w: np.ndarray, sparsity: float, bits: int) -> np.ndarray:
    """Prune, then snap: the matrix a pruned, quantized layer serves."""
    return codebook_snap(magnitude_prune(w, sparsity), bits)
