"""Magnitude pruning of dense NN weight matrices -> CSR.

The paper motivates entropy-coded SpMVM with pruned-LLM inference
(SparseGPT / SpQR citations). This is the bridge: prune a dense weight,
optionally quantize the surviving values to a small codebook (which is what
makes entropy coding effective on NN weights), and hand the result to
CSR-dtANS via `repro_torch.core.csr_dtans.encode_matrix`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sparse.formats import CSR


def magnitude_prune(w: np.ndarray, sparsity: float) -> CSR:
    """Zero out the smallest-|w| fraction ``sparsity`` of entries."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError("sparsity in [0, 1)")
    flat = np.abs(w).ravel()
    k = int(round(sparsity * flat.size))
    if k > 0:
        thresh = np.partition(flat, k - 1)[k - 1]
        w = np.where(np.abs(w) <= thresh, 0.0, w).astype(w.dtype)
    return CSR.from_dense(np.asarray(w))


def codebook_quantize(a: CSR, bits: int = 8) -> CSR:
    """Cluster surviving values to 2^bits centroids (uniform quantiles).

    Entropy coding of raw float weights barely compresses (all mantissas
    distinct); a codebook makes the value distribution low-entropy while
    keeping accuracy loss tiny — the standard lossy/lossless split. The
    *format* stays lossless w.r.t. its input, matching the paper's scope.
    """
    vals = a.values
    n_centroids = 1 << bits
    qs = np.linspace(0.0, 1.0, n_centroids)
    centroids = np.unique(np.quantile(vals, qs))
    idx = np.searchsorted(centroids, vals)
    idx = np.clip(idx, 1, centroids.size - 1)
    left = centroids[idx - 1]
    right = centroids[idx]
    snapped = np.where(np.abs(vals - left) <= np.abs(right - vals),
                       left, right).astype(vals.dtype)
    return CSR(indptr=a.indptr.copy(), indices=a.indices.copy(),
               values=snapped, shape=a.shape)
