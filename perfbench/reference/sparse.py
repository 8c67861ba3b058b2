"""The plain CSR product, and the plain CG over it, in PyTorch.

`csr_operator` turns CSR arrays into ``v -> A v`` (torch's own CSR
tensor); `cg` is the unpreconditioned conjugate gradient of HPCG and of
``examples/cg_solver_torch.py``: x0 = 0, ``iterations`` steps, no test of
the residual inside. Both run in the dtype they are given, on any device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def csr_operator(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                 n_cols: int, dtype: torch.dtype, device):
    """``v -> A v`` for the CSR arrays, computed in ``dtype``."""
    with warnings.catch_warnings():         # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(
            torch.as_tensor(indptr, dtype=torch.int64),
            torch.as_tensor(indices, dtype=torch.int64),
            torch.as_tensor(values).to(dtype),
            size=(len(indptr) - 1, n_cols), check_invariants=True).to(device)
    return lambda v: a @ v


def cg(spmv, b: torch.Tensor, iterations: int):
    """``(x, residual norm)`` after ``iterations`` CG steps from x = 0."""
    x = torch.zeros_like(b)
    r = b - spmv(x)
    p = r.clone()
    rs = r @ r
    for _ in range(iterations):
        ap = spmv(p)
        alpha = rs / (p @ ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = r @ r
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, float(torch.sqrt(rs))
