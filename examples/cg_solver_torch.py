"""Conjugate-gradient solve with an entropy-coded system matrix on the
PyTorch/CUDA port (`src/repro_torch`): the steps of
`examples/cg_solver.py`, on the card by default. Iterative solvers re-read
the same matrix every iteration, so compression cuts the bytes each
iteration moves: the paper's headline scientific-computing use case.

Every iteration is one call of `ops.spmv` (on the card, the fused dtANS
decode + SpMV kernel in float64) and its vector arithmetic in torch on the
same device. The residual is checked every iteration, as the reference
does, so the iteration counts compare; that reads one number back to the
host an iteration. ``--tol`` is the reference's: on the residual's norm.

    PYTHONPATH=src python examples/cg_solver_torch.py [--side 48] \\
        [--tol 1e-8] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.pack import check_device, pack_matrix
from repro_torch.sparse.formats import best_baseline_nbytes
from repro_torch.sparse.random_graphs import stencil_2d


def cg(spmv, b: torch.Tensor, tol: float = 1e-8, maxiter: int = 300):
    """The reference's CG on torch tensors: returns (x, iterations), the
    iterations ``maxiter`` where the residual's norm never fell below
    ``tol``."""
    x = torch.zeros_like(b)
    r = b - spmv(x)
    p = r.clone()
    rs = r @ r
    for it in range(maxiter):
        ap = spmv(p)
        alpha = rs / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        if float(torch.sqrt(rs_new)) < tol:
            return x, it + 1
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, maxiter


def main(device="cuda", side: int = 48, tol: float = 1e-8,
         maxiter: int = 10000) -> dict:
    """Solves ``stencil_2d(side) x = b`` on ``device``; returns the
    iterations, the relative error against ``x_true`` and the solution."""
    dev = check_device(device)
    a = stencil_2d(side)            # SPD Laplacian, side^2 unknowns
    n = a.shape[0]
    mat = encode_matrix(a, lane_width=128)
    pm = pack_matrix(mat)
    _, bb = best_baseline_nbytes(a)
    print(f"system: {n} unknowns, nnz={a.nnz}; matrix bytes/iteration "
          f"{mat.nbytes:,} (dtANS) vs {bb:,} (best uncompressed)")

    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n)
    b = torch.as_tensor(a.to_dense() @ x_true, device=dev)

    x, iters = cg(lambda v: ops.spmv(pm, v, device=dev), b, tol, maxiter)
    x = x.cpu().numpy()
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "the CPU"
    print(f"CG converged in {iters} iterations on {where}, rel. error "
          f"{err:.2e}")
    if iters == maxiter:
        raise RuntimeError(f"CG did not converge in {maxiter} iterations")
    return {"iterations": iters, "rel_error": err, "x": x, "x_true": x_true}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    ap.add_argument("--side", type=int, default=48,
                    help="stencil side: side^2 unknowns (default 48)")
    ap.add_argument("--tol", type=float, default=1e-8,
                    help="residual norm to stop at (default 1e-8)")
    args = ap.parse_args()
    out = main(args.device, args.side, args.tol)
    assert out["rel_error"] < 1e-6
    print("solution matches: OK")
