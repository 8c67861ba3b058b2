"""Quickstart on the PyTorch/CUDA port (`src/repro_torch`): compress a
sparse matrix with CSR-dtANS and run SpMVM with on-the-fly entropy
decoding (paper Fig. 1 end to end), the six steps of
`examples/quickstart.py`, on the card by default.

`select` ranks the candidates with the port's `H100` cost model, so its
picks may differ from the reference's, whose model is of a TPU; they are
printed, not checked.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.autotune import DecisionCache, select
from repro_torch.core.csr_dtans import decode_matrix, encode_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.pack import check_device
from repro_torch.serving.sparse_linear import SparseLinear
from repro_torch.sparse.formats import CSR, best_baseline_nbytes
from repro_torch.sparse.random_graphs import (erdos_renyi, stencil_2d,
                                              watts_strogatz)


def main(device="cuda") -> dict:
    """Runs the six steps on ``device``; returns the encoded matrix, the
    autotuner's picks and the `SparseLinear`."""
    dev = check_device(device)
    # 1. a classic scientific-computing matrix: 2-D Laplacian stencil
    a = stencil_2d(120)                      # 14400 x 14400, ~72k nnz
    print(f"matrix: {a.shape}, nnz={a.nnz}, dtype={a.values.dtype}")

    # 2. compress: CSR -> delta-encode -> dtANS entropy-code -> interleave
    mat = encode_matrix(a, lane_width=128)
    bname, bb = best_baseline_nbytes(a)
    print(f"CSR-dtANS: {mat.nbytes:,} B; best cuSPARSE-style format "
          f"({bname}): {bb:,} B -> compression {bb/mat.nbytes:.2f}x")
    print(f"escapes (delta, value): {tuple(mat.esc_count_by_domain)}")

    # 3. lossless check
    back = decode_matrix(mat)
    assert np.array_equal(back.indices, a.indices)
    assert np.array_equal(back.values, a.values)
    print("lossless roundtrip: OK")

    # 4. SpMVM with fused decode (the CUDA kernel on the card)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(a.shape[1])
    y = ops.spmv(mat, torch.as_tensor(x, device=dev), device=dev)
    y = y.cpu().numpy()
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    y_ref = np.zeros(a.shape[0])
    np.add.at(y_ref, rows, a.values * x[a.indices])
    np.testing.assert_allclose(y, y_ref, rtol=1e-10)
    print(f"fused decode+SpMVM: OK  (y[:4] = {y[:4].round(4)})")

    # 5. automatic format selection (repro_torch.autotune): fingerprint
    #    each matrix, pick the modeled-fastest of {CSR, COO, SELL,
    #    CSR-dtANS x configs}.
    cache = DecisionCache(path=None)
    graphs = {
        "erdos_renyi": erdos_renyi(2000, 10, rng),
        "watts_strogatz": watts_strogatz(2000, 5, 0.1, rng),
    }
    picks = {}
    for name, g in graphs.items():
        g32 = CSR(g.indptr, g.indices, g.values.astype(np.float32),
                  g.shape)
        for warm in (True, False):
            d = select(g32, warm=warm, cache=cache, device=dev)
            regime = "warm" if warm else "cold"
            picks[name, regime] = d.config_name
            print(f"autotune[{name:14s}|{regime}]: {d.config_name:22s}"
                  f" {d.nbytes:,} B, modeled {d.modeled_time*1e6:.2f} us")

    # 6. serving integration: a SparseLinear layer with auto=True lets the
    #    tuner choose the format per weight; it serves a batch of 4
    w = (rng.standard_normal((256, 512)) / 16).astype(np.float32)
    sl = SparseLinear.from_dense(w, sparsity=0.85, auto=True,
                                 autotune_cache=cache, device=dev)
    d = sl.decision
    h = torch.as_tensor(rng.standard_normal((4, 256)), dtype=torch.float32,
                        device=dev)
    out = sl.apply(h)
    torch.testing.assert_close(out, sl.apply_dense_reference(h),
                               rtol=1e-4, atol=1e-5)
    print(f"SparseLinear(auto=True): {d.config_name}, "
          f"{sl.compressed_bytes:,} B "
          f"({sl.compression_vs_dense:.2f}x vs dense); a batch of 4 "
          f"matches its dense reference: OK")
    return {"mat": mat, "picks": picks, "layer": sl}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    main(ap.parse_args().device)
