#!/usr/bin/env python3
"""Times launch-geometry variants of the dtANS kernels on one GPU.

    python3 experiments/dtans_geometry/time_geometry.py

The geometry is computed in Python (``src/repro_torch/kernels/tiling.py``)
and handed to the C entries, so variants need no rebuild: this script
builds a `tiling.Geometry` by hand and launches the port's kernels with
it, after checking each variant bitwise against the plain version. On the
SmolLM-135M head (49152 x 576, L = 128) and the 4x4-pruned head as
BCSR-dtANS 4x4 (L = 4), as ``chip_smoke.py`` phases 4 and 4c build them,
it times:

* SpMV with 1 or 2 units a block (head) and 2, 4 or 8 (blocked);
* SpMM with 4, 8 or 12 contraction warps at B = 4 and 64;
* SpMM at B = 512 in tiles of 64 and of the widest tile the 48 KB
  accumulator budget allows (`tiling.choose_bn` without a cap).

Each line gives the card's name and power limit; cuSPARSE CSR on the same
matrix is timed beside.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.core.bcsr_dtans import encode_bcsr_matrix  # noqa: E402
from repro_torch.kernels import dtans_spmv as K  # noqa: E402
from repro_torch.kernels import tiling  # noqa: E402
from repro_torch.kernels.pack import pack_matrix, to_device  # noqa: E402
from repro_torch.serving.sparse_linear import SparseLinear  # noqa: E402
from repro_torch.sparse.formats import CSR  # noqa: E402
from repro_torch.sparse.prune import codebook_quantize  # noqa: E402
from repro_torch.sparse.random_graphs import block_sparse  # noqa: E402


def matrices():
    """(label, packed matrix, shared_cols, CSR of the same matrix)."""
    rng = np.random.default_rng(C.SEED)
    w = (rng.standard_normal((C.D_MODEL, C.VOCAB)) * 0.02).astype(np.float32)
    sl = SparseLinear.from_dense(w, sparsity=0.8, value_bits=8,
                                 lane_width=128, device="cuda")
    tiles = block_sparse(C.VOCAB // C.BLOCK[0], C.D_MODEL // C.BLOCK[1],
                         C.BLOCK, density=C.BLOCK_DENSITY,
                         rng=np.random.default_rng(C.SEED),
                         dtype=np.float32)
    q = codebook_quantize(CSR(tiles.indptr, tiles.indices,
                              tiles.values * np.float32(C.WEIGHT_STD),
                              tiles.shape), bits=8)
    return [("head L=128", sl.packed, False, C.decode_matrix(sl.mat)),
            ("bcsr-dtans 4x4", pack_matrix(encode_bcsr_matrix(q, C.BLOCK)),
             True, q)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = K._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def spmv(dm, x, g, shared):
        y = torch.empty((dm.n_slices, dm.lane_width), device="cuda")
        K.raise_on(lib, lib.dtans_spmv_launch(
            *K.kernel_args(dm), *g.args(), int(shared), x.data_ptr(),
            x.shape[0], y.data_ptr(), stream), "spmv")
        return y

    def spmm(dm, x, g, shared, bt):
        B = x.shape[1]
        y = torch.empty((dm.n_slices, dm.lane_width, B), device="cuda")
        K.raise_on(lib, lib.dtans_spmm_launch(
            *K.kernel_args(dm), *g.args(), int(shared), x.data_ptr(),
            x.shape[0], B, bt, y.data_ptr(), stream), "spmm")
        return y

    for label, pm, shared, csr in matrices():
        dm = to_device(pm, "cuda")
        _, lib_fn = C.library_call(csr)
        x = torch.randn(C.D_MODEL, 512, device="cuda")
        x1 = x[:, 0].contiguous()
        L = dm.lane_width
        base = tiling.geometry(dm.n_slices, L, 1, 4)
        want = K.dtans_spmv_plain(dm, x1, shared)
        print(f"{label}: cuSPARSE CSR B=1 "
              f"{C.time_ms(lambda: lib_fn(x1), 50):.4f} ms | {card}")
        for upb in ((1, 2) if L > 32 else (2, 4, 8)):
            threads = upb * base.unit_warps * 32
            smem = tiling.smem_plan(1, L, 4, units_per_block=upb)["total"]
            g = dataclasses.replace(
                base, units_per_block=upb, threads=threads, smem=smem,
                blocks=tiling._blocks(-(-base.units // upb), threads, smem,
                                      tiling.SM_COUNT))
            assert torch.equal(spmv(dm, x1, g, shared), want)
            ms = C.time_ms(lambda: spmv(dm, x1, g, shared), 50)
            print(f"{label}: spmv {upb} units a block ({g.blocks} blocks) "
                  f"{ms:.4f} ms | {card}")
        for B in (4, 64):
            X = x[:, :B].contiguous()
            want = K.dtans_spmm_plain(dm, X, None, shared)
            g0 = tiling.geometry(dm.n_slices, L, 1, 4, bn=B, batch=B)
            for cw in (4, 8, 12):
                threads = (g0.unit_warps + cw) * 32
                g = dataclasses.replace(
                    g0, consumer_warps=cw, threads=threads,
                    blocks=tiling._blocks(g0.units, threads, g0.smem,
                                          tiling.SM_COUNT))
                assert torch.equal(spmm(dm, X, g, shared, B), want)
                ms = C.time_ms(lambda: spmm(dm, X, g, shared, B), 10)
                lib_ms = C.time_ms(lambda: lib_fn(X), 10)
                print(f"{label}: spmm B={B} {cw} contraction warps "
                      f"{ms:.4f} ms (cuSPARSE CSR {lib_ms:.4f} ms) | {card}")
        X = x.contiguous()
        widest = tiling.choose_bn(tiling.unit_rows(L), 512, 4,
                                  tiling.spmm_fixed_bytes(1, L, 4))
        for bn in (64, widest):
            want = K.dtans_spmm_plain(dm, X, bn, shared)
            g = tiling.geometry(dm.n_slices, L, 1, 4, bn=bn, batch=512)
            assert torch.equal(spmm(dm, X, g, shared, bn), want)
            ms = C.time_ms(lambda: spmm(dm, X, g, shared, bn), 10)
            print(f"{label}: spmm B=512 bn={bn} {ms:.4f} ms | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
