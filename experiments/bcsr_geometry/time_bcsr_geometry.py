#!/usr/bin/env python3
"""Times the BCSR SpMV and SpMM kernels' variants on one GPU.

    python3 experiments/bcsr_geometry/time_bcsr_geometry.py
    python3 experiments/bcsr_geometry/time_bcsr_geometry.py \\
        --wrappers [--src DIR]

On the two BCSR matrices of ``chip_smoke.py``, the pruned SmolLM-135M head
(49152 x 576 f32, pruned and quantized as ``SparseLinear.from_dense``
does, without the dtANS encode) as BCSR 2x2 (phase 4b) and the head's
shape pruned in 4x4 tiles as BCSR 4x4 (phase 4c), each variant is checked
bitwise against the plain version and then timed beside cuSPARSE CSR on
the same matrix:

* SpMV (B = 1): 1, 2, 4 and 8 lanes a row, x staged in shared memory or
  read through L1;
* SpMM at B = 4, 8, 64 and 512 (tiles of 64): the rows of a block row
  reading each x row together (the port, where r divides 32) or each row
  reading its own; at tiles wider than a warp, one or two columns a lane
  at 8, 12 and 16 warps a block.

The variants run through ``bcsr_variants.cu`` (the port's SpMV kernel with
lanes a row and staging as parameters, and the port's SpMM with the rows
sharing a column as a parameter), built here with the port's nvcc flags;
the SpMM geometry comes from `tiling.padded_geometry`. The port's own
choice (4 lanes a row, x staged where it fits 48 KB; rows of a block row
reading x together where r divides 32; `tiling.padded_geometry`'s
defaults) is marked "(default)". ``--wrappers`` times instead the
``bcsr_spmv`` / ``bcsr_spmm`` wrappers of the package under ``DIR/src``
(default: this checkout) at B = 1, 4, 8, 64 and 512, so that two
checkouts can be compared in one call (run parent, change, change,
parent).

Every time is the median of 5 runs, each one replay of a CUDA graph of 20
calls (no host work between launches), in ms a call. Every line gives the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent

D_MODEL, VOCAB, SEED = 576, 49152, 0     # chip_smoke.py's head
BLOCK, BLOCK_DENSITY, WEIGHT_STD = (4, 4), 0.2, 0.02   # its phase 4c
SPMM_B = ((4, None), (8, None), (64, None), (512, 64))
PORT_LANES, PORT_STAGE_BYTES = 4, 48 * 1024   # csrc/bcsr_spmv.cu's choice


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def graph_ms(torch, fn, calls: int = 20, runs: int = 5) -> float:
    """Median over ``runs`` of one replay of a CUDA graph of ``calls``
    calls of ``fn``, in ms a call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def matrices(np):
    """(label, CSR, block shape) of the two BCSR matrices."""
    from repro_torch.sparse.formats import CSR
    from repro_torch.sparse.prune import codebook_quantize, magnitude_prune
    from repro_torch.sparse.random_graphs import block_sparse
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    yield ("head 2x2", codebook_quantize(magnitude_prune(w.T, 0.8), bits=8),
           (2, 2))
    t = block_sparse(VOCAB // BLOCK[0], D_MODEL // BLOCK[1], BLOCK,
                     density=BLOCK_DENSITY, rng=np.random.default_rng(SEED),
                     dtype=np.float32)
    yield ("blocked 4x4", codebook_quantize(
        CSR(t.indptr, t.indices, t.values * np.float32(WEIGHT_STD),
            t.shape), bits=8), BLOCK)


def library_fn(torch, csr):
    a = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, device="cuda"),
        torch.as_tensor(csr.indices, device="cuda"),
        torch.as_tensor(csr.values, device="cuda"),
        size=csr.shape, check_invariants=False)
    return lambda v: a @ v


def wrappers(src: Path) -> None:
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    from repro_torch.kernels import bcsr_spmv as BC
    from repro_torch.sparse.bcsr import BCSR
    smi = card()
    x = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
        (D_MODEL, 512)), dtype=torch.float32, device="cuda")
    for label, csr, bs in matrices(np):
        db = BC.to_device(BC.pack_bcsr(BCSR.from_csr(csr, bs)), "cuda")
        x1 = x[:, 0].contiguous()
        ms = graph_ms(torch, lambda: BC.bcsr_spmv(db, x1))
        print(f"[wrappers {src}] {label} B=1 {ms:.4f} ms | {smi}",
              flush=True)
        for B, bn in SPMM_B:
            X = x[:, :B].contiguous()
            ms = graph_ms(torch, lambda: BC.bcsr_spmm(db, X, bn=bn))
            print(f"[wrappers {src}] {label} B={B} bn={bn} {ms:.4f} ms | "
                  f"{smi}", flush=True)


def build_variants() -> Path:
    """``bcsr_variants.cu`` built with the port's nvcc flags into
    ``build/libbcsr_variants.so``."""
    from repro_torch.kernels import _build
    out = HERE / "build" / "libbcsr_variants.so"
    out.parent.mkdir(exist_ok=True)
    log = out.with_suffix(".log")
    with open(log, "w") as f:
        rc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out), str(HERE / "bcsr_variants.cu")],
            stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"nvcc failed:\n{log.read_text()}")
    return out


def variants() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import bcsr_spmv as BC
    from repro_torch.kernels import padded, tiling
    from repro_torch.sparse.bcsr import BCSR
    smi = card()
    lib = ctypes.CDLL(str(build_variants()))
    VP, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head_t = [VP, VP, I, I, I, VP, LL, I, VP, LL]
    lib.bcsr_spmv_variant_launch.argtypes = [I, I, *head_t, VP, VP]
    lib.bcsr_spmm_variant_launch.argtypes = [I, *head_t, LL, I, I, I, I, I,
                                             LL, VP, VP]
    x = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
        (D_MODEL, 512)), dtype=torch.float32, device="cuda")

    for label, csr, bs in matrices(np):
        db = BC.to_device(BC.pack_bcsr(BCSR.from_csr(csr, bs)), "cuda")
        head = [db.block_cols.data_ptr(), db.stops.data_ptr(),
                db.block_cols.shape[1], *bs, db.values.data_ptr(), db.rows,
                db.values.shape[1]]
        lib_fn = library_fn(torch, csr)
        stops = db.stops.double()
        print(f"{label}: {db.rows} rows, {db.block_cols.shape[1]} slots a "
              f"block row, {float(stops.mean()):.1f} real on average, "
              f"{db.nbytes} B on the card | {smi}", flush=True)

        def spmv(v, lanes, stage):
            y = torch.empty(db.rows, device="cuda")
            rc = lib.bcsr_spmv_variant_launch(
                lanes, stage, *head, v.data_ptr(), D_MODEL, y.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"spmv lanes={lanes} stage={stage}: {rc}")
            return y

        def spmm(X, g, group):
            y = torch.empty((db.rows, X.shape[1]), device="cuda")
            rc = lib.bcsr_spmm_variant_launch(
                group, *head, X.data_ptr(), D_MODEL, X.shape[1], g.bt,
                *g.args(), y.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"spmm {g} group={group}: {rc}")
            return y

        x1 = x[:, 0].contiguous()
        X1 = x[:, :1].contiguous()
        want = BC.bcsr_spmv_plain(db, x1).reshape(-1)
        lib_ms = graph_ms(torch, lambda: lib_fn(X1))
        print(f"{label} B=1: cuSPARSE CSR {lib_ms:.4f} ms | {smi}",
              flush=True)
        assert torch.equal(BC.bcsr_spmv(db, x1).reshape(-1), want), label
        default = (PORT_LANES, D_MODEL * 4 <= PORT_STAGE_BYTES)
        for lanes in (1, 2, 4, 8):
            for stage in (1, 0):
                assert torch.equal(spmv(x1, lanes, stage), want), \
                    (label, lanes, stage)
                ms = graph_ms(torch, lambda: spmv(x1, lanes, stage))
                mark = " (default)" if (lanes, bool(stage)) == default \
                    else ""
                print(f"{label} B=1: {lanes} lanes a row, x "
                      f"{'staged in smem' if stage else 'via L1'}{mark}: "
                      f"{ms:.4f} ms ({ms / lib_ms:.2f}x cuSPARSE CSR) | "
                      f"{smi}", flush=True)
        shared = bs[0] if 32 % bs[0] == 0 else 1
        for B, bn in SPMM_B:
            X = x[:, :B].contiguous()
            bt = padded.tile_width(B, bn)
            want = BC.bcsr_spmm_plain(db, X, None if bt == B else bt
                                      ).reshape(-1, B)
            lib_ms = graph_ms(torch, lambda: lib_fn(X))
            base = tiling.padded_geometry(db.rows, D_MODEL, B, bt, 4)
            tried = [({}, shared), ({}, 1)]
            if bt > tiling.WARP:
                tried += [(dict(cols_per_lane=nc, warps=w), shared)
                          for nc in (1, 2) for w in (8, 12, 16)]
            for kw, group in tried:
                g = tiling.padded_geometry(db.rows, D_MODEL, B, bt, 4, **kw)
                if kw and g == base:
                    continue
                assert torch.equal(spmm(X, g, group), want), (label, B, kw,
                                                               group)
                ms = graph_ms(torch, lambda: spmm(X, g, group))
                what = (f"{group} rows read x together"
                        if group == shared else "each row reads its own x")
                mark = " (default)" if g == base and group == shared else ""
                print(f"{label} B={B} bn={bn}: {g.cols_per_lane} col/lane, "
                      f"{g.warps} warps a block, {what}{mark}: {ms:.4f} ms "
                      f"({ms / lib_ms:.2f}x cuSPARSE CSR {lib_ms:.4f} ms) | "
                      f"{smi}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wrappers", action="store_true",
                    help="time the wrappers of the package under --src")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="checkout whose src/ --wrappers times")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.wrappers:
        wrappers(args.src.resolve() / "src")
    else:
        variants()
    return 0


if __name__ == "__main__":
    sys.exit(main())
