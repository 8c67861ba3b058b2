#!/usr/bin/env python3
"""Times the SELL / RGCSR SpMV kernel's variants on one GPU.

    python3 experiments/padded_spmv_geometry/time_padded_spmv_geometry.py
    python3 experiments/padded_spmv_geometry/time_padded_spmv_geometry.py \\
        --wrappers [--src DIR]

On the pruned SmolLM-135M head (49152 x 576 f32, the matrix of
``chip_smoke.py`` phase 4b, pruned and quantized as
``SparseLinear.from_dense`` does, without the dtANS encode) packed as SELL
L=32, RGCSR G=4 and RGCSR G=32, each variant of the SpMV (B = 1) is
checked bitwise against the plain version and then timed beside cuSPARSE
CSR on the same matrix: 1, 2, 4 and 8 lanes a row, 2 or 4 steps of loads
issued before their x reads, x staged in shared memory or read through
L1. One lane a row is the thread-per-row shape of the kernel the port
replaced, with each row stopped at its last real entry.

The variants run through ``padded_spmv_variants.cu`` (the port's
``spmv_lanes_kernel`` with lanes, steps and staging as template
parameters, on the port's own row policies), built here with the port's
nvcc flags. The port's own choice (`PORT_LANES` lanes a row,
`PORT_UNROLL` steps, x through L1) is marked "(default)".
``--wrappers`` times instead the ``sell_spmv`` / ``rgcsr_spmv`` wrappers
(B = 1) and the ``sell_spmm`` / ``rgcsr_spmm`` wrappers at B = 4, 8, 64 and
512 (tiles of 64) of the package under ``DIR/src`` (default: this
checkout), with cuSPARSE CSR timed the same way, so that two checkouts can
be compared in one call (run parent, change, change, parent).

Every time is the median of 5 runs, each one replay of a CUDA graph of 20
calls (no host work between launches), in ms a call. Every line gives the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent

D_MODEL, VOCAB, SEED = 576, 49152, 0     # chip_smoke.py's head
LAYOUTS = (("sell L=32", "sell", 32), ("rgcsr G=4", "rgcsr", 4),
           ("rgcsr G=32", "rgcsr", 32))
SPMM_B = ((4, None), (8, None), (64, None), (512, 64))
# csrc/padded_rows.cuh's choice: LANES, LANES_UNROLL; x through L1
PORT_LANES, PORT_UNROLL = 4, 4


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


def head_csr(np):
    """The head's pruned, quantized matrix: ``SparseLinear.from_dense``'s
    defaults on chip_smoke.py's weights, before the encode."""
    from repro_torch.sparse.prune import codebook_quantize, magnitude_prune
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    return codebook_quantize(magnitude_prune(w.T, 0.8), bits=8)


def packs(csr):
    """(label, format, module, device matrix) of each layout."""
    from repro_torch.kernels import rgcsr_spmv as RG
    from repro_torch.kernels import sell_spmv as SE
    from repro_torch.sparse.rgcsr import RGCSR
    for label, fmt, rows in LAYOUTS:
        if fmt == "sell":
            yield label, fmt, SE, SE.to_device(SE.pack_sell(csr, rows),
                                               "cuda")
        else:
            yield label, fmt, RG, RG.to_device(
                RG.pack_rgcsr(RGCSR.from_csr(csr, rows)), "cuda")


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
    smi = card()
    csr = head_csr(np)
    lib = library_fn(torch, csr)
    x = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
        (D_MODEL, 512)), dtype=torch.float32, device="cuda")
    x1 = x[:, 0].contiguous()
    lib_ms = graph_ms(torch, lambda: lib(x1[:, None]))
    print(f"[wrappers {src}] cuSPARSE CSR B=1 {lib_ms:.4f} ms | {smi}",
          flush=True)
    layouts = list(packs(csr))
    for label, fmt, mod, dm in layouts:
        spmv = getattr(mod, f"{fmt}_spmv")
        ms = graph_ms(torch, lambda: spmv(dm, x1))
        print(f"[wrappers {src}] {label} B=1 {ms:.4f} ms "
              f"({ms / lib_ms:.2f}x cuSPARSE CSR) | {smi}", flush=True)
    for B, bn in SPMM_B:
        X = x[:, :B].contiguous()
        lib_ms = graph_ms(torch, lambda: lib(X))
        for label, fmt, mod, dm in layouts:
            if label == "rgcsr G=32":
                continue
            spmm = getattr(mod, f"{fmt}_spmm")
            ms = graph_ms(torch, lambda: spmm(dm, X, bn=bn))
            print(f"[wrappers {src}] {label} B={B} bn={bn} {ms:.4f} ms "
                  f"(cuSPARSE CSR {lib_ms:.4f} ms, {ms / lib_ms:.2f}x) | "
                  f"{smi}", flush=True)


def build_variants() -> Path:
    """``padded_spmv_variants.cu`` built with the port's nvcc flags into
    ``build/libpadded_spmv_variants.so``."""
    from repro_torch.kernels import _build
    out = HERE / "build" / "libpadded_spmv_variants.so"
    out.parent.mkdir(exist_ok=True)
    log = out.with_suffix(".log")
    with open(log, "w") as f:
        rc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out), str(HERE / "padded_spmv_variants.cu")],
            stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"nvcc failed:\n{log.read_text()}")
    return out


def variants() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    smi = card()
    lib = ctypes.CDLL(str(build_variants()))
    VP, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fmt in ("sell", "rgcsr"):
        f = getattr(lib, f"{fmt}_spmv_variant_launch")
        f.argtypes = [I, I, I, VP, VP, VP, LL, I, VP, LL, VP, VP]
        f.restype = I
    csr = head_csr(np)
    lib_fn = library_fn(torch, csr)
    x1 = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(
        D_MODEL), dtype=torch.float32, device="cuda")
    lib_ms = graph_ms(torch, lambda: lib_fn(x1[:, None]))
    print(f"head: {csr.shape[0]} x {csr.shape[1]}, nnz {csr.nnz}; B=1 "
          f"cuSPARSE CSR {lib_ms:.4f} ms | {smi}", flush=True)
    default = (PORT_LANES, PORT_UNROLL, False)

    for label, fmt, mod, dm in packs(csr):
        mats = [dm.indices, dm.stops] if fmt == "sell" \
            else [dm.deltas, dm.nnz]
        stops = mats[1].double()
        print(f"{label}: {dm.rows} rows, {dm.values.shape[1]} positions a "
              f"row, stops {float(stops.mean()):.1f} on average, "
              f"{dm.nbytes} B on the card | {smi}", flush=True)
        entry = getattr(lib, f"{fmt}_spmv_variant_launch")

        def run(lanes, unroll, stage):
            y = torch.empty(dm.rows, device="cuda")
            rc = entry(lanes, unroll, stage, *(t.data_ptr() for t in mats),
                       dm.values.data_ptr(), dm.rows, dm.values.shape[1],
                       x1.data_ptr(), D_MODEL, y.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{label} lanes={lanes} unroll={unroll} "
                                   f"stage={stage}: rc {rc}")
            return y

        want = getattr(mod, f"{fmt}_spmv_plain")(dm, x1).reshape(-1)
        port = getattr(mod, f"{fmt}_spmv")
        assert torch.equal(port(dm, x1).reshape(-1), want), label
        ms = graph_ms(torch, lambda: port(dm, x1))
        print(f"{label} B=1: the port's wrapper {ms:.4f} ms "
              f"({ms / lib_ms:.2f}x cuSPARSE CSR) | {smi}", flush=True)
        for lanes in (1, 2, 4, 8):
            for unroll in (2, 4):
                for stage in (1, 0):
                    assert torch.equal(run(lanes, unroll, stage), want), \
                        (label, lanes, unroll, stage)
                    ms = graph_ms(torch, lambda: run(lanes, unroll, stage))
                    mark = " (default)" if (lanes, unroll, bool(stage)) \
                        == default else ""
                    print(f"{label} B=1: {lanes} lanes a row, {unroll} "
                          f"steps a load batch, x "
                          f"{'staged in smem' if stage else 'via L1'}"
                          f"{mark}: {ms:.4f} ms ({ms / lib_ms:.2f}x "
                          f"cuSPARSE CSR) | {smi}", flush=True)


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
