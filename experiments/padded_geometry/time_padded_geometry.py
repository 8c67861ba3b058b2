#!/usr/bin/env python3
"""Times the SELL / RGCSR SpMM kernel's variants on one GPU.

    python3 experiments/padded_geometry/time_padded_geometry.py
    python3 experiments/padded_geometry/time_padded_geometry.py \\
        --wrappers [--src DIR]

On the pruned SmolLM-135M head (49152 x 576 f32, the matrix of
``chip_smoke.py`` phase 4b, pruned and quantized here without the dtANS
encode) packed as SELL L=32 and RGCSR G=4, at B = 4, 8, 64 and 512 (tiles
of 64), each variant is checked bitwise against the plain version and then
timed (CUDA events, mean of 20 launches) beside cuSPARSE CSR:

* 1 against 2 columns a lane (at tiles wider than a warp), each with the
  slab's x columns staged in shared memory at 4, 8, 12 and 16 warps a
  block, and with x read through L1;
* rows a batch (x loads in flight per column) 2, 4 and 8 (the port: 8);
* each row's column and value handed to the lanes through a per-warp
  buffer in shared memory (the port) against two ``__shfl_sync`` a row,
  at 4 and 8 rows a batch.

The geometry is computed in Python (`tiling.padded_geometry`) and handed
to the C entries. The first two run through the port's own entries; the
last two through ``padded_variants.cu`` (the port's kernel with rows a
batch and the hand-off as template parameters), built here with the
port's nvcc flags.

``--wrappers`` times instead the ``sell_spmm`` / ``rgcsr_spmm`` wrappers
of the package under ``DIR/src`` (default: this checkout) at B = 4, 8, 64
and 512 (tiles of 64), so that two checkouts can be compared in one call
(run parent, change, change, parent). Every line gives the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent

D_MODEL, VOCAB, SEED = 576, 49152, 0     # chip_smoke.py's head
LAYOUTS = (("sell L=32", "sell", 32), ("rgcsr G=4", "rgcsr", 4))
PORT_ROWS_UNROLL = 8                     # padded_rows.cuh::ROWS_UNROLL


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def time_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def head_csr(np):
    """The head's pruned, quantized matrix: ``SparseLinear.from_dense``'s
    defaults on chip_smoke.py's weights, before the encode."""
    from repro_torch.sparse.prune import codebook_quantize, magnitude_prune
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    return codebook_quantize(magnitude_prune(w.T, 0.8), bits=8)


def packs(np, csr):
    from repro_torch.kernels import rgcsr_spmv as RG
    from repro_torch.kernels import sell_spmv as SE
    from repro_torch.sparse.rgcsr import RGCSR
    for label, fmt, rows in LAYOUTS:
        if fmt == "sell":
            pk = SE.pack_sell(csr, rows)
            yield label, fmt, SE, SE.to_device(pk, "cuda")
        else:
            pk = RG.pack_rgcsr(RGCSR.from_csr(csr, rows))
            yield label, fmt, RG, RG.to_device(pk, "cuda")


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
    rng = np.random.default_rng(SEED + 2)
    x = torch.as_tensor(rng.standard_normal((D_MODEL, 512)),
                        dtype=torch.float32, device="cuda")
    for label, fmt, mod, dm in packs(np, csr):
        spmm = getattr(mod, f"{fmt}_spmm")
        for B, bn in ((4, None), (8, None), (64, None), (512, 64)):
            X = x[:, :B].contiguous()
            ms = time_ms(torch, lambda: spmm(dm, X, bn=bn))
            lib_ms = time_ms(torch, lambda: lib(X))
            print(f"[wrappers {src}] {label} B={B} bn={bn} {ms:.4f} ms "
                  f"(cuSPARSE CSR {lib_ms:.4f} ms, {ms / lib_ms:.2f}x) | "
                  f"{smi}", flush=True)


def build_variants() -> Path:
    """``padded_variants.cu`` built with the port's nvcc flags into
    ``build/libpadded_variants.so``."""
    from repro_torch.kernels import _build
    out = HERE / "build" / "libpadded_variants.so"
    out.parent.mkdir(exist_ok=True)
    log = out.with_suffix(".log")
    with open(log, "w") as f:
        rc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out), str(HERE / "padded_variants.cu")],
            stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"nvcc failed:\n{log.read_text()}")
    return out


def variants() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import padded, tiling
    smi = card()
    port = {f: padded.library(f, 2) for f in ("sell", "rgcsr")}
    lib = ctypes.CDLL(str(build_variants()))
    VP, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fmt in ("sell", "rgcsr"):
        f = getattr(lib, f"{fmt}_spmm_variant_launch")
        f.argtypes = ([I, I] + [VP] * 2 + [VP, LL, I, VP, LL, LL, I]
                      + [I] * 4 + [LL, VP, VP])
        f.restype = I
    stream = torch.cuda.current_stream().cuda_stream
    csr = head_csr(np)
    lib_fn = library_fn(torch, csr)
    rng = np.random.default_rng(SEED + 2)
    x = torch.as_tensor(rng.standard_normal((D_MODEL, 512)),
                        dtype=torch.float32, device="cuda")

    for label, fmt, mod, dm in packs(np, csr):
        mats = [dm.indices, dm.stops] if fmt == "sell" \
            else [dm.deltas, dm.nnz]
        head = ([t.data_ptr() for t in mats]
                + [dm.values.data_ptr(), dm.rows, dm.values.shape[1]])
        plain = getattr(mod, f"{fmt}_spmm_plain")

        def run(X, g, rb=None, rows="smem"):
            """The port's C entry (``rb=None``), or the variants build's
            with ``rb`` rows a batch and the hand-off ``rows``."""
            B = X.shape[1]
            y = torch.empty((dm.rows, B), device="cuda")
            if rb is None:
                f, pre = getattr(port[fmt], f"{fmt}_spmm_launch"), [0]
            else:
                f = getattr(lib, f"{fmt}_spmm_variant_launch")
                pre = [rb, int(rows == "shfl")]
            rc = f(*pre, *head, X.data_ptr(), D_MODEL, B, g.bt, *g.args(),
                   y.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{fmt} {g} rb={rb} rows via {rows}: "
                                   f"rc {rc}")
            return y

        for B, bn in ((4, None), (8, None), (64, None), (512, 64)):
            X = x[:, :B].contiguous()
            bt = padded.tile_width(B, bn, most_tiles=None)
            want = plain(dm, X, None if bt == B else bt).reshape(-1, B)
            lib_ms = time_ms(torch, lambda: lib_fn(X))
            print(f"{label} B={B}: cuSPARSE CSR {lib_ms:.4f} ms | {smi}",
                  flush=True)
            base = tiling.padded_geometry(dm.rows, D_MODEL, B, bt, 4)
            ncs = (1, 2) if bt > tiling.WARP else (1,)
            tried = [(dict(cols_per_lane=nc, stage=True, warps=w), None,
                      "smem") for nc in ncs for w in (4, 8, 12, 16)]
            tried += [(dict(cols_per_lane=nc, stage=False), None, "smem")
                      for nc in ncs]
            tried += [({}, rb, "smem") for rb in (2, 4, 8)]
            tried += [({}, rb, "shfl") for rb in (4, 8)]
            for kw, rb, rows in tried:
                g = tiling.padded_geometry(dm.rows, D_MODEL, B, bt, 4, **kw)
                assert torch.equal(run(X, g, rb, rows), want), (label, B, kw)
                ms = time_ms(torch, lambda: run(X, g, rb, rows))
                mark = " (default)" if g == base and rb is None else ""
                build = "port" if rb is None else "variants build"
                print(f"{label} B={B} bn={bn}: {g.cols_per_lane} col/lane, "
                      f"{rb or PORT_ROWS_UNROLL} rows a batch, "
                      f"{g.warps} warps a block, x "
                      f"{'staged in smem' if g.stage else 'via L1'}, rows "
                      f"via {rows}, {build}{mark}: {ms:.4f} ms "
                      f"({ms / lib_ms:.2f}x cuSPARSE CSR) | {smi}",
                      flush=True)


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
