#!/usr/bin/env python3
"""Times the decode-only dtANS kernel's store variants on one GPU.

    python3 experiments/decode_geometry/time_decode_geometry.py \\
        [--packs PATH]
    python3 experiments/decode_geometry/time_decode_geometry.py \\
        --wrappers [--src DIR] --packs PATH

On the SmolLM-135M head (49152 x 576 f32 at ``SparseLinear.from_dense``'s
defaults, L = 128, ``chip_smoke.py`` phase 4) and the head's shape pruned
in 4x4 tiles as BCSR-dtANS 4x4 (L = 4, eight slices a warp, phase 4c),
each variant of ``decode_variants.cu`` is checked bitwise against the plain
version (`dtans_decode_plain`) and then timed:

* (a) scalar stores, each thread into its own row (the kernel before the
  staged design), and (b) one thread's segment as 16-byte vectors;
* (c) the staged tile (the port's design, which ships 2) at 2, 4 and 8
  segments a warp;
* (d) the staged tile double-buffered and written out by
  ``cp.async.bulk`` (TMA's bulk copy), issued by lane 0 or by each lane for
  its own row, at 2, 4 and 8 segments;
* (e) each of (a)-(c) with ``st.global.cs`` (streaming) stores.

Then the port's own kernel (its C entry, ``dtans_decode_launch``; 2
segments a warp, streaming stores) at 1 or 2 units a block (head) and 4
or 8 (blocked), and its wrapper (`dtans_decode`, the geometry of
`tiling.decode_geometry`, marked "(default)"). ``--wrappers`` times instead the `dtans_decode`
wrapper of the package under ``DIR/src`` (default: this checkout) on the
same matrices, graph-timed and as a loop of 20 launches, so that two
checkouts can be compared in one call (run parent, change, change, parent).

``--packs PATH`` keeps the encoded matrices (and their bounds) in a pickle:
written by the first run, read by later ones, so that the host encode
(about 80 s) is paid once a call.

Every time is the median of 5 runs, each one replay of a CUDA graph of 20
calls (no host work between launches), in ms a call. Every line gives the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import pickle
import statistics
import subprocess
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent

SCALAR, VEC, STAGED, BULK = 0, 1, 2, 3
STAGES = (2, 4, 8)


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


def loop_ms(torch, fn, iters: int = 20) -> float:
    """Mean of a Python loop of ``iters`` calls (chip_smoke.py's
    ``time_ms``)."""
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


def encode() -> dict:
    """label -> (packed matrix, bound ms, bytes): the matrices of
    chip_smoke.py phases 4 and 4c, built as it builds them."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import chip_smoke as C
    from repro_torch.core.bcsr_dtans import encode_bcsr_matrix
    from repro_torch.core.csr_dtans import encode_matrix
    from repro_torch.kernels.pack import pack_matrix
    from repro_torch.sparse.formats import CSR
    from repro_torch.sparse.prune import codebook_quantize, magnitude_prune
    from repro_torch.sparse.random_graphs import block_sparse
    rng = np.random.default_rng(C.SEED)
    w = (rng.standard_normal((C.D_MODEL, C.VOCAB)) * 0.02).astype(np.float32)
    head = encode_matrix(codebook_quantize(magnitude_prune(w.T, 0.8),
                                           bits=8), lane_width=128,
                         shared_table=True)
    tiles = block_sparse(C.VOCAB // C.BLOCK[0], C.D_MODEL // C.BLOCK[1],
                         C.BLOCK, density=C.BLOCK_DENSITY,
                         rng=np.random.default_rng(C.SEED), dtype=np.float32)
    q = codebook_quantize(CSR(tiles.indptr, tiles.indices,
                              tiles.values * np.float32(C.WEIGHT_STD),
                              tiles.shape), bits=8)
    blocked = encode_bcsr_matrix(q, block_shape=C.BLOCK)
    out = {}
    for label, mat in (("head L=128", head), ("bcsr-dtans 4x4", blocked)):
        pm = pack_matrix(mat)
        sl = types.SimpleNamespace(mat=mat, packed=pm, d_in=C.D_MODEL,
                                   d_out=C.VOCAB)
        b_ms, _, nbytes, _ = C.decode_bound(sl)
        out[label] = (pm, b_ms, nbytes)
    return out


def load_packs(path: Path | None) -> dict:
    if path is not None and path.exists():
        return pickle.loads(path.read_bytes())
    packs = encode()
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pickle.dumps(packs))
    return packs


def wrappers(src: Path, packs_path: Path) -> None:
    sys.path.insert(0, str(src))
    import torch
    from repro_torch.kernels import dtans_decode as DD
    from repro_torch.kernels.pack import to_device
    if not packs_path.exists():
        raise SystemExit(f"--wrappers reads {packs_path}: make it first "
                         f"with a run without --wrappers")
    smi = card()
    for label, (pm, b_ms, _) in load_packs(packs_path).items():
        dm = to_device(pm, "cuda")
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(DD.dtans_decode(dm),
                                   DD.dtans_decode_plain(dm))), label
        ms = graph_ms(torch, lambda: DD.dtans_decode(dm))
        lp = loop_ms(torch, lambda: DD.dtans_decode(dm))
        print(f"[wrappers {src}] {label} decode {ms:.4f} ms (graph; loop "
              f"{lp:.4f}), bound {b_ms:.5f} ms ({b_ms / ms:.1%}) | {smi}",
              flush=True)


def build_variants() -> Path:
    """``decode_variants.cu`` built with the port's nvcc flags into
    ``build/libdecode_variants.so``; prints the registers and spills of
    each instantiation."""
    from repro_torch.kernels import _build
    out = HERE / "build" / "libdecode_variants.so"
    out.parent.mkdir(exist_ok=True)
    log = out.with_suffix(".log")
    with open(log, "w") as f:
        rc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out), str(HERE / "decode_variants.cu")],
            stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"nvcc failed:\n{log.read_text()}")
    name = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"[build] {name}: {line.strip()}", flush=True)
    return out


def variant_smem(mode: int, ks: int, geom, n_tables: int) -> int:
    """Shared memory of a variant's block (f32): tables, units and its
    tiles (the port's plan for STAGED)."""
    from repro_torch.kernels import tiling
    base = tiling.smem_plan(n_tables, 1, 4)["tables"] + tiling.smem_plan(
        1, 32 * geom.unit_warps, 4,
        units_per_block=geom.units_per_block)["units"]
    warps = geom.threads // 32
    if mode == STAGED:
        return base + warps * tiling.stage_bytes(ks, 4)
    if mode == BULK:
        return base + warps * 2 * 2 * 32 * (ks + 1) * 16
    return base


def variants(packs_path: Path | None) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import dtans_decode as DD
    from repro_torch.kernels import tiling
    from repro_torch.kernels.dtans_spmv import MATRIX_ARGS, GEOM_ARGS, \
        kernel_args, raise_on
    from repro_torch.kernels.pack import to_device
    smi = card()
    lib = ctypes.CDLL(str(build_variants()))
    VP, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_variant_launch.argtypes = [I, I, I, I] + MATRIX_ARGS[1:] + \
        GEOM_ARGS + [VP, VP, VP]
    lib.decode_variant_launch.restype = I
    port = DD._lib()
    packs = load_packs(packs_path)
    stream = torch.cuda.current_stream().cuda_stream

    for label, (pm, b_ms, nbytes) in packs.items():
        dm = to_device(pm, "cuda")
        T = dm.tables.shape[0]
        shape = (dm.n_slices, dm.lane_width, DD.out_width(dm))
        want = [t.view(torch.int32) for t in DD.dtans_decode_plain(dm)]
        auto = tiling.decode_geometry(dm.n_slices, dm.lane_width, T, 4)
        print(f"{label}: S={dm.n_slices} L={dm.lane_width} max_nseg="
              f"{dm.max_nseg}, {nbytes} B moved, bound {b_ms:.5f} ms; "
              f"decode_geometry: {auto.units_per_block} units a block, "
              f"{auto.blocks} blocks, {auto.smem} B | {smi}", flush=True)

        def out():
            return (torch.empty(shape, dtype=torch.int32, device="cuda"),
                    torch.empty(shape, dtype=torch.float32, device="cuda"))

        def run_variant(mode, ks, cs, iss):
            base = tiling.geometry(dm.n_slices, dm.lane_width, T, 4)
            smem = variant_smem(mode, ks, base, T)
            g = dataclasses.replace(base, smem=smem, blocks=tiling._blocks(
                -(-base.units // base.units_per_block), base.threads, smem,
                tiling.SM_COUNT))
            cols, vals = out()
            raise_on(port, lib.decode_variant_launch(
                mode, ks, cs, iss, *kernel_args(dm)[1:], *g.args(),
                cols.data_ptr(), vals.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "variant")
            return cols, vals

        def run_port(g):
            cols, vals = out()
            raise_on(port, port.dtans_decode_launch(
                *kernel_args(dm), *g.args(), cols.data_ptr(),
                vals.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "dtans_decode")
            return cols, vals

        def report(what, fn):
            got = fn()
            assert all(torch.equal(a.view(torch.int32), b)
                       for a, b in zip(got, want)), (label, what)
            ms = graph_ms(torch, fn)
            print(f"{label}: {what}: {ms:.4f} ms, {b_ms / ms:.1%} of the "
                  f"bound | {smi}", flush=True)

        for cs in (0, 1):
            st_s = ", st.global.cs" if cs else ""
            report(f"(a) scalar stores{st_s}",
                   lambda: run_variant(SCALAR, 2, cs, 1))
            report(f"(b) 16-byte vectors a thread{st_s}",
                   lambda: run_variant(VEC, 2, cs, 1))
            for ks in STAGES:
                report(f"(c) staged, {ks} segments{st_s}",
                       lambda: run_variant(STAGED, ks, cs, 1))
        for iss in (1, 32):
            for ks in STAGES:
                base = tiling.geometry(dm.n_slices, dm.lane_width, T, 4)
                if variant_smem(BULK, ks, base, T) > tiling.MAX_SMEM_BYTES:
                    continue
                report(f"(d) bulk copy, {ks} segments, issued by "
                       f"{'each lane' if iss == 32 else 'lane 0'}",
                       lambda: run_variant(BULK, ks, 0, iss))
        for upb in ((1, 2) if dm.lane_width > 32 else (4, 8)):
            threads = upb * auto.unit_warps * 32
            smem = tiling.smem_plan(T, dm.lane_width, 4, units_per_block=upb,
                                    stage=tiling.DECODE_STAGE)["total"]
            g = dataclasses.replace(
                auto, units_per_block=upb, threads=threads, smem=smem,
                blocks=tiling._blocks(-(-auto.units // upb), threads, smem,
                                      tiling.SM_COUNT))
            mark = " (default)" if upb == auto.units_per_block else ""
            report(f"port kernel, {upb} units a block ({g.blocks} blocks)"
                   f"{mark}", lambda: run_port(g))
        report("port wrapper dtans_decode", lambda: DD.dtans_decode(dm))
        print(f"{label}: the wrapper as a loop of 20 launches "
              f"{loop_ms(torch, lambda: DD.dtans_decode(dm)):.4f} ms | "
              f"{smi}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wrappers", action="store_true",
                    help="time the dtans_decode wrapper of --src")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="checkout whose src/ --wrappers times")
    ap.add_argument("--packs", type=Path, default=None,
                    help="pickle of the encoded matrices (made if missing)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.wrappers:
        if args.packs is None:
            raise SystemExit("--wrappers needs --packs")
        wrappers(args.src.resolve() / "src", args.packs)
    else:
        variants(args.packs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
