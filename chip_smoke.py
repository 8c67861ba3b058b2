#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each raising on failure (no phase falls back to the CPU):

1. device: the card's name, count and power limit; no CUDA card -> exit 1.
2. build: compiles ``kernels/csrc/*.cu`` with nvcc from the checkout.
3. kernels against their plain torch versions on the card, on seeded
   matrices (f64 and f32, shared and split tables, escape-heavy values, lane
   widths 8..128, empty rows): SpMV and SpMM at B in {3, 64}; a ragged
   column tile (bn=24) and SpMM at B=1 must be bitwise equal to the untiled
   kernel and to SpMV.
4. the main path at full width: the tied LM head of SmolLM-135M (d_model
   576, vocab 49152) compressed by ``SparseLinear.from_dense`` with its
   defaults, serving a few requests through ``apply``; each is held
   against ``apply_dense_reference`` and the plain path, and both kernels'
   launch counters must have risen.
5. times on the card (CUDA events) per batch size: kernel, plain version,
   cuSPARSE (``torch.sparse_csr_tensor @ x``, timed only), dense matmul,
   and the bound.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. ``--json PATH`` also
writes every number it measured to PATH. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.csr_dtans import decode_matrix, encode_matrix  # noqa: E402
from repro_torch.kernels import _build, ops, tiling  # noqa: E402
from repro_torch.kernels import dtans_spmv as K  # noqa: E402
from repro_torch.kernels.pack import pack_matrix, to_device  # noqa: E402
from repro_torch.serving.sparse_linear import SparseLinear  # noqa: E402
from repro_torch.sparse.formats import CSR  # noqa: E402

SEED = 0
D_MODEL, VOCAB = 576, 49152          # src/repro/configs/smollm_135m.py
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12              # H100 SXM, outside the tensor cores
FP64_FLOP_PER_S = 34e12
RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
SOURCE = "src/repro_torch/kernels/csrc/dtans_spmv.cu"
REPLACES = {"dtans_spmv": "src/repro/kernels/dtans_spmv.py:134",
            "dtans_spmm": "src/repro/kernels/dtans_spmv.py:210"}

RESULTS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return (f"{torch.cuda.get_device_name(0)}, power limit "
            f"{RESULTS['device']['power_limit']}")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    RESULTS["device"] = {"name": name, "count": count,
                         "power_limit": smi.split(",")[-1].strip(),
                         "nvidia_smi": smi,
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda}
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 references
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    RESULTS["build_s"] = secs
    log(f"[build] {sorted(libs)} in {secs:.1f} s")
    for stem in libs:
        text = _build.log_path(stem).read_text() if \
            _build.log_path(stem).exists() else ""
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {stem}: {line.strip()}")
    static = K.static_smem_bytes()
    log(f"[build] SpMM static shared memory {static} B "
        f"(tiling.STATIC_SMEM_BYTES = {tiling.STATIC_SMEM_BYTES})")
    if static > tiling.STATIC_SMEM_BYTES:
        raise AssertionError("tiling.STATIC_SMEM_BYTES is below the "
                             "kernel's static shared memory")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _random_csr(m, n, density, dtype, seed, quantized=False) -> CSR:
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    if quantized:
        d = np.round(d * 2) / 2
    d[rng.random((m, n)) >= density] = 0
    return CSR.from_dense(d)


def _stencil(k: int) -> CSR:
    """5-point Laplacian on a k x k grid (f64)."""
    n = k * k
    a = 4.0 * np.eye(n)
    for i in range(n):
        r, c = divmod(i, k)
        for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
            if 0 <= rr < k and 0 <= cc < k:
                a[i, rr * k + cc] = -1.0
    return CSR.from_dense(a)


def _banded_f32(n: int, bw: int) -> CSR:
    rng = np.random.default_rng(7)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        a[i, lo:hi] = rng.standard_normal(hi - lo).astype(np.float32)
    return CSR.from_dense(a)


CASES = [
    # name, matrix factory, lane_width, shared_table
    ("stencil-f64", lambda: _stencil(16), 32, True),
    ("stencil-f64-2tab", lambda: _stencil(16), 32, False),
    ("banded-f32", lambda: _banded_f32(150, 4), 64, True),
    ("random-f64-escapes", lambda: _random_csr(300, 260, 0.3, np.float64, 2),
     16, True),
    ("random-f32-escapes-2tab",
     lambda: _random_csr(300, 260, 0.3, np.float32, 3), 16, False),
    ("quantized-f32", lambda: _random_csr(120, 80, 0.2, np.float32, 4, True),
     32, True),
    ("tall-skinny", lambda: _random_csr(400, 9, 0.5, np.float64, 5), 128,
     True),
    ("wide", lambda: _random_csr(9, 400, 0.4, np.float64, 6), 8, True),
    ("empty-rows", lambda: CSR.from_dense(
        np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)])), 16, True),
]


def _err(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple:
    """(max abs error, passes): |got - want| <= rtol (|want| + max|want|),
    rtol the reference's (1e-4 f32, 1e-12 f64); the max|want| term is the
    floor for rows whose sum cancels."""
    diff = (got - want).abs()
    scale = want.abs().max().item() if want.numel() else 0.0
    ok = bool((diff <= RTOL[dtype] * (want.abs() + scale)).all().item())
    return (diff.max().item() if diff.numel() else 0.0), ok


def phase_kernels() -> None:
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for name, factory, lw, shared in CASES:
        a = factory()
        mat = encode_matrix(a, lane_width=lw, shared_table=shared)
        pm = pack_matrix(mat)
        dm = to_device(pm, "cuda")
        dt = dm.dtype
        n = a.shape[1]
        x = torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
        yk = K.dtans_spmv(dm, x)
        yp = K.dtans_spmv_plain(dm, x)
        torch.cuda.synchronize()
        err, ok = _err(yk, yp, dt)
        dense = torch.as_tensor(a.to_dense(), device="cuda")
        ed, okd = _err(ops.spmv(pm, x), dense @ x, dt)
        assert ok and okd, f"{name}: spmv kernel {err} / dense {ed}"
        worst = err
        # B = 1 through the SpMM kernel and through ops.spmm: bitwise spmv
        assert torch.equal(K.dtans_spmm(dm, x[:, None])[..., 0], yk), \
            f"{name}: spmm kernel at B=1 != spmv kernel"
        assert torch.equal(ops.spmm(pm, x[:, None])[:, 0], ops.spmv(pm, x)), \
            f"{name}: ops.spmm at B=1 != ops.spmv"
        for B in (3, 64):
            X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dt,
                                device="cuda")
            Yk = K.dtans_spmm(dm, X)
            Yp = K.dtans_spmm_plain(dm, X)
            Yt = K.dtans_spmm(dm, X, bn=24)
            torch.cuda.synchronize()
            err, ok = _err(Yk, Yp, dt)
            assert ok, f"{name}: spmm B={B} kernel vs plain {err}"
            assert torch.equal(Yt, Yk), f"{name}: tiled bn=24 != untiled, B={B}"
            worst = max(worst, err)
        esc = int(mat.esc_count_by_domain.sum())
        rows.append({"case": name, "lane_width": lw, "dtype": str(dt),
                     "tables": len(mat.tables), "escapes": esc,
                     "max_abs_err": worst})
        log(f"[kernels] {name:24s} L={lw:3d} {str(dt):13s} "
            f"T={len(mat.tables)} esc={esc:6d} max|k-plain|={worst:.3e} ok")
    RESULTS["kernel_cases"] = rows


# ---------------------------------------------------------------------------
# 4. the main path at full width
# ---------------------------------------------------------------------------

REQUESTS = [
    # name, input shape, bn
    ("decode-step", (4, 1, D_MODEL), None),
    ("B=1", (1, D_MODEL), None),
    ("B=8", (8, D_MODEL), None),
    ("B=64", (64, D_MODEL), None),
    ("B=512 bn=64", (512, D_MODEL), 64),
]


def phase_main_path() -> SparseLinear:
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    t0 = time.perf_counter()
    sl = SparseLinear.from_dense(w, sparsity=0.8, value_bits=8,
                                 lane_width=128, shared_table=True,
                                 device="cuda")
    enc_s = time.perf_counter() - t0
    pm = sl.packed
    RESULTS["head"] = {
        "d_in": sl.d_in, "d_out": sl.d_out, "nnz": sl.mat.nnz,
        "encode_s": enc_s, "compressed_bytes": sl.compressed_bytes,
        "dense_bytes": sl.dense_bytes, "baseline_bytes": sl.baseline_bytes,
        "compression_vs_dense": sl.compression_vs_dense,
        "compression_vs_best_sparse": sl.compression_vs_best_sparse,
        "slices": pm.n_slices, "max_nseg": pm.max_nseg,
        "stream_words": int(sl.mat.stream.size),
        "escapes": int(sl.mat.esc_count_by_domain.sum()),
        "max_table_base": int(pm.tab_base.max()),
    }
    log(f"[main] head W^T {VOCAB}x{D_MODEL} f32, nnz {sl.mat.nnz}, encode "
        f"{enc_s:.1f} s, {sl.compressed_bytes} B compressed: "
        f"{sl.compression_vs_dense:.3f}x vs dense, "
        f"{sl.compression_vs_best_sparse:.3f}x vs best sparse "
        f"({sl.baseline_bytes} B); S={pm.n_slices} "
        f"max_nseg={pm.max_nseg} max base={int(pm.tab_base.max())}")

    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda") for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    ys = [sl.apply(x, bn=bn) for x, (_, _, bn) in zip(xs, REQUESTS)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = dict(K.launches)
    log(f"[main] served {len(REQUESTS)} requests in {serve_s * 1e3:.1f} ms "
        f"(first calls included); launches {counts}")
    assert counts["dtans_spmv"] > 0 and counts["dtans_spmm"] > 0, counts
    RESULTS["launches"] = counts

    dm = to_device(pm, "cuda")
    errs = {"dtans_spmv": 0.0, "dtans_spmm": 0.0}
    rels = dict(errs)
    for (name, shape, bn), x, y in zip(REQUESTS, xs, ys):
        assert y.shape == (*shape[:-1], VOCAB) and torch.isfinite(y).all()
        ref = sl.apply_dense_reference(x)
        xb = x.reshape(-1, D_MODEL)
        B = xb.shape[0]
        if B == 1:
            plain = K.dtans_spmv_plain(dm, xb[0]).reshape(-1)[:VOCAB, None]
            kern = "dtans_spmv"
        else:
            plain = K.dtans_spmm_plain(dm, xb.T.contiguous(), bn).reshape(
                -1, B)[:VOCAB]
            kern = "dtans_spmm"
        plain = plain.T.reshape(y.shape)
        torch.cuda.synchronize()
        ok_ref = torch.allclose(y, ref, rtol=1e-4, atol=1e-5)
        e_plain, ok_plain = _err(y, plain, torch.float32)
        e_ref = (y - ref).abs().max().item()
        errs[kern] = max(errs[kern], e_plain)
        rels[kern] = max(rels[kern], e_plain / max(
            plain.abs().max().item(), 1e-30))
        log(f"[main] {name:12s} out {tuple(y.shape)} |y-dense|={e_ref:.3e} "
            f"|y-plain|={e_plain:.3e}")
        assert ok_ref and ok_plain, f"{name}: dense {e_ref} plain {e_plain}"
    RESULTS["main_max_abs_err"] = errs
    RESULTS["main_max_rel_err"] = rels
    return sl


# ---------------------------------------------------------------------------
# 5. times
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def bound(sl: SparseLinear, B: int) -> tuple[float, str, int, int]:
    """Least time for one pass at batch B: the larger of the bytes the
    function must move (compressed stream and escape words actually
    present, one per-lane count array, coding tables, x, y; each once)
    over the HBM rate, and its multiply-adds (2 nnz B) over the f32 rate.
    The kernels also read ``ns``, but it is ``2 * nnz`` and not needed."""
    mat, pm = sl.mat, sl.packed
    item = pm.dtype.itemsize
    nbytes = (int(mat.stream.size) * 4
              + sum(int(e.size) for e in mat.esc_streams) * 8
              + pm.nnz.nbytes
              + pm.tab_symbol.size * (8 + 4 + 4 + 4)
              + sl.d_in * B * item + sl.d_out * B * item)
    flops = 2 * mat.nnz * B
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP64_FLOP_PER_S if item == 8 else FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_times(sl: SparseLinear) -> list:
    dm = to_device(sl.packed, "cuda")
    csr = decode_matrix(sl.mat)
    a_csr = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, device="cuda"),
        torch.as_tensor(csr.indices, device="cuda"),
        torch.as_tensor(csr.values, device="cuda"),
        size=csr.shape, check_invariants=False)
    w_dense = sl.dense_weight
    rng = np.random.default_rng(SEED + 2)
    log(f"[times] compressed head {RESULTS['head']['compressed_bytes']} B, "
        f"CSR {sl.mat.nnz * 8 + (sl.d_out + 1) * 4} B, dense "
        f"{sl.dense_bytes} B: all but dense fit the 50 MB L2, so repeated "
        f"launches run with the matrix warm in L2")
    rows = []
    for B, bn in ((1, None), (4, None), (8, None), (64, None), (512, 64)):
        x = torch.as_tensor(rng.standard_normal((D_MODEL, B)),
                            dtype=torch.float32, device="cuda")
        if B == 1:
            x1 = x[:, 0].contiguous()
            kern = "dtans_spmv"
            k_ms = time_ms(lambda: K.dtans_spmv(dm, x1), 50)
            p_ms = time_ms(lambda: K.dtans_spmv_plain(dm, x1), 3, 1)
        else:
            kern = "dtans_spmm"
            k_ms = time_ms(lambda: K.dtans_spmm(dm, x, bn=bn), 20)
            p_ms = time_ms(lambda: K.dtans_spmm_plain(dm, x, bn), 3, 1)
        lib_ms = time_ms(lambda: a_csr @ x, 50)
        dense_ms = time_ms(lambda: w_dense @ x, 50)
        b_ms, b_by, nbytes, flops = bound(sl, B)
        row = {"kernel": kern, "B": B, "bn": bn, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": lib_ms, "dense_ms": dense_ms, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": nbytes, "flops": flops}
        rows.append(row)
        log(f"[times] {kern} B={B:3d} bn={bn} kernel {k_ms:.4f} ms | plain "
            f"{p_ms:.2f} ms | cuSPARSE {lib_ms:.4f} ms | dense {dense_ms:.4f}"
            f" ms | bound {b_ms:.5f} ms ({b_by}) | {card()}")
    RESULTS["times"] = rows
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_kernels()
    sl = phase_main_path()
    times = phase_times(sl)
    pick = {"dtans_spmv": 1, "dtans_spmm": 64}  # rows of the kernels line
    kernels = []
    for name, B in pick.items():
        t = next(r for r in times if r["kernel"] == name and r["B"] == B)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": RESULTS["launches"][name],
            "max_abs_err": RESULTS["main_max_abs_err"][name],
            "max_rel_err": RESULTS["main_max_rel_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "B": B})
    RESULTS["kernels"] = kernels
    RESULTS["total_s"] = time.perf_counter() - t_start
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(RESULTS, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(RESULTS["device"]["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
