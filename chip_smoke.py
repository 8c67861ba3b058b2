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
   kernel and to SpMV. The same matrices packed as SELL (slice heights 16,
   32, 128) and RGCSR (groups 4, 8, 16, 32) go through the comparator
   kernels the same way, each SpMM column bitwise its SpMV; two RGCSR-dtANS
   encodes go through the dtANS kernels.
4. the main path at full width: the tied LM head of SmolLM-135M (d_model
   576, vocab 49152) compressed by ``SparseLinear.from_dense`` with its
   defaults, serving a few requests through ``apply``; each is held
   against ``apply_dense_reference`` and the plain path, and both kernels'
   launch counters must have risen.
4b. the comparator path at full width: the head's own pruned matrix packed
   as SELL (slice height 32) and RGCSR (groups 4 and 32) serves the same
   request shapes through ``ops.sell_spmm`` / ``ops.rgcsr_spmm``, held
   against the dense product and the plain versions; all four comparator
   kernels' launch counters must have risen.
5. times on the card (CUDA events) per batch size: kernel, plain version,
   cuSPARSE (``torch.sparse_csr_tensor @ x``, timed only), dense matmul,
   and the bound, for the dtANS kernels and the comparators.

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
from repro_torch.core.rgcsr_dtans import encode_rgcsr_matrix  # noqa: E402
from repro_torch.kernels import _build, ops, tiling  # noqa: E402
from repro_torch.kernels import dtans_spmv as K  # noqa: E402
from repro_torch.kernels import rgcsr_spmv as RG  # noqa: E402
from repro_torch.kernels import sell_spmv as SE  # noqa: E402
from repro_torch.kernels.pack import pack_matrix, to_device  # noqa: E402
from repro_torch.serving.sparse_linear import SparseLinear  # noqa: E402
from repro_torch.sparse.formats import CSR  # noqa: E402
from repro_torch.sparse.random_graphs import stencil_2d  # noqa: E402
from repro_torch.sparse.rgcsr import RGCSR  # noqa: E402

SEED = 0
D_MODEL, VOCAB = 576, 49152          # src/repro/configs/smollm_135m.py
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12              # H100 SXM, outside the tensor cores
FP64_FLOP_PER_S = 34e12
RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"dtans_spmv": CSRC + "dtans_spmv.cu",
          "dtans_spmm": CSRC + "dtans_spmv.cu",
          "sell_spmv": CSRC + "sell_spmv.cu",
          "sell_spmm": CSRC + "sell_spmv.cu",
          "rgcsr_spmv": CSRC + "rgcsr_spmv.cu",
          "rgcsr_spmm": CSRC + "rgcsr_spmv.cu"}
REPLACES = {"dtans_spmv": "src/repro/kernels/dtans_spmv.py:134",
            "dtans_spmm": "src/repro/kernels/dtans_spmv.py:210",
            "sell_spmv": "src/repro/kernels/sell_spmv.py:60",
            "sell_spmm": "src/repro/kernels/sell_spmv.py:96",
            "rgcsr_spmv": "src/repro/kernels/rgcsr_spmv.py:73",
            "rgcsr_spmm": "src/repro/kernels/rgcsr_spmv.py:117"}
L2_BYTES = 50 * 10**6                # H100 SXM L2 cache
SELL_L, RGCSR_G = (16, 32, 128), (4, 8, 16, 32)   # phase 3 layouts
# Per comparator format: the SpMV / SpMM wrappers, their plain versions,
# the ops entries and the launch counters.
WRAPPERS = {
    "sell": (SE.sell_spmv, SE.sell_spmm, SE.sell_spmv_plain,
             SE.sell_spmm_plain, ops.sell_spmv, ops.sell_spmm, SE.launches),
    "rgcsr": (RG.rgcsr_spmv, RG.rgcsr_spmm, RG.rgcsr_spmv_plain,
              RG.rgcsr_spmm_plain, ops.rgcsr_spmv, ops.rgcsr_spmm,
              RG.launches),
}

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


def _banded_f32(n: int, bw: int) -> CSR:
    rng = np.random.default_rng(7)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        a[i, lo:hi] = rng.standard_normal(hi - lo).astype(np.float32)
    return CSR.from_dense(a)


CASES = [
    # name, matrix factory, lane_width, shared_table
    ("stencil-f64", lambda: stencil_2d(16), 32, True),
    ("stencil-f64-2tab", lambda: stencil_2d(16), 32, False),
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


def _check_dtans(name: str, a: CSR, mat, rng) -> float:
    """The dtANS kernels on one encoded matrix against their plain versions
    and the dense product; returns the largest |kernel - plain|."""
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
    return worst


def _comparator_packs(a: CSR):
    """``a`` in every comparator layout of phase 3: (label, format, pack)."""
    for L in SELL_L:
        yield f"sell L={L}", "sell", SE.pack_sell(a, L)
    for G in RGCSR_G:
        yield f"rgcsr G={G}", "rgcsr", RG.pack_rgcsr(RGCSR.from_csr(a, G))


def _check_comparators(name: str, a: CSR, rng) -> float:
    """SELL and RGCSR kernels against their plain versions and the dense
    product; tiles, B=1 and every SpMM column bitwise. Returns the largest
    |kernel - plain|."""
    dense = torch.as_tensor(a.to_dense(), device="cuda")
    n = a.shape[1]
    worst = 0.0
    for label, fmt, pk in _comparator_packs(a):
        spmv, spmm, spmv_plain, spmm_plain, op_spmv, op_spmm, _ = \
            WRAPPERS[fmt]
        dm = (SE if fmt == "sell" else RG).to_device(pk, "cuda")
        dt = dm.dtype
        what = f"{name} {label}"
        x = torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
        yk = spmv(dm, x)
        err, ok = _err(yk, spmv_plain(dm, x), dt)
        ed, okd = _err(op_spmv(pk, x), dense @ x, dt)
        assert ok and okd, f"{what}: spmv kernel {err} / dense {ed}"
        worst = max(worst, err)
        assert torch.equal(spmm(dm, x[:, None])[..., 0], yk), \
            f"{what}: spmm kernel at B=1 != spmv kernel"
        assert torch.equal(op_spmm(pk, x[:, None])[:, 0], op_spmv(pk, x)), \
            f"{what}: ops spmm at B=1 != ops spmv"
        for B in (3, 64):
            X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dt,
                                device="cuda")
            Yk = spmm(dm, X)
            err, ok = _err(Yk, spmm_plain(dm, X), dt)
            ed, okd = _err(op_spmm(pk, X), dense @ X, dt)
            assert ok and okd, f"{what}: spmm B={B} kernel {err} / dense {ed}"
            assert torch.equal(spmm(dm, X, bn=24), Yk), \
                f"{what}: tiled bn=24 != untiled, B={B}"
            for b in range(B):
                yb = spmv(dm, X[:, b].contiguous())
                assert torch.equal(Yk[..., b], yb), \
                    f"{what}: spmm column {b} != spmv, B={B}"
            worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


def phase_kernels() -> None:
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for name, factory, lw, shared in CASES:
        a = factory()
        mat = encode_matrix(a, lane_width=lw, shared_table=shared)
        worst = _check_dtans(name, a, mat, rng)
        worst_cmp = _check_comparators(name, a, rng)
        esc = int(mat.esc_count_by_domain.sum())
        dt = "float64" if a.values.dtype == np.float64 else "float32"
        rows.append({"case": name, "lane_width": lw, "dtype": dt,
                     "tables": len(mat.tables), "escapes": esc,
                     "max_abs_err": worst, "comparators_max_abs_err":
                     worst_cmp})
        log(f"[kernels] {name:24s} L={lw:3d} {dt:7s} T={len(mat.tables)} "
            f"esc={esc:6d} max|k-plain| dtans={worst:.3e} "
            f"sell/rgcsr={worst_cmp:.3e} ok")
    for name, a, G in (
            ("rgcsr-dtans stencil6 G=8", stencil_2d(6), 8),
            ("rgcsr-dtans random-f32 G=16",
             _random_csr(300, 260, 0.3, np.float32, 3), 16)):
        worst = _check_dtans(name, a, encode_rgcsr_matrix(a, group_size=G),
                             rng)
        rows.append({"case": name, "lane_width": G, "max_abs_err": worst})
        log(f"[kernels] {name:28s} max|k-plain|={worst:.3e} ok")
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
# 4b. the comparator path at full width
# ---------------------------------------------------------------------------

# The head's comparator layouts: SELL at the format registry's slice height,
# RGCSR at its default group and at a warp-sized group.
HEAD_PACKS = (("sell L=32", "sell", 32), ("rgcsr G=4", "rgcsr", 4),
              ("rgcsr G=32", "rgcsr", 32))


def _real_bytes(csr: CSR, fmt: str, rows: int) -> int:
    """Index and value bytes of the real entries, plus RGCSR's per-row
    counts (S * G of them)."""
    nbytes = csr.nnz * (4 + csr.values.dtype.itemsize)
    if fmt == "rgcsr":
        nbytes += -(-csr.shape[0] // rows) * rows * 4
    return nbytes


def phase_comparators(sl: SparseLinear) -> tuple[CSR, dict]:
    """Serves the request shapes through the comparator ops on the head's
    own pruned matrix; returns the CSR and the packs by label."""
    t0 = time.perf_counter()
    csr = decode_matrix(sl.mat)
    packs = {}
    for label, fmt, rows in HEAD_PACKS:
        pk = (SE.pack_sell(csr, rows) if fmt == "sell"
              else RG.pack_rgcsr(RGCSR.from_csr(csr, rows)))
        packs[label] = (fmt, rows, pk,
                        (SE if fmt == "sell" else RG).to_device(pk, "cuda"))
    pack_s = time.perf_counter() - t0
    wg = next(iter(packs.values()))[3].values.shape[1]
    log(f"[cmp] head CSR nnz {csr.nnz}, longest row {wg}; packed and "
        f"uploaded in {pack_s:.1f} s")
    sizes = {}
    for label, (fmt, rows, pk, dm) in packs.items():
        real = _real_bytes(csr, fmt, rows)
        sizes[label] = {"stored_bytes": dm.nbytes, "real_bytes": real}
        log(f"[cmp] {label:10s} stored {dm.nbytes} B on the card (padded), "
            f"{real} B of real entries, vs {sl.compressed_bytes} B for the "
            f"dtANS head; {'fits' if dm.nbytes <= L2_BYTES else 'exceeds'} "
            f"the 50 MB L2, so warm repeats "
            f"{'stay in L2' if dm.nbytes <= L2_BYTES else 're-read HBM'}")
    RESULTS["comparator_packs"] = sizes

    rng = np.random.default_rng(SEED + 3)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda").reshape(-1, D_MODEL).T.contiguous()
          for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    SE.reset_launches()
    RG.reset_launches()
    t0 = time.perf_counter()
    ys = {label: [WRAPPERS[fmt][5](pk, X, bn=bn)
                  for X, (_, _, bn) in zip(xs, REQUESTS)]
          for label, (fmt, _, pk, _) in packs.items()}
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = {**SE.launches, **RG.launches}
    log(f"[cmp] served {len(REQUESTS)} request shapes x {len(packs)} packs "
        f"in {serve_s * 1e3:.1f} ms; launches {counts}")
    assert all(v > 0 for v in counts.values()), counts
    RESULTS["launches"].update(counts)

    errs = {k: 0.0 for k in counts}
    rels = dict(errs)
    w_dense = sl.dense_weight
    for label, (fmt, _, _, dm) in packs.items():
        _, _, spmv_plain, spmm_plain, *_ = WRAPPERS[fmt]
        for (name, _, bn), X, y in zip(REQUESTS, xs, ys[label]):
            B = X.shape[1]
            assert y.shape == (VOCAB, B) and torch.isfinite(y).all()
            if B == 1:
                plain = spmv_plain(dm, X[:, 0]).reshape(-1)[:VOCAB, None]
                kern = f"{fmt}_spmv"
            else:
                plain = spmm_plain(dm, X, bn).reshape(-1, B)[:VOCAB]
                kern = f"{fmt}_spmm"
            e_dense, ok_dense = _err(y, w_dense @ X, torch.float32)
            e_plain, ok_plain = _err(y, plain, torch.float32)
            errs[kern] = max(errs[kern], e_plain)
            rels[kern] = max(rels[kern], e_plain / max(
                plain.abs().max().item(), 1e-30))
            log(f"[cmp] {label:10s} {name:12s} |y-dense|={e_dense:.3e} "
                f"|y-plain|={e_plain:.3e}")
            assert ok_dense and ok_plain, \
                f"{label} {name}: dense {e_dense} plain {e_plain}"
    RESULTS["main_max_abs_err"].update(errs)
    RESULTS["main_max_rel_err"].update(rels)
    return csr, packs


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


def _roofline(nbytes: int, flops: int, itemsize: int) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over the
    card's rate for the type, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP64_FLOP_PER_S if itemsize == 8
                     else FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound(sl: SparseLinear, B: int) -> tuple[float, str, int, int]:
    """Least time for one dtANS pass at batch B: the larger of the bytes
    the function must move (compressed stream and escape words actually
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
    return (*_roofline(nbytes, flops, item), nbytes, flops)


def comparator_bound(csr: CSR, fmt: str, rows: int,
                     B: int) -> tuple[float, str, int, int]:
    """Least time for one SELL / RGCSR pass at batch B: the real entries'
    bytes (`_real_bytes`, no padding), x and y once each, against 2 nnz B
    operations."""
    item = csr.values.dtype.itemsize
    nbytes = (_real_bytes(csr, fmt, rows) + D_MODEL * B * item
              + VOCAB * B * item)
    flops = 2 * csr.nnz * B
    return (*_roofline(nbytes, flops, item), nbytes, flops)


def phase_times(sl: SparseLinear, csr: CSR, packs: dict) -> list:
    dm = to_device(sl.packed, "cuda")
    a_csr = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, device="cuda"),
        torch.as_tensor(csr.indices, device="cuda"),
        torch.as_tensor(csr.values, device="cuda"),
        size=csr.shape, check_invariants=False)
    w_dense = sl.dense_weight
    rng = np.random.default_rng(SEED + 2)
    log(f"[times] compressed head {RESULTS['head']['compressed_bytes']} B, "
        f"CSR {sl.mat.nnz * 8 + (sl.d_out + 1) * 4} B, dense "
        f"{sl.dense_bytes} B, the 50 MB L2 holds all but dense, so repeated "
        f"dtANS launches run with the matrix warm in L2 (the comparator "
        f"packs: see [cmp])")
    rows = []

    def add(kern, label, B, bn, k_ms, p_ms, lib_ms, dense_ms, b):
        b_ms, b_by, nbytes, flops = b
        rows.append({"kernel": kern, "pack": label, "B": B, "bn": bn,
                     "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                     "dense_ms": dense_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "flops": flops})
        log(f"[times] {kern:10s} {label:10s} B={B:3d} bn={bn} kernel "
            f"{k_ms:.4f} ms | plain {p_ms:.2f} ms | cuSPARSE {lib_ms:.4f} ms"
            f" | dense {dense_ms:.4f} ms | bound {b_ms:.5f} ms ({b_by}) | "
            f"{card()}")

    for B, bn in ((1, None), (4, None), (8, None), (64, None), (512, 64)):
        x = torch.as_tensor(rng.standard_normal((D_MODEL, B)),
                            dtype=torch.float32, device="cuda")
        x1 = x[:, 0].contiguous()
        lib_ms = time_ms(lambda: a_csr @ x, 50)
        dense_ms = time_ms(lambda: w_dense @ x, 50)
        if B == 1:
            k_ms = time_ms(lambda: K.dtans_spmv(dm, x1), 50)
            p_ms = time_ms(lambda: K.dtans_spmv_plain(dm, x1), 3, 1)
        else:
            k_ms = time_ms(lambda: K.dtans_spmm(dm, x, bn=bn), 20)
            p_ms = time_ms(lambda: K.dtans_spmm_plain(dm, x, bn), 3, 1)
        add("dtans_spmv" if B == 1 else "dtans_spmm", "dtans L=128", B, bn,
            k_ms, p_ms, lib_ms, dense_ms, bound(sl, B))
        for label, (fmt, prows, _, cm) in packs.items():
            spmv, spmm, spmv_plain, spmm_plain, *_ = WRAPPERS[fmt]
            if B == 1:
                k_ms = time_ms(lambda: spmv(cm, x1), 50)
                p_ms = time_ms(lambda: spmv_plain(cm, x1), 3, 1)
            else:
                k_ms = time_ms(lambda: spmm(cm, x, bn=bn), 20)
                p_ms = time_ms(lambda: spmm_plain(cm, x, bn), 3, 1)
            add(f"{fmt}_spmv" if B == 1 else f"{fmt}_spmm", label, B, bn,
                k_ms, p_ms, lib_ms, dense_ms,
                comparator_bound(csr, fmt, prows, B))
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
    csr, packs = phase_comparators(sl)
    times = phase_times(sl, csr, packs)
    # rows of the kernels line: SpMV at B=1, SpMM at B=64; the comparators
    # at the format registry's layouts
    pick = {"dtans_spmv": ("dtans L=128", 1),
            "dtans_spmm": ("dtans L=128", 64),
            "sell_spmv": ("sell L=32", 1), "sell_spmm": ("sell L=32", 64),
            "rgcsr_spmv": ("rgcsr G=4", 1), "rgcsr_spmm": ("rgcsr G=4", 64)}
    kernels = []
    for name, (label, B) in pick.items():
        t = next(r for r in times if r["kernel"] == name
                 and r["pack"] == label and r["B"] == B)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": RESULTS["launches"][name],
            "max_abs_err": RESULTS["main_max_abs_err"][name],
            "max_rel_err": RESULTS["main_max_rel_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "B": B})
    RESULTS["kernels"] = kernels
    RESULTS["total_s"] = time.perf_counter() - t_start
    log(f"[done] all phases in {RESULTS['total_s']:.1f} s")
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
