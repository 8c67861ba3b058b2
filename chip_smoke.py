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
   kernel and to SpMV; ``ops.decode`` must give `decode_ref`'s columns and
   value bits. The same matrices packed as SELL (slice heights 16, 32,
   128), RGCSR (groups 4, 8, 16, 32) and BCSR (every registry block shape)
   go through the comparator kernels the same way, bitwise their plain
   versions, each SpMM column bitwise its SpMV; two RGCSR-dtANS encodes go
   through the dtANS kernels, and BCSR-dtANS encodes at 2x2, 4x4 and 40x2
   through the fused shared-column kernels, bitwise their plain versions
   and the generic kernels. Hand-made SELL and RGCSR packs that no matrix
   packs to (-1 holes before real entries, deltas past each row's count,
   int32 running sums past 2^31, rows of 0, 1, 3, 4, 5 and 9 entries; x
   of 13 and 13,000 rows) hold the SpMV and SpMM bitwise their plain
   versions. A lane-width sweep (L in `SWEEP_L`, 1 to 1024)
   holds the dtANS kernels and decode bitwise against their plain versions
   on an escape-heavy quantized f32 matrix, an f64 matrix with two tables
   and a matrix whose table base reaches 256 (a digit group's radix of
   2^32), with tiles, B=1 SpMM vs SpMV and ``pipeline=True`` vs ``False``;
   ``ops.spmm`` at L = 1024 (one SpMV launch a column) and with ``bn=400``
   at L = 128 (a tile cut to fit shared memory), bitwise the plain SpMM.
4. the main path at full width: the tied LM head of SmolLM-135M (d_model
   576, vocab 49152) compressed by ``SparseLinear.from_dense`` with its
   defaults, serving a few requests through ``apply``; each is held
   against ``apply_dense_reference`` and the plain path, and both kernels'
   launch counters must have risen.
4b. the comparator path at full width: the head's own pruned matrix packed
   as SELL (slice height 32), RGCSR (groups 4 and 32) and BCSR (2x2) serves
   the same request shapes through ``ops.sell_spmm`` / ``ops.rgcsr_spmm`` /
   ``ops.bcsr_spmm``, held against the dense product and, bitwise, the
   plain versions; all six comparator kernels' launch counters must have
   risen.
4c. the blocked path at full width: the head's shape pruned in 4x4 tiles
   (`block_sparse`, density 0.2, 8-bit codebook) encoded as BCSR-dtANS
   4x4 and served by a ``SparseLinear`` through the fused shared-column
   kernels (their counters must rise), held against the dense product, the
   fused plain version and, bitwise, the generic kernels
   (``fused=False``); the same matrix as BCSR 4x4 through
   ``ops.bcsr_spmm``.
4d. decode: ``ops.decode`` of the phase-4 head and the phase-4c matrix,
   columns and value bits equal to `decode_ref` and the real entries
   exactly the host's `decode_matrix`; the kernel's counter must rise.
4e. the autotuned head: the phase-4 weight built by
   ``SparseLinear.from_dense(auto=True, autotune_measure=True)`` (budget
   2, B=64, the `H100` cost model, a memory-only decision cache): the two
   best-modeled entropy-coded candidates are encoded and their CUDA
   kernels timed (CUDA graphs between CUDA events); the winner, the
   runner-up and phase 4's configuration are timed again as phase 5 times
   and the script says whether the ranking holds; the winner serves the phase-4
   request shapes, each held against the dense product of the head's
   pruned weight and, bitwise, the winner's plain path on the card (and
   phase 4's outputs, where it picks phase 4's configuration); the
   winner's launch counters must have risen.
4f. the registry and calibration on the card: every registered format's
   ``FormatSpec`` runners (B = 1, 8) on two of `measure._calibration_suite`'s
   matrices, the kernel-backed ones bitwise their plain versions, csr /
   coo / dense within tolerance of the dense product (every comparator and
   dtANS kernel's counter must rise); then ``measure.calibrate(base=H100,
   small=True)`` fits the cost model to the kernels' CUDA-event times and
   prints the fitted constants beside the data-sheet seed.
5. times on the card (CUDA events) per batch size: kernel, plain version,
   the library calls (cuSPARSE CSR ``torch.sparse_csr_tensor @ x``, and
   BSR ``torch.sparse_bsr_tensor @ x`` for the blocked rows where it runs;
   timed only; a row's ``library_ms`` is the faster of them), dense
   matmul, and the bound, for every kernel; the SELL, RGCSR and BCSR SpMM
   rows (B = 4, 8, 64, 512) also as a ratio to cuSPARSE CSR. The B=1
   rows (kernel and library calls) are timed without the Python loop
   around the entry point: the median of 5 replays of a CUDA graph of 20
   calls (where capture fails, of loops of the C entry alone), the loop's
   time of earlier runs beside; decode is timed the same way. Phase 2 logs
   the registers and spills of every SELL / RGCSR / BCSR SpMM and SpMV
   instantiation and of the decode kernel's (f32 / f64, each block
   size).

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. ``--json PATH`` also
writes every number it measured to PATH. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.append(str(ROOT / "tests"))  # hand_made_packs

import torch  # noqa: E402

from repro_torch.autotune import H100, DecisionCache, measure  # noqa: E402
from repro_torch.core.bcsr_dtans import encode_bcsr_matrix  # noqa: E402
from repro_torch.core.csr_dtans import decode_matrix, encode_matrix  # noqa: E402
from repro_torch.core.rgcsr_dtans import encode_rgcsr_matrix  # noqa: E402
from repro_torch.kernels import _build, ops, tiling  # noqa: E402
from repro_torch.kernels import bcsr_spmv as BC  # noqa: E402
from repro_torch.kernels import dtans_decode as DD  # noqa: E402
from repro_torch.kernels import dtans_spmv as K  # noqa: E402
from repro_torch.kernels import rgcsr_spmv as RG  # noqa: E402
from repro_torch.kernels import sell_spmv as SE  # noqa: E402
from repro_torch.kernels.pack import pack_matrix, to_device  # noqa: E402
from repro_torch.kernels.ref import decode_ref  # noqa: E402
from repro_torch.serving.sparse_linear import SparseLinear  # noqa: E402
from repro_torch.sparse.bcsr import BCSR, BCSR_BLOCK_SHAPES  # noqa: E402
from repro_torch.sparse.formats import CSR, best_baseline_nbytes  # noqa: E402
from repro_torch.sparse.prune import codebook_quantize, magnitude_prune  # noqa: E402
from repro_torch.sparse.random_graphs import block_sparse, stencil_2d  # noqa: E402
from repro_torch.sparse import registry  # noqa: E402
from repro_torch.sparse.rgcsr import RGCSR  # noqa: E402

from hand_made_packs import HAND_MADE  # noqa: E402

SEED = 0
D_MODEL, VOCAB = 576, 49152          # src/repro/configs/smollm_135m.py
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12              # H100 SXM, outside the tensor cores
FP64_FLOP_PER_S = 34e12
RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"dtans_spmv": CSRC + "dtans_spmv.cu",
          "dtans_spmm": CSRC + "dtans_spmv.cu",
          "dtans_spmv_shared": CSRC + "dtans_spmv.cu",
          "dtans_spmm_shared": CSRC + "dtans_spmv.cu",
          "dtans_decode": CSRC + "dtans_decode.cu",
          "sell_spmv": CSRC + "sell_spmv.cu",
          "sell_spmm": CSRC + "sell_spmv.cu",
          "rgcsr_spmv": CSRC + "rgcsr_spmv.cu",
          "rgcsr_spmm": CSRC + "rgcsr_spmv.cu",
          "bcsr_spmv": CSRC + "bcsr_spmv.cu",
          "bcsr_spmm": CSRC + "bcsr_spmv.cu"}
REPLACES = {"dtans_spmv": "src/repro/kernels/dtans_spmv.py:134",
            "dtans_spmm": "src/repro/kernels/dtans_spmv.py:210",
            "dtans_spmv_shared": "src/repro/kernels/dtans_spmv.py:117",
            "dtans_spmm_shared": "src/repro/kernels/dtans_spmv.py:189",
            "dtans_decode": "src/repro/kernels/dtans_decode.py:54",
            "sell_spmv": "src/repro/kernels/sell_spmv.py:60",
            "sell_spmm": "src/repro/kernels/sell_spmv.py:96",
            "rgcsr_spmv": "src/repro/kernels/rgcsr_spmv.py:73",
            "rgcsr_spmm": "src/repro/kernels/rgcsr_spmv.py:117",
            "bcsr_spmv": "src/repro/kernels/bcsr_spmv.py:77",
            "bcsr_spmm": "src/repro/kernels/bcsr_spmv.py:111"}
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
    "bcsr": (BC.bcsr_spmv, BC.bcsr_spmm, BC.bcsr_spmv_plain,
             BC.bcsr_spmm_plain, ops.bcsr_spmv, ops.bcsr_spmm, BC.launches),
}
MODULES = {"sell": SE, "rgcsr": RG, "bcsr": BC}


def comparator_pack(csr: CSR, fmt: str, rows):
    """``csr`` packed as ``fmt``: SELL at slice height ``rows``, RGCSR at
    group size ``rows``, BCSR at block shape ``rows``."""
    if fmt == "sell":
        return SE.pack_sell(csr, rows)
    if fmt == "rgcsr":
        return RG.pack_rgcsr(RGCSR.from_csr(csr, rows))
    return BC.pack_bcsr(BCSR.from_csr(csr, rows))

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
    RESULTS["kernel_registers"] = rows = kernel_registers()
    for r in rows:
        log(f"[build] {r['stem']} {r['kernel']}<{r['type']}, {r['args']}>: "
            f"{r['registers']} registers, spill {r['spill_stores']} B "
            f"stores / {r['spill_loads']} B loads")
    static = K.static_smem_bytes()
    log(f"[build] SpMM static shared memory {static} B "
        f"(tiling.STATIC_SMEM_BYTES = {tiling.STATIC_SMEM_BYTES})")
    if static > tiling.STATIC_SMEM_BYTES:
        raise AssertionError("tiling.STATIC_SMEM_BYTES is below the "
                             "kernel's static shared memory")


_WARP_KERNEL = re.compile(r"spmm_warp_kernelI([fd]).*?ELi(\d+)ELi(\d+)"
                          r"ENS_\d+(StagedX|GlobalX)")
_BCSR_SPMV = re.compile(r"bcsr_spmv_kernelI([fd])Lb([01])")
_LANES_SPMV = re.compile(r"spmv_lanes_kernelI([fd]).*?(SellRow|RgcsrRow)")
_DECODE = re.compile(r"dtans_decode_kernelI([fd])Li(\d+)E")


def _kernel_name(mangled: str) -> tuple | None:
    """(kernel, value type, template arguments) of a padded SpMM, SELL /
    RGCSR SpMV, BCSR SpMV or decode instantiation's mangled name, else
    None."""
    m = _DECODE.search(mangled)
    if m:
        return ("dtans_decode_kernel", m.group(1),
                f"threads<={m.group(2)}")
    m = _WARP_KERNEL.search(mangled)
    if m:
        return ("spmm_warp_kernel", m.group(1),
                f"bw={m.group(2)}, nc={m.group(3)}, {m.group(4)}")
    m = _LANES_SPMV.search(mangled)
    if m:
        return ("spmv_lanes_kernel", m.group(1), m.group(2))
    m = _BCSR_SPMV.search(mangled)
    if m:
        return ("bcsr_spmv_kernel", m.group(1),
                "staged" if m.group(2) == "1" else "L1")
    return None


def kernel_registers() -> list:
    """Registers and spills of every SELL / RGCSR / BCSR SpMM instantiation
    (``spmm_warp_kernel``), SELL / RGCSR SpMV (``spmv_lanes_kernel``), BCSR
    SpMV (``bcsr_spmv_kernel``) and decode (``dtans_decode_kernel``), read
    from the builds' ``-Xptxas -v`` logs."""
    rows = []
    for stem in ("sell_spmv", "rgcsr_spmv", "bcsr_spmv", "dtans_decode"):
        path = _build.log_path(stem)
        cur, spill = None, (0, 0)
        for line in (path.read_text() if path.exists() else "").splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = _kernel_name(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                rows.append({
                    "stem": stem, "kernel": cur[0],
                    "type": "float" if cur[1] == "f" else "double",
                    "args": cur[2],
                    "registers": int(m.group(1)), "spill_stores": spill[0],
                    "spill_loads": spill[1]})
                cur = None
    return rows


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
    _check_decode(name, pm)
    return worst


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _check_decode(name: str, pm) -> None:
    """``ops.decode`` (the kernel) against `decode_ref` (its plain version)
    on the card: columns exactly, values bit for bit."""
    cols, vals = ops.decode(pm)
    want_c, want_v = decode_ref(pm, device="cuda")
    torch.cuda.synchronize()
    assert torch.equal(cols, want_c), f"{name}: decoded columns differ"
    assert torch.equal(_bits(vals), _bits(want_v)), \
        f"{name}: decoded value bits differ"


def _check_fused(name: str, mat, rng) -> None:
    """The fused shared-column kernels on a BCSR-dtANS encode: bitwise
    their plain versions and the generic kernels, tiles and B=1 included,
    and ``ops`` with ``fused=None`` bitwise ``fused=False``."""
    pm = pack_matrix(mat)
    assert pm.shared_cols, f"{name}: BCSR-dtANS pack lacks shared_cols"
    dm = to_device(pm, "cuda")
    n = mat.shape[1]
    x = torch.as_tensor(rng.standard_normal(n), dtype=dm.dtype,
                        device="cuda")
    yk = K.dtans_spmv(dm, x, shared_cols=True)
    assert torch.equal(yk, K.dtans_spmv_plain(dm, x, shared_cols=True)), \
        f"{name}: fused spmv kernel != fused plain"
    assert torch.equal(yk, K.dtans_spmv(dm, x)), \
        f"{name}: fused spmv kernel != generic kernel"
    assert torch.equal(ops.spmv(pm, x), ops.spmv(pm, x, fused=False))
    assert torch.equal(K.dtans_spmm(dm, x[:, None], shared_cols=True)[..., 0],
                       yk), f"{name}: fused spmm at B=1 != fused spmv"
    for B in (3, 64):
        X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dm.dtype,
                            device="cuda")
        Yk = K.dtans_spmm(dm, X, shared_cols=True)
        assert torch.equal(Yk, K.dtans_spmm_plain(dm, X, shared_cols=True)), \
            f"{name}: fused spmm kernel != fused plain, B={B}"
        assert torch.equal(Yk, K.dtans_spmm(dm, X)), \
            f"{name}: fused spmm kernel != generic kernel, B={B}"
        assert torch.equal(K.dtans_spmm(dm, X, bn=24, shared_cols=True), Yk)
        assert torch.equal(ops.spmm(pm, X), ops.spmm(pm, X, fused=False))
    torch.cuda.synchronize()


def _comparator_packs(a: CSR):
    """``a`` in every comparator layout of phase 3: (label, format, pack)."""
    for L in SELL_L:
        yield f"sell L={L}", "sell", comparator_pack(a, "sell", L)
    for G in RGCSR_G:
        yield f"rgcsr G={G}", "rgcsr", comparator_pack(a, "rgcsr", G)
    for bs in BCSR_BLOCK_SHAPES:
        yield (f"bcsr {bs[0]}x{bs[1]}", "bcsr",
               comparator_pack(a, "bcsr", bs))


def _check_comparators(name: str, a: CSR, rng) -> float:
    """SELL, RGCSR and BCSR kernels against their plain versions (bitwise)
    and the dense product; tiles, B=1 and every SpMM column bitwise.
    Returns the largest |kernel - plain|."""
    dense = torch.as_tensor(a.to_dense(), device="cuda")
    n = a.shape[1]
    worst = 0.0
    for label, fmt, pk in _comparator_packs(a):
        spmv, spmm, spmv_plain, spmm_plain, op_spmv, op_spmm, _ = \
            WRAPPERS[fmt]
        dm = MODULES[fmt].to_device(pk, "cuda")
        dt = dm.dtype
        what = f"{name} {label}"
        x = torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
        yk = spmv(dm, x)
        yp = spmv_plain(dm, x)
        err, _ = _err(yk, yp, dt)
        ed, okd = _err(op_spmv(pk, x), dense @ x, dt)
        assert torch.equal(yk, yp) and okd, \
            f"{what}: spmv kernel {err} / dense {ed}"
        worst = max(worst, err)
        assert torch.equal(spmm(dm, x[:, None])[..., 0], yk), \
            f"{what}: spmm kernel at B=1 != spmv kernel"
        assert torch.equal(op_spmm(pk, x[:, None])[:, 0], op_spmv(pk, x)), \
            f"{what}: ops spmm at B=1 != ops spmv"
        for B in (3, 64):
            X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dt,
                                device="cuda")
            Yk = spmm(dm, X)
            Yp = spmm_plain(dm, X)
            err, _ = _err(Yk, Yp, dt)
            ed, okd = _err(op_spmm(pk, X), dense @ X, dt)
            assert torch.equal(Yk, Yp) and okd, \
                f"{what}: spmm B={B} kernel {err} / dense {ed}"
            assert torch.equal(spmm(dm, X, bn=24), Yk), \
                f"{what}: tiled bn=24 != untiled, B={B}"
            for b in range(B):
                yb = spmv(dm, X[:, b].contiguous())
                assert torch.equal(Yk[..., b], yb), \
                    f"{what}: spmm column {b} != spmv, B={B}"
            worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


def _check_hand_made(rng) -> list:
    """The SELL / RGCSR kernels on the hand-made packs
    (`tests/hand_made_packs.py`), f32 and f64, x of 13 and 13,000 rows (the
    SpMM's x slab staged in shared memory, and too large for it: read
    through L1): SpMV and SpMM (B = 3, 40) bitwise their plain versions,
    every SpMM column bitwise the SpMV. Returns the labels checked."""
    labels = []
    for dtype in (np.float32, np.float64):
        for n in (13, 13000):
            for kind, make in HAND_MADE.items():
                fmt = kind.split("-")[0]
                spmv, spmm, spmv_plain, spmm_plain, *_ = WRAPPERS[fmt]
                dm = MODULES[fmt].to_device(make(dtype, n), "cuda")
                what = f"hand-made {kind} {np.dtype(dtype).name} n={n}"
                X = torch.as_tensor(rng.standard_normal((n, 40)),
                                    dtype=dm.dtype, device="cuda")
                cols = [spmv(dm, X[:, b].contiguous()) for b in range(40)]
                assert torch.equal(_bits(cols[0]),
                                   _bits(spmv_plain(dm, X[:, 0]))), \
                    f"{what}: spmv kernel != plain"
                for B in (3, 40):
                    Y = spmm(dm, X[:, :B].contiguous())
                    assert torch.equal(_bits(Y), _bits(spmm_plain(
                        dm, X[:, :B]))), f"{what}: spmm B={B} != plain"
                    for b in range(B):
                        assert torch.equal(_bits(Y[..., b]),
                                           _bits(cols[b])), \
                            f"{what}: spmm column {b} != spmv"
                labels.append(what)
    torch.cuda.synchronize()
    return labels


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
    hand = _check_hand_made(rng)
    rows.append({"case": "hand-made sell / rgcsr packs", "packs": hand,
                 "bitwise": True})
    log(f"[kernels] {len(hand)} hand-made SELL / RGCSR packs (-1 holes, "
        f"deltas past the count, int32 sums past 2^31; n = 13 and "
        f"13,000): spmv, spmm and every spmm column bitwise plain")
    for name, a, G in (
            ("rgcsr-dtans stencil6 G=8", stencil_2d(6), 8),
            ("rgcsr-dtans random-f32 G=16",
             _random_csr(300, 260, 0.3, np.float32, 3), 16)):
        worst = _check_dtans(name, a, encode_rgcsr_matrix(a, group_size=G),
                             rng)
        rows.append({"case": name, "lane_width": G, "max_abs_err": worst})
        log(f"[kernels] {name:28s} max|k-plain|={worst:.3e} ok")
    for name, factory, _, shared in CASES:
        a = factory()
        for bs in ((2, 2), (4, 4), (40, 2)):
            what = f"bcsr-dtans {name} {bs[0]}x{bs[1]}"
            mat = encode_bcsr_matrix(a, block_shape=bs, shared_table=shared)
            worst = _check_dtans(what, a, mat, rng)
            _check_fused(what, mat, rng)
            rows.append({"case": what, "lane_width": bs[0],
                         "max_abs_err": worst, "fused_bitwise": True})
            log(f"[kernels] {what:36s} max|k-plain|={worst:.3e}, fused "
                f"bitwise plain and generic ok")
    RESULTS["kernel_cases"] = rows
    phase_sweep()


# The lane widths of the sweep: packed narrow slices (1 to 32 lanes, several
# slices a warp), one warp, and slices over 2 to 32 warps (SpMM takes up to
# `tiling.MAX_SPMM_LANE_WIDTH`).
SWEEP_L = (1, 3, 4, 8, 31, 32, 33, 40, 64, 100, 128, 256, 1024)


def _sweep_csr(L: int, kind: str, seed: int) -> CSR:
    """A matrix of 1.5 slices of L rows (at least 600 rows), 160 columns and
    0 to 23 nonzeros a row (so the lanes of a slice end at different
    segments, some rows are empty), about 7,000 to 18,500 nonzeros:
    ``quant`` f32 quantized to 2^-16 (more levels than a table's 4096
    slots: escapes at many positions), ``f64`` random doubles (the same),
    ``base256`` f32 of two values in runs (table base 256)."""
    rng = np.random.default_rng(seed)
    m, n = max(L + L // 2 + 1, 600), 160
    lens = rng.integers(0, 24, size=m)
    indptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    if kind == "base256":
        starts = rng.integers(0, n - 24, size=m)
        indices = np.concatenate([s0 + np.arange(k)
                                  for s0, k in zip(starts, lens)])
        values = np.where(np.arange(indptr[-1]) % 7 == 0, -1.0, 1.0)
    else:
        indices = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                                  for k in lens])
        values = rng.standard_normal(indptr[-1]) * 2
        if kind == "quant":
            values = np.round(values * 65536) / 65536
    dtype = np.float64 if kind == "f64" else np.float32
    return CSR(indptr, indices.astype(np.int32), values.astype(dtype),
               (m, n))


def _check_sweep(label: str, pm, rng) -> None:
    """One sweep matrix: SpMV, SpMM, tiles, B=1, ``pipeline`` and decode,
    kernel vs plain bitwise."""
    dm = to_device(pm, "cuda")
    n = pm.shape[1]
    X = torch.as_tensor(rng.standard_normal((n, 7)), dtype=dm.dtype,
                        device="cuda")
    x = X[:, 0].contiguous()
    y = K.dtans_spmv(dm, x)
    assert torch.equal(y, K.dtans_spmv_plain(dm, x)), f"{label}: spmv"
    assert torch.equal(ops.spmv(pm, x, pipeline=True), ops.spmv(pm, x)), \
        f"{label}: spmv pipeline"
    if pm.lane_width <= tiling.MAX_SPMM_LANE_WIDTH:
        Y = K.dtans_spmm(dm, X)
        assert torch.equal(Y, K.dtans_spmm_plain(dm, X)), f"{label}: spmm"
        assert torch.equal(K.dtans_spmm(dm, X, bn=3), Y), f"{label}: bn=3"
        assert torch.equal(K.dtans_spmm(dm, X[:, :1].contiguous())[..., 0],
                           y), f"{label}: spmm B=1 != spmv"
        assert torch.equal(ops.spmm(pm, X, pipeline=True), ops.spmm(pm, X)), \
            f"{label}: spmm pipeline"
    else:
        try:
            K.dtans_spmm(dm, X)
        except ValueError as exc:
            assert "lane widths up to" in str(exc), exc
        else:
            raise AssertionError(f"{label}: spmm took L={pm.lane_width}")
    _check_c1(label, pm, dm, X, rng)
    _check_decode(label, pm)
    torch.cuda.synchronize()


def _check_c1(label: str, pm, dm, X: torch.Tensor, rng) -> None:
    """What the SpMM kernel refuses and ``ops.spmm`` serves, bitwise the
    plain SpMM: a lane width past `tiling.MAX_SPMM_LANE_WIDTH` (one SpMV
    launch a column, each counted) and, at L = 128, an explicit tile of
    400 columns, wider than a block's shared memory holds (cut to
    `tiling.dtans_widest_bn`)."""
    m, n = pm.shape
    if tiling.spmm_by_columns(pm.lane_width):
        before = K.launches["dtans_spmv"]
        got = ops.spmm(pm, X)
        assert K.launches["dtans_spmv"] - before == X.shape[1], label
    elif pm.lane_width == 128:
        X = torch.as_tensor(rng.standard_normal((n, 400)), dtype=dm.dtype,
                            device="cuda")
        got = ops.spmm(pm, X, bn=400)
    else:
        return
    want = K.dtans_spmm_plain(dm, X).reshape(-1, X.shape[1])[:m]
    assert torch.equal(got, want), f"{label}: ops.spmm != plain SpMM (C1)"


def phase_sweep() -> None:
    rng = np.random.default_rng(SEED + 5)
    rows, seen_esc, seen_256 = [], 0, 0
    for L in SWEEP_L:
        for kind, shared in (("quant", True), ("f64", False),
                             ("base256", True)):
            a = _sweep_csr(L, kind, L)
            mat = encode_matrix(a, lane_width=L, shared_table=shared)
            pm = pack_matrix(mat)
            esc = int(mat.esc_count_by_domain.sum())
            base = int(pm.tab_base.max())
            label = f"sweep L={L} {kind}"
            _check_sweep(label, pm, rng)
            seen_esc = max(seen_esc, esc)
            seen_256 += base == 256
            rows.append({"case": label, "nnz": a.nnz, "tables":
                         len(mat.tables), "escapes": esc, "max_base": base,
                         "bitwise": True})
        log(f"[sweep] L={L:4d}: quant / f64 2-table / base-256 matrices, "
            f"spmv, spmm, bn=3, B=1, pipeline and decode bitwise plain"
            + ("; ops.spmm by columns bitwise plain"
               if tiling.spmm_by_columns(L) else "")
            + ("; ops.spmm bn=400 cut to fit, bitwise plain"
               if L == 128 else ""))
    assert seen_esc > 1000 and seen_256 > 0, (seen_esc, seen_256)
    RESULTS["sweep_cases"] = rows


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
# RGCSR at its default group and at a warp-sized group, BCSR at the
# registry's default block shape.
HEAD_PACKS = (("sell L=32", "sell", 32), ("rgcsr G=4", "rgcsr", 4),
              ("rgcsr G=32", "rgcsr", 32), ("bcsr 2x2", "bcsr", (2, 2)))


def _work(csr: CSR, fmt: str, rows, pk) -> tuple[int, int]:
    """(bytes, stored cells) one pass needs, padding not counted: the real
    entries' index and value bytes, plus SELL's per-row stops and RGCSR's
    per-row counts (S * L or S * G of them); for BCSR each stored block's
    4-byte column and r * c values, fill-in included, plus its
    per-block-row stops (S of them)."""
    item = csr.values.dtype.itemsize
    if fmt == "bcsr":
        r, c = rows
        n_blocks = int((pk.block_cols >= 0).sum())
        return (n_blocks * (4 + r * c * item) + pk.block_cols.shape[0] * 4,
                n_blocks * r * c)
    return (csr.nnz * (4 + item) + -(-csr.shape[0] // rows) * rows * 4,
            csr.nnz)


def phase_comparators(sl: SparseLinear) -> tuple[CSR, dict]:
    """Serves the request shapes through the comparator ops on the head's
    own pruned matrix; returns the CSR and the packs by label."""
    t0 = time.perf_counter()
    csr = decode_matrix(sl.mat)
    packs = {}
    for label, fmt, rows in HEAD_PACKS:
        pk = comparator_pack(csr, fmt, rows)
        packs[label] = (fmt, rows, pk, MODULES[fmt].to_device(pk, "cuda"))
    pack_s = time.perf_counter() - t0
    wg = next(iter(packs.values()))[3].values.shape[1]
    log(f"[cmp] head CSR nnz {csr.nnz}, longest row {wg}; packed and "
        f"uploaded in {pack_s:.1f} s")
    sizes = {}
    for label, (fmt, rows, pk, dm) in packs.items():
        real, cells = _work(csr, fmt, rows, pk)
        width = int(dm.values.shape[1])     # padded positions a row
        sizes[label] = {"stored_bytes": dm.nbytes, "real_bytes": real,
                        "cells": cells, "row_positions": width}
        log(f"[cmp] {label:10s} stored {dm.nbytes} B on the card (padded "
            f"to {width} positions a row), {real} B exact for {cells} "
            f"cells, vs {sl.compressed_bytes} B for the dtANS head; "
            f"{_l2_note(dm.nbytes)}")
    RESULTS["comparator_packs"] = sizes

    rng = np.random.default_rng(SEED + 3)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda").reshape(-1, D_MODEL).T.contiguous()
          for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    for mod in MODULES.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    ys = {label: [WRAPPERS[fmt][5](pk, X, bn=bn)
                  for X, (_, _, bn) in zip(xs, REQUESTS)]
          for label, (fmt, _, pk, _) in packs.items()}
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = {k: v for mod in MODULES.values()
              for k, v in mod.launches.items()}
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
            assert ok_dense and torch.equal(y, plain), \
                f"{label} {name}: dense {e_dense} plain {e_plain}"
    RESULTS["main_max_abs_err"].update(errs)
    RESULTS["main_max_rel_err"].update(rels)
    return csr, packs


def _l2_note(nbytes: int) -> str:
    fits = nbytes <= L2_BYTES
    return (f"{'fits' if fits else 'exceeds'} the 50 MB L2, so warm repeats "
            f"{'stay in L2' if fits else 're-read HBM'}")


# ---------------------------------------------------------------------------
# 4c. the blocked path at full width
# ---------------------------------------------------------------------------

BLOCK = (4, 4)           # structured pruning in 4x4 tiles
BLOCK_DENSITY = 0.2      # 1 - the head's sparsity 0.8
# The weights' scale: phase 4's head draws std 0.02 (a trained LM head's
# scale), so the two phases' outputs, and the absolute floor of the check
# against the dense product, are on one scale.
WEIGHT_STD = 0.02


def phase_blocked() -> dict:
    """The head's shape pruned in 4x4 tiles (weights of std
    `WEIGHT_STD`), codebook-quantized as `from_dense` does, encoded as BCSR-dtANS 4x4 and served by a
    `SparseLinear` through the fused shared-column kernels; the same
    matrix through ``fused=False`` and as BCSR 4x4."""
    t0 = time.perf_counter()
    tiles = block_sparse(
        VOCAB // BLOCK[0], D_MODEL // BLOCK[1], BLOCK, density=BLOCK_DENSITY,
        rng=np.random.default_rng(SEED), dtype=np.float32)
    q = codebook_quantize(CSR(tiles.indptr, tiles.indices,
                              tiles.values * np.float32(WEIGHT_STD),
                              tiles.shape), bits=8)
    mat = encode_bcsr_matrix(q, block_shape=BLOCK)
    enc_s = time.perf_counter() - t0
    sl = SparseLinear(mat=mat, packed=pack_matrix(mat), d_in=D_MODEL,
                      d_out=VOCAB, dense_bytes=VOCAB * D_MODEL * 4,
                      baseline_bytes=best_baseline_nbytes(q)[1],
                      device=torch.device("cuda"))
    pm = sl.packed
    dm = to_device(pm, "cuda")
    assert pm.shared_cols and pm.lane_width == BLOCK[0]
    # The host decoder walks the 12,288 slices one by one (~160 s on the
    # card's host): decode once, for `apply_dense_reference` (the cached
    # `dense_weight` it would decode itself) and for phase 4d.
    t0 = time.perf_counter()
    filled = decode_matrix(mat)
    sl.dense_weight = torch.from_numpy(filled.to_dense()).to(sl.device)
    host_decode_s = time.perf_counter() - t0
    pb = comparator_pack(q, "bcsr", BLOCK)
    db = BC.to_device(pb, "cuda")
    bcsr_bytes, cells = _work(q, "bcsr", BLOCK, pb)
    RESULTS["blocked"] = {
        "nnz": q.nnz, "n_blocks": mat.n_blocks, "encode_s": enc_s,
        "host_decode_s": host_decode_s,
        "compressed_bytes": sl.compressed_bytes,
        "compression_vs_dense": sl.compression_vs_dense,
        "compression_vs_best_sparse": sl.compression_vs_best_sparse,
        "slices": pm.n_slices, "max_nseg": pm.max_nseg,
        "escapes": int(mat.esc_count_by_domain.sum()),
        "bcsr_exact_bytes": bcsr_bytes, "bcsr_stored_bytes": db.nbytes,
        "bcsr_slots": int(pb.values.shape[1])}
    log(f"[blk] W^T {VOCAB}x{D_MODEL} f32 in {BLOCK[0]}x{BLOCK[1]} tiles, "
        f"nnz {q.nnz} ({mat.n_blocks} blocks), BCSR-dtANS encode "
        f"{enc_s:.1f} s: {sl.compressed_bytes} B, "
        f"{sl.compression_vs_dense:.3f}x vs dense, "
        f"{sl.compression_vs_best_sparse:.3f}x vs best sparse; S="
        f"{pm.n_slices} L={pm.lane_width} max_nseg={pm.max_nseg}; host "
        f"decode_matrix {host_decode_s:.1f} s")
    log(f"[blk] BCSR {BLOCK[0]}x{BLOCK[1]}: {bcsr_bytes} B exact, "
        f"{db.nbytes} B on the card ({pb.values.shape[1]} slots a block "
        f"row); {_l2_note(db.nbytes)}")

    rng = np.random.default_rng(SEED + 4)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda") for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    ys = [sl.apply(x, bn=bn) for x, (_, _, bn) in zip(xs, REQUESTS)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = dict(K.launches)
    log(f"[blk] served {len(REQUESTS)} requests in {serve_s * 1e3:.1f} ms "
        f"(first calls included); launches {counts}")
    assert counts["dtans_spmv_shared"] > 0 and \
        counts["dtans_spmm_shared"] > 0, counts
    assert counts["dtans_spmv"] == 0 and counts["dtans_spmm"] == 0, counts
    RESULTS["launches"].update(
        {k: counts[k] for k in ("dtans_spmv_shared", "dtans_spmm_shared")})

    Xs = [x.reshape(-1, D_MODEL).T.contiguous() for x in xs]
    BC.reset_launches()
    yb = [ops.bcsr_spmm(pb, X, bn=bn) for X, (_, _, bn) in zip(Xs, REQUESTS)]
    torch.cuda.synchronize()
    counts = dict(BC.launches)
    log(f"[blk] the same requests as BCSR {BLOCK[0]}x{BLOCK[1]}: launches "
        f"{counts}")
    assert all(v > 0 for v in counts.values()), counts
    RESULTS["launches"].update(counts)

    errs = {k: 0.0 for k in ("dtans_spmv_shared", "dtans_spmm_shared",
                             "bcsr_spmv", "bcsr_spmm")}
    rels = dict(errs)
    w_dense = sl.dense_weight
    for (name, shape, bn), x, X, y, y_b in zip(REQUESTS, xs, Xs, ys, yb):
        B = X.shape[1]
        assert y.shape == (*shape[:-1], VOCAB) and torch.isfinite(y).all()
        ref = sl.apply_dense_reference(x)
        ok_ref = torch.allclose(y, ref, rtol=1e-4, atol=1e-5)
        e_ref = (y - ref).abs().max().item()
        fused = ops.spmm(pm, X, bn=bn)
        generic = ops.spmm(pm, X, bn=bn, fused=False)
        assert torch.equal(fused, generic), f"{name}: fused != fused=False"
        assert torch.equal(y, fused.T.reshape(y.shape)), \
            f"{name}: apply != ops.spmm"
        if B == 1:
            plain = K.dtans_spmv_plain(dm, X[:, 0], shared_cols=True)
            plain_b = BC.bcsr_spmv_plain(db, X[:, 0])
            kind = "spmv"
        else:
            plain = K.dtans_spmm_plain(dm, X, bn, shared_cols=True)
            plain_b = BC.bcsr_spmm_plain(db, X, bn)
            kind = "spmm"
        plain = plain.reshape(-1, B)[:VOCAB]
        plain_b = plain_b.reshape(-1, B)[:VOCAB]
        torch.cuda.synchronize()
        for kern, got, want in ((f"dtans_{kind}_shared", fused, plain),
                                (f"bcsr_{kind}", y_b, plain_b)):
            e_plain, _ = _err(got, want, torch.float32)
            errs[kern] = max(errs[kern], e_plain)
            rels[kern] = max(rels[kern], e_plain / max(
                want.abs().max().item(), 1e-30))
            assert torch.equal(got, want), f"{name}: {kern} != plain"
        e_b, ok_b = _err(y_b, w_dense @ X, torch.float32)
        log(f"[blk] {name:12s} out {tuple(y.shape)} |y-dense|={e_ref:.3e} "
            f"fused == plain == fused=False bitwise; BCSR |y-dense|="
            f"{e_b:.3e}, == plain bitwise")
        assert ok_ref and ok_b, f"{name}: dense {e_ref} / BCSR {e_b}"
    RESULTS["main_max_abs_err"].update(errs)
    RESULTS["main_max_rel_err"].update(rels)
    return {"sl": sl, "q": q, "pb": pb, "db": db, "filled": filled}


# ---------------------------------------------------------------------------
# 4d. decode
# ---------------------------------------------------------------------------

def phase_decode(sl: SparseLinear, csr: CSR, blk: dict) -> None:
    """``ops.decode`` of the head and of the blocked matrix: columns and
    value bits equal to `decode_ref`, real entries exactly the host's
    `decode_matrix`."""
    mats = {"dtans L=128": (sl, csr),
            "bcsr-dtans 4x4": (blk["sl"], blk["filled"])}
    torch.cuda.synchronize()
    DD.reset_launches()
    outs = {label: ops.decode(s.packed) for label, (s, _) in mats.items()}
    torch.cuda.synchronize()
    counts = dict(DD.launches)
    log(f"[dec] decoded {len(outs)} matrices; launches {counts}")
    assert counts["dtans_decode"] > 0, counts
    RESULTS["launches"].update(counts)
    sizes = {}
    for label, (s, host) in mats.items():
        cols, vals = outs[label]
        want_c, want_v = decode_ref(s.packed, device="cuda")
        assert torch.equal(cols, want_c), f"{label}: columns != decode_ref"
        assert torch.equal(_bits(vals), _bits(want_v)), \
            f"{label}: value bits != decode_ref"
        m = s.mat.shape[0]
        c = cols.reshape(-1, cols.shape[-1])[:m]
        v = vals.reshape(-1, vals.shape[-1])[:m]
        real = c >= 0
        indptr = torch.as_tensor(host.indptr, device="cuda")
        assert torch.equal(real.sum(dim=1), indptr.diff()), \
            f"{label}: real entries per row != decode_matrix"
        assert torch.equal(c[real].long(),
                           torch.as_tensor(host.indices, device="cuda")), \
            f"{label}: columns != decode_matrix"
        assert torch.equal(_bits(v[real]), _bits(torch.as_tensor(
            host.values, device="cuda"))), f"{label}: values != decode_matrix"
        nbytes = cols.nbytes + vals.nbytes
        sizes[label] = {"shape": list(cols.shape), "out_bytes": nbytes}
        log(f"[dec] {label:14s} out {tuple(cols.shape)} int32 + "
            f"{str(vals.dtype).replace('torch.', '')}, {nbytes} B: == "
            f"decode_ref bitwise, real entries == decode_matrix")
    RESULTS["main_max_abs_err"]["dtans_decode"] = 0.0
    RESULTS["main_max_rel_err"]["dtans_decode"] = 0.0
    RESULTS["decode"] = sizes


# ---------------------------------------------------------------------------
# 4e. the autotuned head
# ---------------------------------------------------------------------------

AUTO_BATCH = 64     # a batched serving step: SpMM passes of 0.15-0.5 ms
AUTO_BUDGET = 2     # candidates encoded at full width and timed


def _all_launches() -> dict:
    return {k: v for mod in (K, SE, RG, BC, DD) for k, v in
            mod.launches.items()}


def _reset_all() -> None:
    for mod in (K, SE, RG, BC, DD):
        mod.reset_launches()


def phase_autotuned(sl: SparseLinear) -> SparseLinear:
    """The head's weight (phase 4's draw) built by ``from_dense(auto=True,
    autotune_measure=True)`` on the `H100` model: the selection times the
    top candidates' CUDA kernels (a CUDA graph of each, between CUDA
    events) at B=`AUTO_BATCH`, and the ranking is checked again on phase
    5's timer; the winner serves the request shapes. Each output is held against the
    dense product of the head's pruned weight (phase 4's layer: every
    family codes that same matrix losslessly; a host decode of a
    narrow-slice winner would take minutes) and, bitwise, the winner's
    plain path on the card."""
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    auto = SparseLinear.from_dense(
        w, sparsity=0.8, value_bits=8, auto=True,
        autotune_budget=AUTO_BUDGET, autotune_measure=True,
        autotune_batch=AUTO_BATCH, autotune_cache=DecisionCache(path=None),
        autotune_machine=H100, device="cuda")
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    sel_counts = {k: v for k, v in _all_launches().items() if v}
    d = auto.decision
    log(f"[auto] from_dense(auto=True, budget={AUTO_BUDGET}, measure, "
        f"B={AUTO_BATCH}, H100 model) in {select_s:.1f} s (encodes "
        f"included): {d.config_name}, {d.nbytes} B, modeled "
        f"{d.modeled_time * 1e3:.4f} ms, measured "
        f"{d.measured_time * 1e3:.4f} ms | {card()}")
    for cfg, nbytes, modeled, measured in d.leaderboard:
        meas = "-" if measured is None else f"{measured * 1e3:.4f} ms"
        log(f"[auto]   {cfg:26s} {nbytes:9d} B modeled "
            f"{modeled * 1e3:.4f} ms measured {meas}")
    log(f"[auto] selection launches {sel_counts}")
    assert d.machine == "h100" and d.batch == AUTO_BATCH and d.refined
    assert d.measured_time is not None and d.measured_time > 0
    assert sum(row[3] is not None for row in d.leaderboard) == AUTO_BUDGET
    assert sel_counts, "the measured selection launched no kernel"
    # Phase 4's configuration in the same harness and currency (a CUDA
    # graph of the call, as `select` timed the candidates).
    X = torch.as_tensor(np.random.default_rng(SEED + 7).standard_normal(
        (D_MODEL, AUTO_BATCH)), dtype=torch.float32, device="cuda")
    t_phase4 = measure.time_kernel(
        registry.get_format("dtans").spmm_runner(sl.packed, X,
                                                 device="cuda"),
        device="cuda")
    log(f"[auto] phase 4's dtans[w=128,shared] in the same harness: "
        f"{t_phase4 * 1e3:.4f} ms (IQR {t_phase4.iqr * 1e3:.4f} ms) | "
        f"{card()}")
    # The ranking on kernel time alone, timed as phase 5 times (`device_ms`:
    # 5 replays of a 20-call graph): winner, runner-up (encoded again; the
    # selection's artifacts stay inside `from_dense`) and phase 4's pack.
    pruned = codebook_quantize(magnitude_prune(w.T, 0.8), bits=8)
    up_spec, up_knobs = registry.parse_config(d.leaderboard[1][0])
    t0 = time.perf_counter()
    up_packed = up_spec.pack(pruned, **up_knobs)
    up_encode_s = time.perf_counter() - t0
    packs = {d.config_name: (registry.get_format(d.fmt), auto.packed),
             d.leaderboard[1][0]: (up_spec, up_packed),
             "phase 4 dtans[w=128,shared]": (registry.get_format("dtans"),
                                             sl.packed)}
    graph = {}
    for name, (spec, packed) in packs.items():
        t = device_ms(spec.spmm_runner(packed, X, device="cuda"))
        assert t["by"] == "graph", (name, t["by"])
        graph[name] = t["ms"]
        log(f"[auto]   graph-timed {name:28s} {t['ms']:.4f} ms "
            f"(runs {', '.join(f'{r:.4f}' for r in t['runs'])}) | {card()}")
    names = list(graph)
    holds = graph[names[0]] <= graph[names[1]]
    gap = graph[names[1]] / graph[names[0]] - 1.0
    log(f"[auto] the measured ranking {'holds' if holds else 'flips'} on "
        f"kernel time: {names[0]} {graph[names[0]]:.4f} ms vs "
        f"{names[1]} {graph[names[1]]:.4f} ms (runner-up {gap:+.2%}; "
        f"encoded again in {up_encode_s:.1f} s)")
    shared = bool(auto.packed.shared_cols)
    # (a BCSR-dtANS winner codes the block-filled matrix: more entries)
    assert shared or (auto.mat.nnz == sl.mat.nnz and np.array_equal(
        auto.mat.row_nnz, sl.mat.row_nnz)), "not the head's pruned matrix"

    kinds = ("dtans_spmv_shared", "dtans_spmm_shared") if shared else \
        ("dtans_spmv", "dtans_spmm")
    rng = np.random.default_rng(SEED + 5)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda") for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    ys = [auto.apply(x, bn=bn) for x, (_, _, bn) in zip(xs, REQUESTS)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = {k: v for k, v in _all_launches().items() if v}
    log(f"[auto] served {len(REQUESTS)} requests in {serve_s * 1e3:.1f} ms "
        f"(first calls included); launches {counts}")
    assert all(counts.get(k, 0) > 0 for k in kinds), counts

    dm = to_device(auto.packed, "cuda")
    same_as_4 = d.config_name == "dtans[w=128,shared]"
    for (name, shape, bn), x, y in zip(REQUESTS, xs, ys):
        assert y.shape == (*shape[:-1], VOCAB) and torch.isfinite(y).all()
        xb = x.reshape(-1, D_MODEL)
        B = xb.shape[0]
        if B == 1:
            plain = K.dtans_spmv_plain(dm, xb[0], shared_cols=shared)
        else:
            plain = K.dtans_spmm_plain(dm, xb.T.contiguous(), bn,
                                       shared_cols=shared)
        plain = plain.reshape(-1, B)[:VOCAB].T.reshape(y.shape)
        ref = sl.apply_dense_reference(x)
        torch.cuda.synchronize()
        ok_ref = torch.allclose(y, ref, rtol=1e-4, atol=1e-5)
        e_ref = (y - ref).abs().max().item()
        log(f"[auto] {name:12s} out {tuple(y.shape)} |y-dense|={e_ref:.3e}, "
            f"== plain bitwise")
        assert ok_ref, f"{name}: dense {e_ref}"
        assert torch.equal(y, plain), f"{name}: kernel != plain"
        if same_as_4:
            assert torch.equal(y, sl.apply(x, bn=bn)), \
                f"{name}: not bitwise phase 4's output"
    if same_as_4:
        log("[auto] the winner is phase 4's configuration: outputs "
            "bitwise phase 4's")
    RESULTS["autotune"] = {
        "decision": d.to_dict(), "config": d.config_name,
        "select_s": select_s, "serve_s": serve_s,
        "phase4_config_measured_s": float(t_phase4),
        "graph_ms": graph, "ranking_holds_on_graph": holds,
        "runner_up_gap_on_graph": gap,
        "launches_selection": sel_counts, "launches_serving": counts}
    return auto


# ---------------------------------------------------------------------------
# 4f. the registry and calibration on the card
# ---------------------------------------------------------------------------

REGISTRY_MATRICES = ("nn", "skew")   # of `measure._calibration_suite`
REGISTRY_BATCHES = (1, 8)


def _plain_rows(spec, packed, X: torch.Tensor) -> torch.Tensor:
    """The plain torch version, on the card, of the kernel a registry
    runner of ``spec`` launches on ``packed``: (m, B) rows of A X."""
    d = spec.upload(packed, "cuda")
    B = X.shape[1]
    if spec.decodes:
        shared = bool(packed.shared_cols)
        rows = (K.dtans_spmv_plain(d, X[:, 0], shared_cols=shared)
                if B == 1 else
                K.dtans_spmm_plain(d, X, None, shared_cols=shared))
    else:
        mod = MODULES[spec.name]
        rows = (getattr(mod, f"{spec.name}_spmv_plain")(d, X[:, 0])
                if B == 1 else
                getattr(mod, f"{spec.name}_spmm_plain")(d, X, None))
    return rows.reshape(-1, B)[:d.shape[0]]


def phase_registry() -> None:
    """Every registered format's ``FormatSpec.spmv`` / ``spmm`` runners
    (B = 1, 8) on two calibration matrices on the card: the kernel-backed
    ones bitwise their plain versions, csr / coo / dense within `RTOL` of
    the dense product; then ``measure.calibrate(base=H100, small=True)``
    fits the cost model to CUDA-event times of the real kernels."""
    mats = measure._calibration_suite(small=True)
    rng = np.random.default_rng(SEED + 6)
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    checked = 0
    for mname in REGISTRY_MATRICES:
        a = mats[mname]
        dense = torch.as_tensor(a.to_dense(), device="cuda")
        arts: dict = {}
        for fmt in registry.format_names():
            spec = registry.get_format(fmt)
            packed = spec.pack(a, artifacts=arts)
            for B in REGISTRY_BATCHES:
                X = torch.as_tensor(rng.standard_normal((a.shape[1], B)),
                                    dtype=torch.float32, device="cuda")
                y = (spec.runner(packed, X[:, 0], device="cuda")()[:, None]
                     if B == 1 else
                     spec.spmm_runner(packed, X, device="cuda")())
                assert y.shape == (a.shape[0], B) and y.device == X.device, \
                    (fmt, B)
                if spec.spmv_fn is not None:
                    assert torch.equal(y, _plain_rows(spec, packed, X)), \
                        f"{mname} {fmt} B={B}: kernel != plain"
                else:
                    e, ok = _err(y, dense @ X, torch.float32)
                    assert ok, f"{mname} {fmt} B={B}: |y-dense| {e}"
                checked += 1
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    counts = {k: v for k, v in _all_launches().items() if v}
    log(f"[reg] {checked} registry passes ({len(registry.format_names())} "
        f"formats x {REGISTRY_MATRICES} x B {REGISTRY_BATCHES}) in "
        f"{reg_s:.1f} s: kernels bitwise plain, csr / coo / dense within "
        f"rtol of the dense product; launches {counts}")
    want = {k for k in _all_launches() if k != "dtans_decode"}
    assert want <= set(counts), sorted(want - set(counts))

    _reset_all()
    t0 = time.perf_counter()
    res = measure.calibrate(base=H100, small=True, device="cuda")
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    cal_counts = {k: v for k, v in _all_launches().items() if v}
    fit = res.model
    log(f"[cal] calibrate(base=H100, small=True): {len(res.points)} "
        f"points in {cal_s:.1f} s; mean |model - measured| / measured "
        f"{res.err_before:.3f} (data-sheet seed) -> {res.err_after:.3f} "
        f"(fitted); launches {cal_counts} | {card()}")
    for field in ("hbm_bw", "cache_bw", "spmv_ops_per_elem",
                  "row_seq_penalty", "decode_ops_per_nnz"):
        log(f"[cal]   {field:19s} seed {getattr(H100, field):.6g} "
            f"fitted {getattr(fit, field):.6g}")
    consts = [getattr(fit, f) for f in ("hbm_bw", "cache_bw",
                                        "spmv_ops_per_elem",
                                        "row_seq_penalty",
                                        "decode_ops_per_nnz")]
    assert all(np.isfinite(c) and c > 0 for c in consts), consts
    assert all(p.measured > 0 for p in res.points)
    assert cal_counts, "calibration launched no kernel"
    RESULTS["registry"] = {"passes": checked, "seconds": reg_s,
                           "launches": counts}
    RESULTS["calibration"] = {**res.to_dict(), "seconds": cal_s,
                              "launches": cal_counts,
                              "seed": H100.to_dict()}


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


RUNS = 5   # runs of a B=1 pass timed without the Python loop


def _graph_runs(fn, calls: int = 20) -> list | None:
    """ms a call of ``fn`` in each of `RUNS` replays of one CUDA graph of
    ``calls`` calls (no host work between the launches); None where the
    capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        log(f"[times] CUDA graph capture failed "
            f"({str(exc).splitlines()[0][:100]})")
        return None
    g.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / calls)
    return runs


def _c_entry_runs(fn, iters: int = 50) -> list:
    """ms a call in each of `RUNS` event-timed loops of ``iters`` calls of
    the C entry that ``fn``'s wrapper launches, with that launch's
    arguments: the ctypes call alone, without the wrapper around it."""
    seen, saved = [], []

    def recorder(f):
        def call(*args):
            seen.append((f, args))
            return f(*args)
        return call
    for lib in list(_build._loaded.values()):
        for name, f in list(vars(lib).items()):
            if name.endswith("_launch"):
                saved.append((lib, name, f))
                setattr(lib, name, recorder(f))
    try:
        out = fn()                  # keeps the output the entry writes
    finally:
        for lib, name, f in saved:
            setattr(lib, name, f)
    f, args = seen[-1]
    runs = [time_ms(lambda: f(*args), iters) for _ in range(RUNS)]
    del out
    return runs


def device_ms(fn, library: bool = False) -> dict:
    """One call's device time without the Python loop of `time_ms`: the
    median of `RUNS` runs (`_graph_runs`; where capture fails, a loop of
    the C entry alone, or of a library call itself)."""
    runs, by = _graph_runs(fn), "graph"
    if runs is None:
        by = "loop" if library else "C entry"
        runs = ([time_ms(fn, 50) for _ in range(RUNS)] if library
                else _c_entry_runs(fn))
    return {"ms": statistics.median(runs), "runs": runs, "by": by}


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
    present, one per-lane count array, coding tables at 12 bytes a slot,
    x, y; each once)
    over the HBM rate, and its multiply-adds (2 nnz B) over the f32 rate.
    The kernels also read ``ns``, but it is ``2 * nnz`` and not needed."""
    mat, pm = sl.mat, sl.packed
    item = pm.dtype.itemsize
    nbytes = (int(mat.stream.size) * 4
              + sum(int(e.size) for e in mat.esc_streams) * 8
              + pm.nnz.nbytes
              + pm.tab_symbol.size * 12
              + sl.d_in * B * item + sl.d_out * B * item)
    flops = 2 * mat.nnz * B
    return (*_roofline(nbytes, flops, item), nbytes, flops)


def comparator_bound(csr: CSR, fmt: str, rows, pk,
                     B: int) -> tuple[float, str, int, int]:
    """Least time for one SELL / RGCSR / BCSR pass at batch B: the bytes of
    `_work` (no padding; SELL's stops, RGCSR's counts, BCSR's stored blocks
    with their fill-in and its stops), x and y once each, against 2
    multiply-adds per stored cell and column."""
    item = csr.values.dtype.itemsize
    nbytes, cells = _work(csr, fmt, rows, pk)
    nbytes += D_MODEL * B * item + VOCAB * B * item
    flops = 2 * cells * B
    return (*_roofline(nbytes, flops, item), nbytes, flops)


def decode_bound(sl: SparseLinear) -> tuple[float, str, int, int]:
    """Least time for one decode: the compressed bytes `bound` counts
    without x and y, plus the (S, L, max_nnz) columns and values written
    once; no arithmetic is counted."""
    pm = sl.packed
    _, _, read, _ = bound(sl, 0)
    written = pm.n_slices * pm.lane_width * pm.max_nseg * (pm.params.l // 2) \
        * (4 + pm.dtype.itemsize)
    return (*_roofline(read + written, 0, pm.dtype.itemsize),
            read + written, 0)


def library_call(csr: CSR, block_shape=None):
    """One PyTorch call for the same product on the card, for timing only:
    BSR (``torch.sparse_bsr_tensor @ x``) at ``block_shape`` where it runs
    on this card, else cuSPARSE CSR. Returns (name, fn of x)."""
    a_csr = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, device="cuda"),
        torch.as_tensor(csr.indices, device="cuda"),
        torch.as_tensor(csr.values, device="cuda"),
        size=csr.shape, check_invariants=False)
    if block_shape is not None:
        b = BCSR.from_csr(csr, block_shape)
        a_bsr = torch.sparse_bsr_tensor(
            torch.as_tensor(b.block_ptr, device="cuda"),
            torch.as_tensor(b.block_cols, device="cuda"),
            torch.as_tensor(b.values, device="cuda"),
            size=csr.shape, check_invariants=False)
        x = torch.ones((csr.shape[1], 2), dtype=a_bsr.dtype, device="cuda")
        try:
            want = a_csr @ x
            ok = torch.allclose(a_bsr @ x, want, rtol=1e-4, atol=1e-4)
        except (RuntimeError, NotImplementedError) as exc:
            log(f"[times] torch BSR {block_shape} @ x does not run here "
                f"({str(exc).splitlines()[0][:100]}); cuSPARSE CSR instead")
        else:
            if ok:
                return (f"torch BSR {block_shape[0]}x{block_shape[1]}",
                        lambda v: a_bsr @ v)
            log(f"[times] torch BSR {block_shape} @ x disagrees with CSR; "
                f"cuSPARSE CSR instead")
    return "cuSPARSE CSR", lambda v: a_csr @ v


def phase_times(sl: SparseLinear, csr: CSR, packs: dict, blk: dict) -> list:
    dm = to_device(sl.packed, "cuda")
    bsl = blk["sl"]
    bdm = to_device(bsl.packed, "cuda")
    libs = {"csr": library_call(csr), "bcsr 2x2": library_call(csr, (2, 2)),
            "blocked": library_call(blk["q"], BLOCK),
            "blocked csr": library_call(blk["q"])}
    w_dense = sl.dense_weight
    wb_dense = bsl.dense_weight
    rng = np.random.default_rng(SEED + 2)
    log(f"[times] compressed head {RESULTS['head']['compressed_bytes']} B, "
        f"CSR {sl.mat.nnz * 8 + (sl.d_out + 1) * 4} B, dense "
        f"{sl.dense_bytes} B, the 50 MB L2 holds all but dense, so repeated "
        f"dtANS launches run with the matrix warm in L2 (the comparator "
        f"packs: see [cmp] and [blk]); library calls: "
        f"{ {k: v[0] for k, v in libs.items()} }")
    rows = []

    def add(kern, label, B, bn, k, p_ms, lib, dense_ms, b, csr=None):
        """One row; ``k`` is `pair`'s kernel timing. Its ``library`` is the
        faster of the PyTorch calls timed for the same product on the same
        matrix (``libs[lib]`` and, where given, ``libs[csr]``, cuSPARSE
        CSR)."""
        b_ms, b_by, nbytes, flops = b
        keys = {libs[key][0]: key for key in (lib, csr) if key is not None}
        calls = {name: lib_ms[key] for name, key in keys.items()}
        best = min(calls, key=calls.get) if calls else None
        rows.append({"kernel": kern, "pack": label, "B": B, "bn": bn,
                     **k, "plain_ms": p_ms, "library": best,
                     "library_ms": calls.get(best), "library_calls": calls,
                     "dense_ms": dense_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "flops": flops})
        if best is not None and B == 1:
            rows[-1]["library_loop_ms"] = lib_loop[keys[best]]
        lib_s = " | ".join(f"{k} {v:.4f} ms" for k, v in calls.items()) \
            or "library -"
        dense_s = "-" if dense_ms is None else f"{dense_ms:.4f} ms"
        loop_s = (f" (median of {RUNS}, {k['timed_by']}; Python loop "
                  f"{k['loop_ms']:.4f} ms)" if "loop_ms" in k else "")
        log(f"[times] {kern:17s} {label:14s} B={B:3d} bn={bn} kernel "
            f"{k['ms']:.4f} ms{loop_s} | plain {p_ms:.2f} ms | {lib_s} | "
            f"dense {dense_s} | bound {b_ms:.5f} ms ({b_by}) | {card()}")

    def pair(one, many, x1, x, bn):
        """(kernel timing, plain ms) of a SpMV (B == 1) or SpMM pass. At
        B == 1 the kernel's ``ms`` is `device_ms`'s, the median of `RUNS`
        runs without the Python loop, and ``loop_ms`` the loop's of
        earlier PRs; else ``ms`` is the loop's."""
        if x.shape[1] == 1:
            t = device_ms(lambda: one[0](x1))
            return {"ms": t["ms"], "runs": t["runs"], "timed_by": t["by"],
                    "loop_ms": time_ms(lambda: one[0](x1), 50)}, \
                time_ms(lambda: one[1](x1), 3, 1)
        return {"ms": time_ms(lambda: many[0](x, bn), 20)}, \
            time_ms(lambda: many[1](x, bn), 3, 1)

    lib_loop = {}    # B == 1: the library calls' Python-loop times
    for B, bn in ((1, None), (4, None), (8, None), (64, None), (512, 64)):
        x = torch.as_tensor(rng.standard_normal((D_MODEL, B)),
                            dtype=torch.float32, device="cuda")
        x1 = x[:, 0].contiguous()
        if B == 1:
            lib_ms = {k: device_ms(lambda: fn(x), library=True)["ms"]
                      for k, (_, fn) in libs.items()}
            lib_loop = {k: time_ms(lambda: fn(x), 50)
                        for k, (_, fn) in libs.items()}
        else:
            lib_ms = {k: time_ms(lambda: fn(x), 50) for k, (_, fn) in
                      libs.items()}
        dense_ms = time_ms(lambda: w_dense @ x, 50)
        dense_b_ms = time_ms(lambda: wb_dense @ x, 50)
        kind = "spmv" if B == 1 else "spmm"
        kt, p_ms = pair(
            (lambda v: K.dtans_spmv(dm, v), lambda v: K.dtans_spmv_plain(dm, v)),
            (lambda v, b: K.dtans_spmm(dm, v, bn=b),
             lambda v, b: K.dtans_spmm_plain(dm, v, b)), x1, x, bn)
        add(f"dtans_{kind}", "dtans L=128", B, bn, kt, p_ms, "csr",
            dense_ms, bound(sl, B))
        for label, (fmt, prows, pk, cm) in packs.items():
            spmv, spmm, spmv_plain, spmm_plain, *_ = WRAPPERS[fmt]
            kt, p_ms = pair(
                (lambda v: spmv(cm, v), lambda v: spmv_plain(cm, v)),
                (lambda v, b: spmm(cm, v, bn=b),
                 lambda v, b: spmm_plain(cm, v, b)), x1, x, bn)
            add(f"{fmt}_{kind}", label, B, bn, kt, p_ms,
                "bcsr 2x2" if fmt == "bcsr" else "csr", dense_ms,
                comparator_bound(csr, fmt, prows, pk, B),
                "csr" if fmt == "bcsr" else None)
        # the blocked matrix of phase 4c: fused, generic and BCSR 4x4
        for shared in (True, False):
            kt, p_ms = pair(
                (lambda v: K.dtans_spmv(bdm, v, shared_cols=shared),
                 lambda v: K.dtans_spmv_plain(bdm, v, shared_cols=shared)),
                (lambda v, b: K.dtans_spmm(bdm, v, bn=b, shared_cols=shared),
                 lambda v, b: K.dtans_spmm_plain(bdm, v, b,
                                                 shared_cols=shared)),
                x1, x, bn)
            add(f"dtans_{kind}" + ("_shared" if shared else ""),
                "bcsr-dtans 4x4", B, bn, kt, p_ms, "blocked", dense_b_ms,
                bound(bsl, B), "blocked csr")
        db = blk["db"]
        kt, p_ms = pair(
            (lambda v: BC.bcsr_spmv(db, v), lambda v: BC.bcsr_spmv_plain(db, v)),
            (lambda v, b: BC.bcsr_spmm(db, v, bn=b),
             lambda v, b: BC.bcsr_spmm_plain(db, v, b)), x1, x, bn)
        add(f"bcsr_{kind}", "bcsr 4x4", B, bn, kt, p_ms, "blocked",
            dense_b_ms,
            comparator_bound(blk["q"], "bcsr", BLOCK, blk["pb"], B),
            "blocked csr")
    for r in rows:
        csr_ms = r["library_calls"].get("cuSPARSE CSR")
        if r["kernel"] in ("sell_spmm", "rgcsr_spmm", "bcsr_spmm") and \
                csr_ms:
            r["ratio_csr"] = r["ms"] / csr_ms
            log(f"[times] padded SpMM {r['pack']:10s} B={r['B']:3d} "
                f"bn={r['bn']}: {r['ms']:.4f} ms = {r['ratio_csr']:.2f}x "
                f"cuSPARSE CSR ({csr_ms:.4f} ms) | {card()}")
    for label, s in (("dtans L=128", sl), ("bcsr-dtans 4x4", bsl)):
        d = to_device(s.packed, "cuda")
        t = device_ms(lambda: DD.dtans_decode(d))
        add("dtans_decode", label, 0, None,
            {"ms": t["ms"], "runs": t["runs"], "timed_by": t["by"],
             "loop_ms": time_ms(lambda: DD.dtans_decode(d), 20)},
            time_ms(lambda: DD.dtans_decode_plain(d), 3, 1), None, None,
            decode_bound(s))
    RESULTS["times"] = rows
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        t = time.perf_counter() - t_start
        RESULTS.setdefault("phase_end_s", {})[phase] = t
        log(f"[time] phase {phase} done at {t:.1f} s")

    phase_device()
    phase_build()
    done("2")
    phase_kernels()
    done("3")
    sl = phase_main_path()
    done("4")
    csr, packs = phase_comparators(sl)
    done("4b")
    blk = phase_blocked()
    done("4c")
    phase_decode(sl, csr, blk)
    done("4d")
    phase_autotuned(sl)
    done("4e")
    phase_registry()
    done("4f")
    times = phase_times(sl, csr, packs, blk)
    done("5")
    # rows of the kernels line: SpMV at B=1, SpMM at B=64; the comparators
    # at the format registry's layouts, BCSR and the fused kernels on the
    # blocked matrix of phase 4c, decode on the head
    pick = {"dtans_spmv": ("dtans L=128", 1),
            "dtans_spmm": ("dtans L=128", 64),
            "sell_spmv": ("sell L=32", 1), "sell_spmm": ("sell L=32", 64),
            "rgcsr_spmv": ("rgcsr G=4", 1), "rgcsr_spmm": ("rgcsr G=4", 64),
            "bcsr_spmv": ("bcsr 4x4", 1), "bcsr_spmm": ("bcsr 4x4", 64),
            "dtans_spmv_shared": ("bcsr-dtans 4x4", 1),
            "dtans_spmm_shared": ("bcsr-dtans 4x4", 64),
            "dtans_decode": ("dtans L=128", 0)}
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
            "library_ms": t["library_ms"], "library": t["library"],
            "B": B, **{k: t[k] for k in ("loop_ms", "library_loop_ms")
                       if k in t},
            "launches_selection":
                RESULTS["autotune"]["launches_selection"].get(name, 0),
            "launches_calibrate":
                RESULTS["calibration"]["launches"].get(name, 0)})
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
