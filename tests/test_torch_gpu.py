"""The CUDA kernels on the card, and their build.

This file imports neither JAX nor the `repro` package, so that it runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The ``gpu`` tests hold each kernel against its plain torch version on the
card (rtol 1e-4 f32 / 1e-12 f64, the reference's tolerances) and the
port's schedules against each other bitwise, time a registry runner
and a measured selection with CUDA events, serve the smoke model
through the engine's compressed head and the launcher, take a smoke
training step and score a trained head through the dtANS SpMM, solve
the CG example through B1 and train data-parallel on two ranks of the
card; they skip in their body where torch sees no card. The build tests run anywhere: a missing ``nvcc`` and a
failing compile must raise.
"""

import dataclasses
import importlib.util
import os
import stat
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import autotune, configs, obs
from repro_torch.autotune import measure
from repro_torch.core.bcsr_dtans import encode_bcsr_matrix
from repro_torch.core.rgcsr_dtans import encode_rgcsr_matrix
from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.core.params import TOY, DtansParams
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.kernels import _build, ops, padded, tiling
from repro_torch.kernels import bcsr_spmv as BC
from repro_torch.kernels import dtans_decode as DD
from repro_torch.kernels import dtans_spmv as K
from repro_torch.kernels import rgcsr_spmv as RG
from repro_torch.kernels import sell_spmv as SE
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.kernels.ref import decode_ref
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving.engine import Engine
from repro_torch.serving.sparse_linear import SparseLinear
from repro_torch.sparse.bcsr import BCSR, BCSR_BLOCK_SHAPES
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.random_graphs import block_sparse
from repro_torch.sparse.rgcsr import RGCSR
from repro_torch.train.trainer import TrainConfig, Trainer

from hand_made_packs import HAND_LENGTHS, HAND_MADE
from param_sets import PARAM_SETS

RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def _dense(m, n, density, dtype, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    return d


CASES = [
    # name, dense factory, lane_width, shared_table
    ("f64-escapes", lambda: _dense(200, 150, 0.3, np.float64, 1), 16, True),
    ("f32-escapes-2tab", lambda: _dense(200, 150, 0.3, np.float32, 2), 32,
     False),
    ("f32-quantized", lambda: np.round(_dense(300, 90, 0.2, np.float32, 3)
                                       * 2) / 2, 128, True),
    ("f64-wide", lambda: _dense(9, 400, 0.4, np.float64, 4), 8, True),
    ("f64-tall", lambda: _dense(500, 9, 0.5, np.float64, 5), 64, True),
    ("f64-empty-rows",
     lambda: np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)]), 16, True),
]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def packed(request):
    _, factory, lw, shared = request.param
    d = factory()
    return d, pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=lw,
                                        shared_table=shared))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _close(got, want, dtype):
    scale = want.abs().max().item() if want.numel() else 0.0
    assert bool(((got - want).abs()
                 <= RTOL[dtype] * (want.abs() + scale)).all())


@pytest.mark.gpu
def test_kernels_vs_plain_on_card(packed):
    _need_card()
    d, pm = packed
    dm = to_device(pm, "cuda")
    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.standard_normal((d.shape[1], 9)),
                        dtype=dm.dtype, device="cuda")
    x = X[:, 0].contiguous()
    y = K.dtans_spmv(dm, x)
    _close(y, K.dtans_spmv_plain(dm, x), dm.dtype)
    Y = K.dtans_spmm(dm, X)
    _close(Y, K.dtans_spmm_plain(dm, X), dm.dtype)
    for bn in (1, 4, 8):
        assert torch.equal(K.dtans_spmm(dm, X, bn=bn), Y)
    assert torch.equal(K.dtans_spmm(dm, X[:, :1].contiguous())[..., 0], y)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_ops_on_card_vs_dense(packed):
    _need_card()
    d, pm = packed
    X = np.random.default_rng(7).standard_normal((d.shape[1], 5)).astype(
        d.dtype)
    got = ops.spmm(pm, X, bn=2)
    assert got.device.type == "cuda"
    _close(got.cpu(), torch.from_numpy(d @ X), got.dtype)
    _close(ops.spmv(pm, X[:, 0]).cpu(), torch.from_numpy(d @ X[:, 0]),
           got.dtype)


@pytest.mark.gpu
def test_sparse_linear_on_card_counts_launches():
    _need_card()
    w = (np.random.default_rng(8).standard_normal((96, 300)) / 10).astype(
        np.float32)
    sl = SparseLinear.from_dense(w, sparsity=0.7, value_bits=6,
                                 lane_width=32)
    K.reset_launches()
    x = torch.randn(3, 4, 96, device="cuda")
    y = sl.apply(x)
    y1 = sl.apply(x[:1, 0])
    torch.cuda.synchronize()
    assert K.launches["dtans_spmm"] == 1 and K.launches["dtans_spmv"] == 1
    assert y.device.type == "cuda" and tuple(y.shape) == (3, 4, 300)
    torch.testing.assert_close(y, sl.apply_dense_reference(x), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(y1, sl.apply_dense_reference(x[:1, 0]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", (None, 4))
def test_host_layer_moved_to_card_is_from_dense_on_card(n_shards):
    """`SparseLinear.to` on a layer built on the host gives the layer
    `from_dense(device="cuda")` builds: the same device (an index given),
    bitwise the same products, through the kernels."""
    _need_card()
    w = (np.random.default_rng(8).standard_normal((96, 300)) / 10).astype(
        np.float32)
    kw = dict(sparsity=0.7, value_bits=6, lane_width=32, n_shards=n_shards)
    card = SparseLinear.from_dense(w, **kw)
    host = SparseLinear.from_dense(w, device="cpu", **kw).to("cuda")
    assert host.device == card.device and host.device.index is not None
    x = torch.randn(5, 96, device="cuda")
    K.reset_launches()
    y = host.apply(x)
    torch.cuda.synchronize()
    assert K.launches["dtans_spmm"] == (n_shards or 1)
    assert torch.equal(y, card.apply(x))


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    """TOY computes (bitwise its plain version); lane widths the SpMM
    block cannot hold raise."""
    _need_card()
    d = _dense(12, 10, 0.5, np.float64, 9)
    toy = to_device(pack_matrix(encode_matrix(CSR.from_dense(d), params=TOY,
                                              lane_width=4)), "cuda")
    x = torch.as_tensor(np.arange(10) / 7, device="cuda")
    assert torch.equal(K.dtans_spmv(toy, x), K.dtans_spmv_plain(toy, x))
    dm = to_device(pack_matrix(encode_matrix(CSR.from_dense(d),
                                             lane_width=992)), "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        K.dtans_spmm(dm, torch.zeros(10, 64, dtype=torch.float64,
                                     device="cuda"))
    dm = to_device(pack_matrix(encode_matrix(CSR.from_dense(d),
                                             lane_width=1024)), "cuda")
    with pytest.raises(ValueError, match="lane widths up to 992"):
        K.dtans_spmm(dm, torch.zeros(10, 2, dtype=torch.float64,
                                     device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("lane_width", [16, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(PARAM_SETS))
def test_param_set_kernels_vs_plain_on_card(name, dtype, lane_width):
    """B1 (B = 1), B2 (B = 4 and 64, and a ragged tile of 24) and B3 of
    each parameter set bitwise their plain versions on the card (f64 on
    two tables, f32 on one), every launch counted; each set's plan as its
    built kernels count it."""
    _need_card()
    params = DtansParams(*PARAM_SETS[name])
    d = _dense(300, 90, 0.2, dtype, 31)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), params=params,
                                   lane_width=lane_width,
                                   shared_table=dtype == np.float32))
    dm = to_device(pm, "cuda")
    rng = np.random.default_rng(12)
    K.reset_launches()
    DD.reset_launches()
    x = torch.as_tensor(rng.standard_normal(90), dtype=dm.dtype,
                        device="cuda")
    assert torch.equal(_bits(K.dtans_spmv(dm, x)),
                       _bits(K.dtans_spmv_plain(dm, x)))
    for B in (4, 64):
        X = torch.as_tensor(rng.standard_normal((90, B)), dtype=dm.dtype,
                            device="cuda")
        want = _bits(K.dtans_spmm_plain(dm, X))
        assert torch.equal(_bits(K.dtans_spmm(dm, X)), want)
        assert torch.equal(_bits(K.dtans_spmm(dm, X, bn=24)), want)
    cols, vals = DD.dtans_decode(dm)
    pcols, pvals = DD.dtans_decode_plain(dm)
    assert torch.equal(cols, pcols)
    assert torch.equal(_bits(vals), _bits(pvals))
    torch.cuda.synchronize()
    assert K.launches["dtans_spmv"] == 1 and K.launches["dtans_spmm"] == 4
    assert DD.launches["dtans_decode"] == 1
    T, item = dm.tables.shape[0], dm.dtype.itemsize
    assert DD.smem_need(T, lane_width, item, params) == \
        tiling.decode_geometry(1, lane_width, T, item, params=params).smem
    assert K.smem_need(True, T, lane_width, item, 8, params) == \
        tiling.smem_plan(T, lane_width, item, bn=8, params=params)["total"]
    assert K.smem_need(False, T, lane_width, item, 0, params) == \
        tiling.geometry(1, lane_width, T, item, params=params).smem


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["TOY", "K16", "W8", "L48", "M4", "L66"])
def test_param_set_blocked_packs_on_card(name):
    """The BCSR-dtANS (fused shared-column kernels) and RGCSR-dtANS packs
    of a set: bitwise their plain versions and the generic kernels. (Not
    M16: its 2x2 blocks' explicit zeros give one symbol a base of 28,672,
    and the 96-bit state overflows, in the JAX package too: ROADMAP
    C11.)"""
    _need_card()
    params = DtansParams(*PARAM_SETS[name])
    d = _dense(96, 80, 0.3, np.float64, 33)
    a = CSR.from_dense(d)
    rng = np.random.default_rng(34)
    x = torch.as_tensor(rng.standard_normal(80), device="cuda")
    X = torch.as_tensor(rng.standard_normal((80, 5)), device="cuda")
    for mat, shared in ((encode_bcsr_matrix(a, (2, 2), params=params), True),
                        (encode_rgcsr_matrix(a, 8, params=params), False)):
        pm = pack_matrix(mat)
        assert pm.shared_cols == shared and pm.params == params
        dm = to_device(pm, "cuda")
        y = K.dtans_spmv(dm, x, shared_cols=shared)
        assert torch.equal(y, K.dtans_spmv_plain(dm, x, shared_cols=shared))
        assert torch.equal(y, K.dtans_spmv(dm, x))
        Y = K.dtans_spmm(dm, X, shared_cols=shared)
        assert torch.equal(Y, K.dtans_spmm_plain(dm, X, shared_cols=shared))
        assert torch.equal(Y, K.dtans_spmm(dm, X))
        _close(ops.spmv(mat, x).cpu(), torch.from_numpy(d @ x.cpu().numpy()),
               torch.float64)


@pytest.mark.gpu
def test_static_smem_matches_tiling():
    """The wrapper's shared-memory check subtracts exactly the kernel's
    static arrays."""
    _need_card()
    assert K.static_smem_bytes() == tiling.STATIC_SMEM_BYTES


# The comparator kernels: name, pack, device upload, wrappers, plain versions.
COMPARATORS = {
    "sell": (lambda a, rows: SE.pack_sell(a, rows), SE.to_device,
             SE.sell_spmv, SE.sell_spmm, SE.sell_spmv_plain,
             SE.sell_spmm_plain, SE.launches),
    "rgcsr": (lambda a, rows: RG.pack_rgcsr(RGCSR.from_csr(a, rows)),
              RG.to_device, RG.rgcsr_spmv, RG.rgcsr_spmm,
              RG.rgcsr_spmv_plain, RG.rgcsr_spmm_plain, RG.launches),
    "bcsr": (lambda a, rows: BC.pack_bcsr(BCSR.from_csr(a, (rows, 2))),
             BC.to_device, BC.bcsr_spmv, BC.bcsr_spmm, BC.bcsr_spmv_plain,
             BC.bcsr_spmm_plain, BC.launches),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rows", [(np.float32, 32), (np.float64, 4)])
@pytest.mark.parametrize("fmt", list(COMPARATORS))
def test_comparator_kernels_vs_plain_on_card(fmt, dtype, rows):
    """SpMV and SpMM against their plain versions; column tiles and B = 1
    bitwise the untiled kernel and SpMV; every launch counted."""
    _need_card()
    pack, upload, spmv, spmm, spmv_plain, spmm_plain, launches = \
        COMPARATORS[fmt]
    d = _dense(150, 70, 0.2, dtype, 10)
    d[5] = 0                                            # an empty row
    dm = upload(pack(CSR.from_dense(d), rows), "cuda")
    X = torch.as_tensor(np.random.default_rng(11).standard_normal((70, 9)),
                        dtype=dm.dtype, device="cuda")
    x = X[:, 0].contiguous()
    before = dict(launches)
    y = spmv(dm, x)
    _close(y, spmv_plain(dm, x), dm.dtype)
    Y = spmm(dm, X)
    _close(Y, spmm_plain(dm, X), dm.dtype)
    for bn in (1, 4, 8):
        assert torch.equal(spmm(dm, X, bn=bn), Y)
    assert torch.equal(spmm(dm, X[:, :1].contiguous())[..., 0], y)
    for b in range(X.shape[1]):
        assert torch.equal(Y[..., b], spmv(dm, X[:, b].contiguous()))
    torch.cuda.synchronize()
    _close(y.reshape(-1)[:150].cpu(), torch.from_numpy(d @ x.cpu().numpy()),
           dm.dtype)
    assert launches[f"{fmt}_spmv"] - before[f"{fmt}_spmv"] == 10
    assert launches[f"{fmt}_spmm"] - before[f"{fmt}_spmm"] == 5


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["sell", "rgcsr"])
def test_comparator_kernels_mask_padding_on_card(fmt):
    """A NaN in x[0] reaches no padded entry: column 0 of the matrix is
    empty, so every row stays finite. (A BCSR block that covers column 0
    multiplies its zero cells there, as the reference does:
    `test_bcsr_edge_cells_multiply_last_x_on_card`.)"""
    _need_card()
    pack, upload, spmv, spmm, *_ = COMPARATORS[fmt]
    d = _dense(40, 12, 0.5, np.float32, 12)
    d[:, 0] = 0
    dm = upload(pack(CSR.from_dense(d), 8), "cuda")
    X = torch.ones((12, 3), dtype=torch.float32, device="cuda")
    X[0] = float("nan")
    assert bool(torch.isfinite(spmv(dm, X[:, 0].contiguous())).all())
    assert bool(torch.isfinite(spmm(dm, X)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", list(COMPARATORS))
def test_comparator_kernels_degenerate_shapes_on_card(fmt):
    """No rows, no columns, and a pack of only padding (Wg = 1): zeros."""
    _need_card()
    pack, upload, spmv, spmm, *_ = COMPARATORS[fmt]
    for shape in ((0, 5), (6, 0), (7, 4)):
        dm = upload(pack(CSR.from_dense(np.zeros(shape, np.float32)), 4),
                    "cuda")
        x = torch.ones(shape[1], 3, device="cuda")
        assert not bool(spmv(dm, x[:, 0].contiguous()).any())
        assert not bool(spmm(dm, x, bn=2).any())
    torch.cuda.synchronize()


# The SELL / RGCSR SpMM kernel (`padded_rows.cuh::spmm_warp_kernel`): the
# batches and tiles of its geometry (narrow row groups, one and two columns
# a lane, ragged tiles and slabs), and the layouts it runs on.
WARP_SPMM_B = (2, 3, 4, 5, 8, 9, 16, 31, 32, 33, 63, 64, 65, 100)
WARP_SPMM_BN = (None, 1, 4, 8, 24, 32, 40, 64)
WARP_SPMM_LAYOUTS = [("sell", 16), ("sell", 32), ("sell", 128),
                     ("rgcsr", 4), ("rgcsr", 8), ("rgcsr", 32)]


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt,rows", WARP_SPMM_LAYOUTS,
                         ids=[f"{f}{r}" for f, r in WARP_SPMM_LAYOUTS])
def test_warp_spmm_bitwise_plain_on_card(fmt, rows, dtype):
    """Bitwise the plain version at every B and tile of the sweep, on a
    matrix of 141 rows (R not a multiple of 32 at L = 16, G = 4 and 8) with
    empty rows, a row of all 70 columns (the pack's Wg) and -0.0 in x; the
    launches are counted."""
    _need_card()
    pack, upload, _, spmm, _, spmm_plain, launches = COMPARATORS[fmt]
    d = _dense(141, 70, 0.2, dtype, 30)
    d[[5, 6, 40]] = 0                                   # empty rows
    d[3] = np.random.default_rng(31).standard_normal(70) + 3  # row at Wg
    dm = upload(pack(CSR.from_dense(d), rows), "cuda")
    assert dm.values.shape[1] == 70
    rng = np.random.default_rng(32)
    Xall = rng.standard_normal((70, max(WARP_SPMM_B)))
    Xall[rng.random(Xall.shape) < 0.1] = -0.0
    before = launches[f"{fmt}_spmm"]
    for B in WARP_SPMM_B:
        X = torch.as_tensor(Xall[:, :B], dtype=dm.dtype,
                            device="cuda").contiguous()
        for bn in WARP_SPMM_BN:
            got = spmm(dm, X, bn=bn)
            want = spmm_plain(dm, X, None if bn is None or bn >= B else bn)
            assert torch.equal(_bits(got), _bits(want)), (B, bn)
    torch.cuda.synchronize()
    n = len(WARP_SPMM_B) * len(WARP_SPMM_BN)
    assert launches[f"{fmt}_spmm"] - before == n


def _warp_launch(fmt, dm, X, g):
    """The SELL / RGCSR SpMM C entry with the geometry ``g``."""
    mats = [dm.indices, dm.stops] if fmt == "sell" else [dm.deltas, dm.nnz]
    y = torch.empty((dm.rows, X.shape[1]), dtype=dm.dtype, device="cuda")
    rc = getattr(padded.library(fmt, len(mats)), f"{fmt}_spmm_launch")(
        int(dm.dtype == torch.float64), *(t.data_ptr() for t in mats),
        dm.values.data_ptr(), dm.rows, dm.values.shape[1], X.data_ptr(),
        X.shape[0], X.shape[1], g.bt, *g.args(), y.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    return rc, y


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt", ["sell", "rgcsr"])
def test_warp_spmm_staged_and_l1_reads_agree_on_card(fmt, dtype):
    """x staged in shared memory and x read through L1 give the plain
    version's bits at every slab width; and a matrix of 2,000 columns,
    whose 32-column slab does not fit a block's shared memory, takes the L1
    path through the wrapper."""
    _need_card()
    pack, upload, _, spmm, _, spmm_plain, _ = COMPARATORS[fmt]
    rng = np.random.default_rng(34)
    for n in (60, 2000):
        d = _dense(90, n, 0.05, dtype, 35)
        dm = upload(pack(CSR.from_dense(d), 16), "cuda")
        for B in (3, 8, 33, 64):
            X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dm.dtype,
                                device="cuda")
            want = _bits(spmm_plain(dm, X).reshape(-1, B))
            g = tiling.padded_geometry(dm.rows, n, B, B, X.element_size())
            assert g.stage == (n == 60 or g.bw < 32)
            assert torch.equal(_bits(spmm(dm, X).reshape(-1, B)), want)
            for stage in (False, True):
                if stage and n * g.slab * X.element_size() > 200000:
                    continue                  # a slab no block can stage
                gs = tiling.padded_geometry(dm.rows, n, B, B,
                                            X.element_size(), stage=stage)
                rc, y = _warp_launch(fmt, dm, X, gs)
                assert rc == 0 and torch.equal(_bits(y), want), (n, B, stage)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["sell", "rgcsr"])
def test_warp_spmm_refuses_a_geometry_short_of_the_work(fmt):
    """The C entry checks the geometry it is given: one block too few,
    three columns a lane (two at f64) or more warps than the kernel's
    launch bounds is refused before anything runs."""
    _need_card()
    pack, upload, *_ = COMPARATORS[fmt]
    for dtype in (np.float32, np.float64):
        dm = upload(pack(CSR.from_dense(_dense(100, 30, 0.3, dtype, 33)),
                         32), "cuda")
        X = torch.ones((30, 64), dtype=dm.dtype, device="cuda")
        g = tiling.padded_geometry(dm.rows, 30, 64, 64, X.element_size())
        assert _warp_launch(fmt, dm, X, g)[0] == 0
        bad = [dataclasses.replace(g, blocks=g.blocks - 1),
               dataclasses.replace(g, cols_per_lane=3),
               dataclasses.replace(g, warps=tiling.PADDED_MAX_WARPS + 1)]
        if dtype == np.float64:
            bad.append(dataclasses.replace(g, cols_per_lane=2))
        for b in bad:
            assert _warp_launch(fmt, dm, X, b)[0] != 0, (dtype, b)


# The SELL / RGCSR SpMV (`padded_rows.cuh::spmv_lanes_kernel`, four lanes
# a row, each row stopped at its last real entry), on rows of
# `HAND_LENGTHS` entries and the hand-made packs of `hand_made_packs.py`.
LANES_SPMV_LAYOUTS = [("sell", 16), ("sell", 32), ("sell", 128),
                      ("rgcsr", 4), ("rgcsr", 8), ("rgcsr", 16),
                      ("rgcsr", 32)]


def _lengths_dense(m, n, dtype, seed):
    """(m, n) with row r holding HAND_LENGTHS[r % 8] nonzeros."""
    rng = np.random.default_rng(seed)
    d = np.zeros((m, n), dtype)
    for r in range(m):
        k = HAND_LENGTHS[r % len(HAND_LENGTHS)]
        d[r, rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    return d


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt,rows", LANES_SPMV_LAYOUTS,
                         ids=[f"{f}{r}" for f, r in LANES_SPMV_LAYOUTS])
def test_lanes_spmv_bitwise_plain_on_card(fmt, rows, dtype):
    """The SpMV bitwise its plain version on 141 rows (R not a multiple of
    32 at L = 16 and G = 4 or 8) of 0, 1, 3, 4, 5, 9, 2 and 12 entries,
    with -0.0 in x; the SELL stops are each row's length; every launch
    counted."""
    _need_card()
    pack, upload, spmv, _, spmv_plain, _, launches = COMPARATORS[fmt]
    d = _lengths_dense(141, 30, dtype, 62)
    dm = upload(pack(CSR.from_dense(d), rows), "cuda")
    if fmt == "sell":
        assert torch.equal(dm.stops[:141].cpu(), torch.as_tensor(
            (d != 0).sum(axis=1), dtype=torch.int32))
    rng = np.random.default_rng(63)
    before = launches[f"{fmt}_spmv"]
    for _ in range(5):
        x = rng.standard_normal(30)
        x[rng.random(30) < 0.2] = -0.0
        x = torch.as_tensor(x, dtype=dm.dtype, device="cuda")
        assert torch.equal(_bits(spmv(dm, x)), _bits(spmv_plain(dm, x)))
    torch.cuda.synchronize()
    assert launches[f"{fmt}_spmv"] - before == 5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", list(HAND_MADE))
def test_lanes_spmv_and_spmm_on_hand_made_packs_on_card(kind, dtype):
    """The hand-made packs: -1 holes before real entries (SELL), nonzero
    deltas past the count, and int32 running sums past 2^31 (RGCSR), with
    x of 13 and of 13,000 rows (the SpMM's x slab staged in shared memory,
    and read through L1). The SpMV and the SpMM (B = 3 and 40) bitwise
    their plain versions, every SpMM column bitwise the SpMV; at 13,000
    rows also the SpMV of a random matrix with rows of every length of
    HAND_LENGTHS."""
    _need_card()
    fmt = kind.split("-")[0]
    pack, upload, spmv, spmm, spmv_plain, spmm_plain, _ = COMPARATORS[fmt]
    rng = np.random.default_rng(64)
    for n in (13, 13000):
        dm = upload(HAND_MADE[kind](dtype, n), "cuda")
        X = torch.as_tensor(rng.standard_normal((n, 40)), dtype=dm.dtype,
                            device="cuda")
        cols = [spmv(dm, X[:, b].contiguous()) for b in range(40)]
        for b in range(40):
            assert torch.equal(_bits(cols[b]),
                               _bits(spmv_plain(dm, X[:, b]))), n
        for B in (3, 40):
            Y = spmm(dm, X[:, :B].contiguous())
            assert torch.equal(_bits(Y), _bits(spmm_plain(dm, X[:, :B]))), n
            for b in range(B):
                assert torch.equal(_bits(Y[..., b]), _bits(cols[b])), n
    dm = upload(pack(CSR.from_dense(_lengths_dense(100, 13000, dtype, 66)),
                     8), "cuda")
    for b in range(3):
        x = X[:, b].contiguous()
        assert torch.equal(_bits(spmv(dm, x)), _bits(spmv_plain(dm, x)))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_comparator_ops_on_card_vs_dense():
    _need_card()
    d = _dense(100, 60, 0.3, np.float64, 13)
    a = CSR.from_dense(d)
    X = np.random.default_rng(14).standard_normal((60, 5))
    for ps, one, many in (
            (SE.pack_sell(a, 32), ops.sell_spmv, ops.sell_spmm),
            (RG.pack_rgcsr(RGCSR.from_csr(a, 8)), ops.rgcsr_spmv,
             ops.rgcsr_spmm)):
        got = many(ps, X, bn=2)
        assert got.device.type == "cuda"
        _close(got.cpu(), torch.from_numpy(d @ X), got.dtype)
        _close(one(ps, X[:, 0]).cpu(), torch.from_numpy(d @ X[:, 0]),
               got.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", BCSR_BLOCK_SHAPES, ids=str)
def test_bcsr_kernels_bitwise_plain_on_card(bs, dtype):
    """At every registry block shape: SpMV and SpMM bitwise their plain
    versions, column tiles and B = 1 bitwise the untiled kernel and SpMV."""
    _need_card()
    d = _dense(61, 43, 0.15, dtype, 15)        # ragged edge blocks
    db = BC.to_device(BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), bs)),
                      "cuda")
    X = torch.as_tensor(np.random.default_rng(16).standard_normal((43, 64)),
                        dtype=db.dtype, device="cuda")
    x = X[:, 0].contiguous()
    y = BC.bcsr_spmv(db, x)
    assert torch.equal(y, BC.bcsr_spmv_plain(db, x))
    for B in (3, 64):
        Y = BC.bcsr_spmm(db, X[:, :B].contiguous())
        assert torch.equal(Y, BC.bcsr_spmm_plain(db, X[:, :B].contiguous()))
        assert torch.equal(BC.bcsr_spmm(db, X[:, :B].contiguous(), bn=24), Y)
    assert torch.equal(BC.bcsr_spmm(db, X[:, :1].contiguous())[..., 0], y)
    _close(y.reshape(-1)[:61].cpu(), torch.from_numpy(d @ x.cpu().numpy()),
           db.dtype)


@pytest.mark.gpu
def test_bcsr_edge_cells_multiply_last_x_on_card():
    """A real block's cells past column n - 1 multiply x[n - 1], as in the
    reference: an inf there makes those rows NaN, in kernel and plain
    version alike; padded slots stay selects."""
    _need_card()
    d = np.zeros((8, 7))
    d[0, 6] = 1.0                       # block (0, 3) of 2x2 holds col 7
    d[5, 1] = 2.0
    db = BC.to_device(BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), (2, 2))),
                      "cuda")
    x = torch.ones(7, dtype=torch.float64, device="cuda")
    x[6] = float("inf")
    y = BC.bcsr_spmv(db, x)
    torch.testing.assert_close(y, BC.bcsr_spmv_plain(db, x), rtol=0, atol=0,
                               equal_nan=True)
    assert bool(y.reshape(-1)[:2].isnan().all())
    assert bool(torch.isfinite(y.reshape(-1)[2:]).all())


# The BCSR kernels: every registry block shape (4 x 2 among them), one
# block row a chunk (32 x 2) and r = 3, which does not divide a chunk (the
# SpMM's per-row x reads).
BCSR_SHAPES = list(BCSR_BLOCK_SHAPES) + [(32, 2), (3, 2)]


def _bcsr_case(bs, dtype):
    """A 150 x 70 matrix (ragged edge blocks) with empty rows, block rows of
    padding only (rows 64-95), a -1 slot before real ones in the longest
    block row; x with -0.0."""
    d = _dense(150, 70, 0.15, dtype, 40)
    d[[5, 6, 40]] = 0
    d[64:96] = 0
    pb = BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), bs))
    s = int(np.argmax((pb.block_cols >= 0).sum(axis=1)))
    if pb.block_cols.shape[1] > 2 and pb.block_cols[s, 1] >= 0:
        pb.block_cols[s, 1] = -1            # masked, though real slots follow
        pb.values[s, 1] = 0
        d = np.zeros_like(d)                # the dense product of the pack
        r, c = bs
        for bi in range(pb.block_cols.shape[0]):
            for w, bcol in enumerate(pb.block_cols[bi]):
                if bcol < 0:
                    continue
                rows, cols = slice(bi * r, bi * r + r), slice(bcol * c,
                                                              bcol * c + c)
                d[rows, cols] = pb.values[bi, w][:d[rows, cols].shape[0],
                                                 :d[rows, cols].shape[1]]
    db = BC.to_device(pb, "cuda")
    rng = np.random.default_rng(41)
    X = rng.standard_normal((70, max(WARP_SPMM_B)))
    X[rng.random(X.shape) < 0.1] = -0.0
    return d, pb, db, X


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", BCSR_SHAPES, ids=str)
def test_bcsr_warp_spmm_and_spmv_bitwise_plain_on_card(bs, dtype):
    """The BCSR SpMV and the warp SpMM with the BCSR row policy, bitwise
    their plain versions at every B and tile of the sweep; every SpMM
    column bitwise the SpMV of that column; the launches counted."""
    _need_card()
    d, pb, db, Xall = _bcsr_case(bs, dtype)
    before = dict(BC.launches)
    cols = {}
    for b in range(Xall.shape[1]):
        x = torch.as_tensor(Xall[:, b], dtype=db.dtype, device="cuda")
        cols[b] = BC.bcsr_spmv(db, x)
        assert torch.equal(_bits(cols[b]), _bits(BC.bcsr_spmv_plain(db, x)))
    _close(cols[0].reshape(-1)[:150].cpu(),
           torch.from_numpy(d @ Xall[:, 0].astype(dtype)), db.dtype)
    for B in WARP_SPMM_B:
        X = torch.as_tensor(Xall[:, :B], dtype=db.dtype,
                            device="cuda").contiguous()
        for bn in WARP_SPMM_BN:
            got = BC.bcsr_spmm(db, X, bn=bn)
            want = BC.bcsr_spmm_plain(db, X, None if bn is None or bn >= B
                                      else bn)
            assert torch.equal(_bits(got), _bits(want)), (B, bn)
            if bn is None:
                for b in range(B):
                    assert torch.equal(_bits(got[..., b]), _bits(cols[b]))
    torch.cuda.synchronize()
    assert BC.launches["bcsr_spmv"] - before["bcsr_spmv"] == Xall.shape[1]
    assert BC.launches["bcsr_spmm"] - before["bcsr_spmm"] == \
        len(WARP_SPMM_B) * len(WARP_SPMM_BN)


def _bcsr_spmm_launch(db, X, g):
    """The BCSR SpMM's C entry with the geometry ``g`` given."""
    lib = padded.library("bcsr", 2, 3)
    y = torch.empty((db.rows, X.shape[1]), dtype=db.dtype, device="cuda")
    rc = lib.bcsr_spmm_launch(
        int(db.dtype == torch.float64), db.block_cols.data_ptr(),
        db.stops.data_ptr(), db.block_cols.shape[1], *db.block_shape,
        db.values.data_ptr(), db.rows, db.values.shape[1], X.data_ptr(),
        X.shape[0], X.shape[1], g.bt, *g.args(), y.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    return rc, y


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [(2, 2), (4, 4), (32, 2), (3, 2), (8, 1)],
                         ids=str)
def test_bcsr_x_staged_and_via_l1_bitwise_plain_on_card(bs, dtype):
    """x of 70 rows, which the SpMV stages in shared memory, and of 13,000
    rows (52 KB at f32, past its 48 KB of staging: read through L1), with
    cells near the last column: the SpMV and every SpMM column bitwise the
    plain SpMV; the SpMM's C entry refuses a geometry that does not cover
    the work."""
    _need_card()
    for n in (70, 13000):
        d = _dense(150, n, 12 / n, dtype, 46)
        d[::3, n - 1] = 1.5
        db = BC.to_device(BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), bs)),
                          "cuda")
        X = torch.as_tensor(np.random.default_rng(47).standard_normal(
            (n, 40)), dtype=db.dtype, device="cuda")
        got = BC.bcsr_spmm(db, X)
        for b in range(X.shape[1]):
            x = X[:, b].contiguous()
            want = _bits(BC.bcsr_spmv_plain(db, x))
            assert torch.equal(_bits(BC.bcsr_spmv(db, x)), want), (n, b)
            assert torch.equal(_bits(got[..., b]), want), (n, b)
        g = tiling.padded_geometry(db.rows, n, 40, 40, X.element_size())
        assert _bcsr_spmm_launch(db, X, g)[0] == 0
        bad = dataclasses.replace(g, blocks=g.blocks - 1)
        assert _bcsr_spmm_launch(db, X, bad)[0] != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 40, 64])
def test_bcsr_edge_cells_reach_inf_in_every_kernel_on_card(B):
    """An inf in x[n - 1] reaches a real block's cells past column n - 1
    in the SpMV and the warp SpMM alike (those rows NaN, as in the plain
    version), and no padded slot."""
    _need_card()
    d = np.zeros((8, 7))
    d[0, 6] = 1.0                       # block (0, 3) of 2x2 holds col 7
    d[5, 1] = 2.0
    db = BC.to_device(BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), (2, 2))),
                      "cuda")
    X = torch.ones((7, B), dtype=torch.float64, device="cuda")
    X[6] = float("inf")
    got = BC.bcsr_spmm(db, X) if B > 1 else BC.bcsr_spmv(db, X[:, 0])
    want = BC.bcsr_spmm_plain(db, X) if B > 1 else \
        BC.bcsr_spmv_plain(db, X[:, 0])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    got = got.reshape(8, -1)
    assert bool(got[:2].isnan().all())
    assert bool(torch.isfinite(got[2:]).all())


def _c1_matrix(L, dtype):
    d = _dense(L + 37, 90, 0.1, dtype, 42)
    return d, pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=L))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [3, 64])
def test_spmm_serves_lane_width_1024_on_card(B):
    """``ops.spmm`` at L = 1024, which the SpMM kernel does not take, runs
    the SpMV kernel once a column: bitwise the plain SpMM, and through
    `SparseLinear.apply`; ``dtans_spmv`` counts every column."""
    _need_card()
    d, pm = _c1_matrix(1024, np.float32)
    dm = to_device(pm, "cuda")
    X = torch.as_tensor(np.random.default_rng(43).standard_normal((90, B)),
                        dtype=torch.float32, device="cuda")
    before = dict(K.launches)
    got = ops.spmm(pm, X)
    torch.cuda.synchronize()
    assert K.launches["dtans_spmv"] - before["dtans_spmv"] == B
    assert K.launches["dtans_spmm"] == before["dtans_spmm"]
    want = K.dtans_spmm_plain(dm, X).reshape(-1, B)[:d.shape[0]]
    assert torch.equal(_bits(got), _bits(want))
    _close(got.cpu(), torch.from_numpy(d @ X.cpu().numpy()), torch.float32)
    w = (np.random.default_rng(44).standard_normal((64, 1100)) / 10).astype(
        np.float32)
    sl = SparseLinear.from_dense(w, sparsity=0.7, value_bits=6,
                                 lane_width=1024)
    x = torch.randn(B, 64, device="cuda")
    torch.testing.assert_close(sl.apply(x), sl.apply_dense_reference(x),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bn,B", [(np.float32, 400, 400),
                                        (np.float64, 400, 400),
                                        (np.float64, 512, 300)])
def test_spmm_caps_a_tile_that_overflows_shared_memory_on_card(dtype, bn, B):
    """An explicit ``bn`` (or ``bn >= B``) whose accumulator tile does not
    fit a block is cut to `tiling.dtans_widest_bn`: no refusal, the plain
    SpMM's bits."""
    _need_card()
    d, pm = _c1_matrix(128, dtype)
    dm = to_device(pm, "cuda")
    assert tiling.dtans_widest_bn(128, 1, np.dtype(dtype).itemsize) < B
    X = torch.as_tensor(np.random.default_rng(45).standard_normal((90, B)),
                        dtype=dm.dtype, device="cuda")
    got = ops.spmm(pm, X, bn=bn)
    want = K.dtans_spmm_plain(dm, X).reshape(-1, B)[:d.shape[0]]
    assert torch.equal(_bits(got), _bits(want))
    _close(got.cpu(), torch.from_numpy(d @ X.cpu().numpy()), dm.dtype)


def _bcsr_dtans(bs, dtype, seed):
    a = block_sparse(30, 7, (2, 3), 0.3, np.random.default_rng(seed),
                     dtype=dtype)
    d = a.to_dense()
    d[np.random.default_rng(seed + 1).random(d.shape) < 0.2] = 0
    return d, pack_matrix(encode_bcsr_matrix(CSR.from_dense(d), bs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs", [(2, 2), (4, 4), (40, 2)], ids=str)
def test_shared_cols_kernels_on_card(bs, dtype):
    """The fused BCSR-dtANS kernels: bitwise their plain versions and the
    generic kernels, tiles and B = 1 included; L = 40 spans two warps."""
    _need_card()
    d, pm = _bcsr_dtans(bs, dtype, 17)
    assert pm.shared_cols and pm.lane_width == bs[0]
    dm = to_device(pm, "cuda")
    X = torch.as_tensor(np.random.default_rng(18).standard_normal(
        (d.shape[1], 9)), dtype=dm.dtype, device="cuda")
    x = X[:, 0].contiguous()
    before = dict(K.launches)
    y = K.dtans_spmv(dm, x, shared_cols=True)
    assert torch.equal(y, K.dtans_spmv_plain(dm, x, shared_cols=True))
    assert torch.equal(y, K.dtans_spmv(dm, x))
    Y = K.dtans_spmm(dm, X, shared_cols=True)
    assert torch.equal(Y, K.dtans_spmm_plain(dm, X, shared_cols=True))
    assert torch.equal(Y, K.dtans_spmm(dm, X))
    assert torch.equal(K.dtans_spmm(dm, X, bn=4, shared_cols=True), Y)
    assert torch.equal(ops.spmm(pm, X), ops.spmm(pm, X, fused=False))
    torch.cuda.synchronize()
    _close(y.reshape(-1)[:d.shape[0]].cpu(),
           torch.from_numpy(d @ x.cpu().numpy()), dm.dtype)
    assert K.launches["dtans_spmv_shared"] - before["dtans_spmv_shared"] == 1
    assert K.launches["dtans_spmm_shared"] - before["dtans_spmm_shared"] == 3


@pytest.mark.gpu
def test_sparse_linear_over_bcsr_dtans_reaches_shared_kernels():
    _need_card()
    d, pm = _bcsr_dtans((2, 2), np.float32, 19)
    mat = encode_bcsr_matrix(CSR.from_dense(d), (2, 2))
    sl = SparseLinear(mat=mat, packed=pack_matrix(mat), d_in=d.shape[1],
                      d_out=d.shape[0], dense_bytes=d.nbytes,
                      baseline_bytes=0, device=torch.device("cuda"))
    K.reset_launches()
    x = torch.randn(5, d.shape[1], device="cuda")
    y = sl.apply(x)
    y1 = sl.apply(x[0])
    torch.cuda.synchronize()
    assert K.launches == {"dtans_spmv": 0, "dtans_spmm": 0,
                          "dtans_spmv_shared": 1, "dtans_spmm_shared": 1}
    torch.testing.assert_close(y, sl.apply_dense_reference(x), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(y1, sl.apply_dense_reference(x[0]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_decode_kernel_exact_on_card(packed):
    """Columns exactly, values bit for bit, padding -1 / +0."""
    _need_card()
    _, pm = packed
    before = DD.launches["dtans_decode"]
    cols, vals = ops.decode(pm)
    want_c, want_v = decode_ref(pm, device="cuda")
    torch.cuda.synchronize()
    assert DD.launches["dtans_decode"] - before == 1
    assert cols.dtype == torch.int32 and torch.equal(cols, want_c)
    bits = torch.int64 if vals.dtype == torch.float64 else torch.int32
    assert torch.equal(vals.view(bits), want_v.view(bits))
    assert not bool(vals[cols < 0].view(bits).any())


# The staged decode kernel at lane widths of packed narrow slices (idle
# threads at 3 and 5), one warp plus one, and 4 and 32 warps.
DECODE_L = (1, 3, 4, 5, 31, 33, 100, 1024)


def _decode_csr(L, dtype, seed):
    """1.5 slices of L rows (at least 600) over 60 columns: one row of 35
    entries in the first slice (max_nseg 9, odd), the rest 0 to 31 (the
    other slices end before max_nseg), a third of them empty; random
    values (escapes)."""
    rng = np.random.default_rng(seed)
    m = max(L + L // 2 + 1, 600)
    lens = rng.integers(0, 32, size=m)
    lens[rng.random(m) < 1 / 3] = 0
    lens[min(L, m) // 2] = 35
    indptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(60, k, replace=False))
                              for k in lens]).astype(np.int32)
    values = rng.standard_normal(int(indptr[-1])).astype(dtype)
    return CSR(indptr, indices, values, (m, 60))


def _check_staged_decode(pm):
    """The decode kernel bitwise its plain version and `decode_ref`, its
    launch counted once."""
    dm = to_device(pm, "cuda")
    want_c, want_v = DD.dtans_decode_plain(dm)
    ref_c, ref_v = decode_ref(pm, device="cuda")
    bits = torch.int64 if dm.dtype == torch.float64 else torch.int32
    assert torch.equal(want_c, ref_c)
    assert torch.equal(want_v.view(bits), ref_v.view(bits))
    before = DD.launches["dtans_decode"]
    cols, vals = DD.dtans_decode(dm)
    torch.cuda.synchronize()
    assert DD.launches["dtans_decode"] - before == 1
    assert torch.equal(cols, want_c)
    assert torch.equal(vals.view(bits), want_v.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shared", [
    (np.float32, True), (np.float32, False), (np.float64, True),
    (np.float64, False)], ids=["f32-1tab", "f32-2tab", "f64-1tab",
                               "f64-2tab"])
@pytest.mark.parametrize("L", DECODE_L)
def test_staged_decode_bitwise_plain(L, dtype, shared):
    """Odd max_nseg (9: the last flush holds one segment), slices whose
    segment count stays below it (the padding written from registers),
    lanes of no segment, escapes; one and two tables."""
    _need_card()
    mat = encode_matrix(_decode_csr(L, dtype, L), lane_width=L,
                        shared_table=shared)
    pm = pack_matrix(mat)
    assert pm.max_nseg == 9 and len(mat.tables) == (1 if shared else 2)
    assert int(mat.esc_count_by_domain.sum()) > 0
    assert ((pm.ns + 7) // 8).max(axis=1).min() < pm.max_nseg
    _check_staged_decode(pm)


@pytest.mark.gpu
def test_staged_decode_base_256_table():
    """A table of base 256 (the limb shift)."""
    _need_card()
    d = np.zeros((300, 300))
    for i in range(300):
        d[i, max(0, i - 4):i + 5] = np.where(np.arange(
            max(0, i - 4), min(300, i + 5)) % 3 == 0, -1.0, 4.0)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=32))
    assert int(pm.tab_base.max()) == 256
    _check_staged_decode(pm)


@pytest.mark.gpu
def test_decode_smem_plan_matches_the_kernel():
    """`tiling.decode_geometry`'s plan and the built decode kernel's own
    count agree."""
    _need_card()
    for L in DECODE_L:
        for T in (1, 2):
            for item in (4, 8):
                assert DD.smem_need(T, L, item) == tiling.decode_geometry(
                    1, L, T, item).smem


@pytest.mark.gpu
def test_bcsr_ops_on_card_vs_dense():
    _need_card()
    d = _dense(100, 60, 0.3, np.float64, 20)
    pb = BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), (4, 2)))
    X = np.random.default_rng(21).standard_normal((60, 5))
    got = ops.bcsr_spmm(pb, X, bn=2)
    assert got.device.type == "cuda"
    _close(got.cpu(), torch.from_numpy(d @ X), got.dtype)
    _close(ops.bcsr_spmv(pb, X[:, 0]).cpu(), torch.from_numpy(d @ X[:, 0]),
           got.dtype)


# The redesigned dtANS kernels at every lane width of chip_smoke.py's sweep:
# packed narrow slices (1 to 32 lanes), one warp, 2 to 32 warps.
SWEEP_L = (1, 3, 4, 8, 31, 32, 33, 40, 64, 100, 128, 256, 1024)


def _varied(m, n, dtype, seed):
    """Rows of 0 to ~40% density, so the lanes (and the packed slices) of
    a warp end at different segments."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= rng.random(m)[:, None] * 0.4] = 0
    return d


def _check_dtans_bitwise(pm):
    """SpMV, SpMM, tiles, B = 1, ``pipeline`` and decode: kernel vs plain
    (and vs each other) bitwise."""
    dm = to_device(pm, "cuda")
    X = torch.as_tensor(np.random.default_rng(22).standard_normal(
        (pm.shape[1], 6)), dtype=dm.dtype, device="cuda")
    x = X[:, 0].contiguous()
    y = K.dtans_spmv(dm, x)
    assert torch.equal(y, K.dtans_spmv_plain(dm, x))
    assert torch.equal(ops.spmv(pm, x, pipeline=True), ops.spmv(pm, x))
    if pm.lane_width <= tiling.MAX_SPMM_LANE_WIDTH:
        Y = K.dtans_spmm(dm, X)
        assert torch.equal(Y, K.dtans_spmm_plain(dm, X))
        assert torch.equal(K.dtans_spmm(dm, X, bn=4), Y)
        assert torch.equal(K.dtans_spmm(dm, X[:, :1].contiguous())[..., 0], y)
        assert torch.equal(ops.spmm(pm, X, pipeline=True), ops.spmm(pm, X))
    else:
        with pytest.raises(ValueError, match="lane widths up to"):
            K.dtans_spmm(dm, X)
    cols, vals = ops.decode(pm)
    want_c, want_v = decode_ref(pm, device="cuda")
    bits = torch.int64 if vals.dtype == torch.float64 else torch.int32
    assert torch.equal(cols, want_c)
    assert torch.equal(vals.view(bits), want_v.view(bits))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("L", SWEEP_L)
def test_dtans_kernels_bitwise_at_every_lane_width(L, dtype):
    """f32 on one table, f64 on two (escapes in both: random values)."""
    _need_card()
    d = _varied(max(L + L // 2 + 1, 100), 60, dtype, L)
    _check_dtans_bitwise(pack_matrix(encode_matrix(
        CSR.from_dense(d), lane_width=L,
        shared_table=dtype == np.float32)))


@pytest.mark.gpu
def test_packed_slices_with_different_segment_counts():
    """L = 4: eight slices share a warp; slice k's rows hold about 6k
    entries, so the warp's slices end at eight different segment counts
    (0 to 11; some lanes hold none)."""
    _need_card()
    d = np.zeros((64, 80))
    rng = np.random.default_rng(23)
    for i in range(64):
        k = 6 * ((i // 4) % 8) - (i % 4)
        if k > 0:
            d[i, rng.choice(80, k, replace=False)] = rng.standard_normal(k)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=4))
    nsegs = (pm.ns[:8] + 7) // 8
    assert len(set(nsegs.max(axis=1).tolist())) == 8
    _check_dtans_bitwise(pm)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [(1, 2), (2, 2), (8, 1)], ids=str)
def test_shared_cols_on_packed_slices_use_the_group_base_lane(bs):
    """Packed BCSR-dtANS slices gather at their own lane 0's columns (the
    group's base lane, not the warp's lane 0): every slice here has other
    columns, so a wrong lane would change the result."""
    _need_card()
    a = block_sparse(48, 30, bs, 0.3, np.random.default_rng(24))
    pm = pack_matrix(encode_bcsr_matrix(a, bs))
    assert pm.shared_cols and pm.lane_width == bs[0]
    dm = to_device(pm, "cuda")
    X = torch.as_tensor(np.random.default_rng(25).standard_normal(
        (a.shape[1], 5)), dtype=dm.dtype, device="cuda")
    x = X[:, 0].contiguous()
    y = K.dtans_spmv(dm, x, shared_cols=True)
    assert torch.equal(y, K.dtans_spmv_plain(dm, x, shared_cols=True))
    assert torch.equal(y, K.dtans_spmv(dm, x))
    Y = K.dtans_spmm(dm, X, shared_cols=True)
    assert torch.equal(Y, K.dtans_spmm_plain(dm, X, shared_cols=True))
    assert torch.equal(Y, K.dtans_spmm(dm, X))
    _close(y.reshape(-1)[:a.shape[0]].cpu(),
           torch.from_numpy(a.to_dense() @ x.cpu().numpy()), dm.dtype)


@pytest.mark.gpu
def test_racc_two_pow_32_table_on_card():
    """A table with base 256 (a digit group's radix of exactly 2^32, the
    kernels' limb shift): kernels and decode bitwise their plain
    versions."""
    _need_card()
    d = np.zeros((300, 300))
    for i in range(300):
        d[i, max(0, i - 4):i + 5] = np.where(np.arange(
            max(0, i - 4), min(300, i + 5)) % 3 == 0, -1.0, 4.0)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=32))
    assert int(pm.tab_base.max()) == 256
    _check_dtans_bitwise(pm)


@pytest.mark.gpu
def test_smem_plan_matches_the_kernels():
    """`tiling.smem_plan` and the built kernels' own count agree."""
    _need_card()
    for L in SWEEP_L:
        for T in (1, 2):
            for item in (4, 8):
                upb = tiling.geometry(1, L, T, item).units_per_block
                assert K.smem_need(False, T, L, item) == tiling.smem_plan(
                    T, L, item, units_per_block=upb)["total"]
                assert K.smem_need(True, T, L, item, 8) == tiling.smem_plan(
                    T, L, item, bn=8)["total"]



def _autotune_csr():
    return CSR.from_dense(np.round(_dense(700, 300, 0.1, np.float32, 9) * 4)
                          / 4)


@pytest.mark.gpu
def test_time_kernel_of_a_dtans_runner_on_card():
    _need_card()
    a = _autotune_csr()
    for batch, kind in ((1, "dtans_spmv"), (8, "dtans_spmm")):
        run = measure.spmv_runner(a, "dtans", batch=batch, lane_width=32,
                                  device="cuda")
        K.reset_launches()
        ts = measure.time_kernel(run, warmup=1, repeats=5, device="cuda")
        assert ts > 0 and ts.n == 5 and np.isfinite(ts.iqr)
        # the warmup, one call before capture, the captured calls; the
        # replays launch from the graph, not through the wrapper
        assert K.launches[kind] == 2 + measure.GRAPH_CALLS


@pytest.mark.gpu
def test_time_kernel_leaves_host_work_out_on_card():
    _need_card()
    run = measure.spmv_runner(_autotune_csr(), "dtans", batch=8,
                              lane_width=32, device="cuda")
    kernel = measure.time_kernel(run, repeats=5, device="cuda")

    def slow_host():
        time.sleep(0.005)                 # host work a call from Python pays
        return run()
    ts = measure.time_kernel(slow_host, repeats=5, device="cuda")
    assert ts < 0.001 and ts < 3 * kernel, (float(ts), float(kernel))


@pytest.mark.gpu
def test_measured_select_on_card():
    _need_card()
    dec = autotune.select(_autotune_csr(), formats=("dtans", "sell",
                                                    "rgcsr_dtans"),
                          budget=3, batch=8, measure=True, device="cuda",
                          cache=autotune.DecisionCache(path=None))
    assert dec.measured_time is not None and dec.measured_time > 0
    assert all(row[3] is not None for row in dec.leaderboard[:3])


@pytest.mark.gpu
def test_cpu_measured_decision_is_not_served_on_card(tmp_path):
    _need_card()
    a = _autotune_csr()
    cache = autotune.DecisionCache(path=str(tmp_path / "cache.json"))
    kw = dict(formats=("dtans", "sell"), budget=2, measure=True,
              measure_repeats=2, cache=cache)
    on_cpu = autotune.select(a, device="cpu", **kw)
    autotune.clear_memo()
    K.reset_launches()
    SE.reset_launches()
    on_card = autotune.select(a, device="cuda", **kw)
    assert len(cache) == 2                   # a second, card-keyed entry
    assert sum(K.launches.values()) + sum(SE.launches.values()) > 0
    assert on_cpu.measured_time > 0 and on_card.measured_time > 0
    name = torch.cuda.get_device_name(0)
    assert any(k.endswith(f":cuda:{name}") for k in cache._load())


@pytest.mark.gpu
def test_engine_pooled_equals_sequential_with_compressed_head_on_card():
    """SmolLM-135M's smoke config on the card: a pooled engine (``slots=4``,
    one ``dtans_spmm`` launch a step and nothing else) gives each request
    the tokens a ``slots=1`` engine gives it (one ``dtans_spmv`` a
    step)."""
    _need_card()
    cfg = configs.get_smoke("smollm-135m").with_(vocab=64)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cuda")
    head = Engine.compress_lm_head(model, sparsity=0.6, value_bits=5,
                                   lane_width=32)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 64, size=n) for n in (1, 3, 7, 12, 5, 2)]
    outs, counts = [], []
    for slots in (4, 1):
        eng = Engine(model, slots=slots, max_seq=32, sparse_head=head,
                     metrics=obs.MetricsRegistry())
        K.reset_launches()
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        steps = eng.metrics.counter("engine.steps_total").value
        counts.append({k: v for k, v in K.launches.items() if v})
        assert counts[-1] == {"dtans_spmm" if slots > 1 else "dtans_spmv":
                              steps}, counts
        outs.append([list(r.out) for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.gpu
def test_moe_engine_pooled_equals_sequential_on_card():
    """qwen3-moe's smoke config through `Engine` on the card with a
    compressed head: the pooled engine (``slots=4``) gives each request
    the tokens a ``slots=1`` engine gives it. The capacity factor is
    raised to E / top_k, so that no assignment is dropped at 4 tokens a
    step: where assignments drop, a token's output depends on the other
    tokens of its step, in the reference too."""
    _need_card()
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    cfg = cfg.with_(vocab=64, capacity_factor=cfg.n_experts / cfg.top_k)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(1),
                            device="cuda")
    head = Engine.compress_lm_head(model, sparsity=0.6, value_bits=5,
                                   lane_width=32)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 64, size=n) for n in (1, 3, 7, 12, 5, 2)]
    outs = []
    for slots in (4, 1):
        eng = Engine(model, slots=slots, max_seq=32, sparse_head=head,
                     metrics=obs.MetricsRegistry())
        K.reset_launches()
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        steps = eng.metrics.counter("engine.steps_total").value
        counts = {k: v for k, v in K.launches.items() if v}
        assert counts == {"dtans_spmm" if slots > 1 else "dtans_spmv":
                          steps}, counts
        assert all(r.done for r in reqs)
        outs.append([list(r.out) for r in reqs])
    assert outs[0] == outs[1]


def _tree_map(fn, tree):
    """``fn`` over the tensors of a nested cache dict, in the same tree."""
    if isinstance(tree, dict):
        return {n: _tree_map(fn, t) for n, t in tree.items()}
    return fn(tree)


def _tree_pairs(a, b):
    """[(a leaf, b leaf)] of two caches of the same tree."""
    if isinstance(a, dict):
        return [p for n in a for p in _tree_pairs(a[n], b[n])]
    return [(a, b)]


FAMILY_ARCHS = ["mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b"]
                         + FAMILY_ARCHS)
def test_pooled_decode_step_reads_nothing_back_on_card(arch):
    """A pooled decode step with an inactive slot captures into a CUDA
    graph: capture fails if anything in the step waits on the card (a
    `.item()`, a `bincount`, a boolean mask). Its replay gives the eager
    step's hidden states and cache; the inactive slot keeps its bits in
    every cache line (KV, SSM state and conv tail, encoder memory)."""
    _need_card()
    model = api.build_model(configs.get_smoke(arch),
                            generator=torch.Generator().manual_seed(2),
                            device="cuda")
    toks = torch.tensor([[3], [0], [5], [9]], device="cuda")
    pos = torch.tensor([4, -1, 0, 7], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        cache = model.make_decode_cache(4, 16, dtype=torch.float32)
        _tree_map(lambda t: t.normal_(), cache)
        start = _tree_map(lambda t: t.clone(), cache)
        eager, _ = model.decode_hidden(cache, toks, pos)
        after = _tree_map(lambda t: t.clone(), cache)
        for new, old in _tree_pairs(after, start):
            axis = 0 if new.ndim == 3 else 1     # x0, memory: batch first
            assert torch.equal(new.select(axis, 1), old.select(axis, 1))
        for dst, src in _tree_pairs(cache, start):
            dst.copy_(src)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_hidden(cache, toks, pos)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            hidden, _ = model.decode_hidden(cache, toks, pos)
        for dst, src in _tree_pairs(cache, start):
            dst.copy_(src)
        g.replay()
        torch.cuda.synchronize()
    torch.testing.assert_close(hidden, eager, rtol=1e-4, atol=1e-5)
    for got, want in _tree_pairs(cache, after):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.fixture
def no_tf32():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_on_card_matches_the_cpu(arch, no_tf32):
    """The smoke model built on the card and on the CPU from one seeded
    generator (the same weights): `forward`, `prefill` with every cache
    leaf and a per-slot `decode_step` agree within rtol 1e-4 / atol 1e-5
    with TF32 off."""
    _need_card()
    cfg = configs.get_smoke(arch)
    models = [api.build_model(cfg, generator=torch.Generator().manual_seed(3),
                              device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(14)
    batch = {"inputs": torch.from_numpy(
        rng.integers(0, cfg.vocab, (3, 11)).astype(np.int64))}
    if cfg.family == "encdec":
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (3, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)))
    pos = torch.tensor([11, -1, 9], dtype=torch.int32)
    outs = []
    with torch.inference_mode():
        for m in models:
            b = {k: v.to(m.device) for k, v in batch.items()}
            fwd, _ = m.forward(b)
            last, cache, _ = m.prefill(b, max_seq=16)
            prefill_cache = _tree_map(lambda t: t.clone(), cache)
            step, cache = m.decode_step(cache, tok.to(m.device),
                                        pos.to(m.device))
            outs.append([fwd, last, step]
                        + [t for p in _tree_pairs(prefill_cache, cache)
                           for t in p])
    for want, got in zip(*outs):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_engine_pooled_equals_sequential_on_card(arch):
    """Each family's smoke model through `Engine` on the card with a
    compressed head: ``slots=4`` (one ``dtans_spmm`` a step) gives each
    request the tokens ``slots=1`` (one ``dtans_spmv`` a step) gives it."""
    _need_card()
    cfg = configs.get_smoke(arch)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(4),
                            device="cuda")
    head = Engine.compress_lm_head(model, sparsity=0.6, value_bits=5,
                                   lane_width=32)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (1, 3, 7, 12, 5)]
    outs = []
    for slots in (4, 1):
        eng = Engine(model, slots=slots, max_seq=24, sparse_head=head,
                     metrics=obs.MetricsRegistry())
        K.reset_launches()
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        steps = eng.metrics.counter("engine.steps_total").value
        counts = {k: v for k, v in K.launches.items() if v}
        assert counts == {"dtans_spmm" if slots > 1 else "dtans_spmv":
                          steps}, counts
        outs.append([list(r.out) for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m"])
def test_serve_launcher_runs_on_card(arch, capsys):
    _need_card()
    reqs = serve.main(["--arch", arch, "--smoke", "--requests",
                       "5", "--max-new-tokens", "4", "--sparse-head",
                       "--device", "cuda"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out
    assert torch.cuda.get_device_name(0) in out


def _fake_nvcc(tmp_path, body: str) -> str:
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body + "\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return str(bindir)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_failed_build_raises_with_log(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("not c++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", _fake_nvcc(
        tmp_path, 'echo "broken.cu(1): error: syntax" >&2; exit 2')
        + os.pathsep + os.environ.get("PATH", ""))
    with pytest.raises(RuntimeError, match="syntax"):
        _build.build_all(("broken",))
    assert not _build.library_path("broken").exists()


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", _fake_nvcc(
        tmp_path, 'while [ "$1" != "-o" ]; do shift; done; touch "$2"')
        + os.pathsep + os.environ.get("PATH", ""))
    first = _build.build_all(("k",))["k"]
    assert first.exists() and first.parent == tmp_path / "build"
    src.write_text("// two\n")
    second = _build.library_path("k")
    assert second != first and not second.exists()
    assert _build.build_all(("k",))["k"] == second and second.exists()


# ---------------------------------------------------------------------------
# the row-sharded path on the card
# ---------------------------------------------------------------------------

_SHARD_FORMATS = ("dtans", "rgcsr_dtans", "bcsr_dtans", "sell", "rgcsr",
                  "bcsr")


def _shard_case(fmt, dtype):
    from repro_torch.sparse.registry import get_format
    spec = get_format(fmt)
    a = CSR.from_dense(np.round(_dense(300, 90, 0.2, dtype, 21) * 4) / 4)
    return spec, a, spec.pack(a, **spec.conformance_knobs)


def _all_launches() -> dict:
    return {k: v for mod in (K, SE, RG, BC) for k, v in mod.launches.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt", _SHARD_FORMATS)
def test_shard_loop_on_card_bitwise_single_device(fmt, dtype):
    """The per-shard loop on the card is bitwise the format's single-device
    runner at 2 and 4 shards, B 1, 8 and 64, one launch a shard a pass."""
    from repro_torch.kernels import shard_ops
    _need_card()
    spec, a, packed = _shard_case(fmt, dtype)
    rng = np.random.default_rng(22)
    for B in (1, 8, 64):
        x = torch.as_tensor(rng.standard_normal((a.shape[1], B)),
                            dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                            device="cuda")
        if B == 1:
            want = spec.runner(packed, x[:, 0])()[:a.shape[0], None]
        else:
            want = spec.spmm_runner(packed, x)().reshape(-1, B)[:a.shape[0]]
        for k in (2, 4):
            plan = spec.shard(a, k, **spec.conformance_knobs)
            for mod in (K, SE, RG, BC):
                mod.reset_launches()
            got = shard_ops.shard_spmm(plan, x)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (fmt, B, k)
            assert sum(_all_launches().values()) == sum(
                r > 0 for r in plan.shard_rows), _all_launches()


@pytest.mark.gpu
def test_shard_collective_two_ranks_on_one_card():
    """Two gloo ranks on the one card (NCCL refuses two ranks on one GPU):
    each uploads its own shard, and both give bitwise the loop path; a
    ``device="cpu"`` pass under the CUDA mesh raises."""
    from repro_torch.kernels import shard_ops
    from repro_torch.launch.mesh import spawn

    import torch_shard_ranks
    _need_card()
    jobs, wants = [], []
    rng = np.random.default_rng(23)
    for fmt in _SHARD_FORMATS:
        spec, a, _ = _shard_case(fmt, np.float32)
        plan = spec.shard(a, 2, **spec.conformance_knobs)
        for B in (1, 8):
            x = rng.standard_normal((a.shape[1], B)).astype(np.float32)
            wants.append(shard_ops.shard_spmm(plan, x).cpu().numpy())
            jobs.append((shard_ops.host_plan(plan), x))
    ranks = spawn(2, torch_shard_ranks.rank_spmm, jobs, "cuda",
                  device_type="cuda")
    for r, res in enumerate(ranks):
        for job, want in zip(res, wants):
            assert np.array_equal(job["y"], want)
            assert job["uploaded"] == [j == r for j in range(2)]
    plan, x = jobs[0]
    msgs = spawn(2, torch_shard_ranks.refuse_cpu_call, plan, x,
                 device_type="cuda")
    assert all("mesh is on 'cuda'" in m for m in msgs), msgs


@pytest.mark.gpu
def test_pooled_step_with_a_two_shard_head_captures_on_card():
    """A pooled engine whose compressed head is a 2-shard layer gives the
    unsharded head's tokens (two ``dtans_spmm`` launches a step), and its
    ``decode_hidden`` + head step captures into a CUDA graph (nothing read
    back) whose replay gives the eager logits bitwise."""
    _need_card()
    cfg = configs.get_smoke("smollm-135m").with_(vocab=64)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cuda")
    kw = dict(sparsity=0.6, value_bits=5, lane_width=32)
    one = Engine.compress_lm_head(model, **kw)
    two = Engine.compress_lm_head(model, n_shards=2, **kw)
    assert two.plan.shard_rows == (32, 32)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 64, size=n) for n in (1, 3, 7, 12, 5, 2)]
    outs = []
    for head in (one, two):
        eng = Engine(model, slots=4, max_seq=32, sparse_head=head,
                     metrics=obs.MetricsRegistry())
        K.reset_launches()
        reqs = [eng.submit(p, 5) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        steps = eng.metrics.counter("engine.steps_total").value
        per_step = 1 if head is one else 2
        assert {k: v for k, v in K.launches.items() if v} == \
            {"dtans_spmm": per_step * steps}
        outs.append([list(r.out) for r in reqs])
    assert outs[0] == outs[1]
    toks = torch.tensor([[3], [0], [5], [9]], device="cuda")
    pos = torch.tensor([4, 2, 0, 7], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        cache = model.make_decode_cache(4, 16, dtype=torch.float32)

        def step():
            hidden, _ = model.decode_hidden(cache, toks, pos)
            return two.apply(hidden)
        eager = step()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            logits = step()
        g.replay()
        torch.cuda.synchronize()
        hidden, _ = model.decode_hidden(cache, toks, pos)
        assert torch.equal(two.apply(hidden), one.apply(hidden))
    assert torch.equal(logits, eager)


def _train_example():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_smoke_train_step_on_card():
    """One AdamW step of the smoke SmolLM at 2 microbatches on the card:
    the loss is the CPU trainer's on the same weights (rtol 1e-4), the
    gradient norm finite and every parameter moved."""
    _need_card()
    cfg = configs.get_smoke("smollm-135m")
    pipe = SyntheticTokens(PipelineConfig(vocab=cfg.vocab, seq_len=32,
                                          global_batch=4))
    losses = []
    for dev in ("cpu", "cuda"):
        t = Trainer(cfg, TrainConfig(microbatches=2), pipe, device=dev,
                    generator=torch.Generator().manual_seed(3))
        before = [p.detach().clone() for p in t.params]
        m = t.train_step(pipe.batch(0))
        assert bool(torch.isfinite(m["gnorm"])) and float(m["gnorm"]) > 0
        assert all(not torch.equal(p, b) for p, b in zip(t.params, before))
        losses.append(float(m["loss"]))
    assert losses[1] == pytest.approx(losses[0], rel=1e-4)


@pytest.mark.gpu
def test_sparse_head_eval_launches_dtans_spmm_on_card():
    """`examples/train_lm_torch.py::sparse_head_eval` contracts the whole
    (B, S) pool of a smoke model in one ``dtans_spmm`` launch, within
    rtol 1e-4 / atol 1e-5 of the decoded head, its first rows bitwise
    the same rows applied alone."""
    _need_card()
    cfg = configs.get_smoke("smollm-135m").with_(vocab=256)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cuda")
    batch = SyntheticTokens(PipelineConfig(vocab=256, seq_len=64,
                                           global_batch=4)).batch(0)
    K.reset_launches()
    dense, sparse, head, hidden, logits = _train_example().sparse_head_eval(
        model, cfg, batch, sparsity=0.6)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.launches.items() if v} == {"dtans_spmm": 1}
    assert logits.shape == (4, 64, 256) and logits.is_cuda
    assert torch.allclose(logits, head.apply_dense_reference(hidden),
                          rtol=1e-4, atol=1e-5)
    assert torch.equal(head.apply(hidden.reshape(-1, cfg.d_model)[:16]),
                       logits.reshape(-1, 256)[:16])
    assert np.isfinite(dense) and np.isfinite(sparse)


def _example(name: str):
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_cg_example_runs_b1_on_card():
    """`examples/cg_solver_torch.py` on the card: one ``dtans_spmv`` launch
    an iteration and one for the first residual, the solution within the
    reference's 1e-6, the iterations within one of the CPU run's."""
    _need_card()
    mod = _example("cg_solver_torch")
    K.reset_launches()
    got = mod.main(device="cuda")
    torch.cuda.synchronize()
    assert {k: v for k, v in K.launches.items() if v} == \
        {"dtans_spmv": got["iterations"] + 1}
    assert got["rel_error"] < 1e-6
    assert abs(mod.main(device="cpu")["iterations"] - got["iterations"]) <= 1


@pytest.mark.gpu
def test_data_parallel_launcher_on_card():
    """`launch.train --ranks 2` on the card (gloo where the ranks share
    one card): both ranks log the same all-reduced losses."""
    _need_card()
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps",
                             "2", "--batch", "4", "--seq", "32", "--ranks",
                             "2"])
    assert [r["rank"] for r in out] == [0, 1]
    assert out[0]["history"] == out[1]["history"]
    assert all(np.isfinite(out[0]["history"]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_gradient_is_the_indexings_on_card(dtype):
    """The one-device `layers.Embedding` on the card: its output and its
    table's gradient, with tokens repeated (a batch of 16 x 512 drawn from
    4096 of SmolLM-135M's 49152 rows), bitwise those of the indexing
    ``tok[tokens]``."""
    from repro_torch.models import layers
    _need_card()
    cfg = configs.get("smollm-135m").with_(dtype=dtype)
    emb = layers.Embedding(cfg, torch.Generator().manual_seed(0),
                           device="cuda")
    emb.tok.requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, 4096, (16, 512), generator=g, device="cuda")
    up = torch.randn(16, 512, cfg.d_model, generator=g,
                     device="cuda").to(emb.tok.dtype)
    out = emb(ids)
    assert torch.equal(out, emb.tok[ids])
    got, = torch.autograd.grad(out, emb.tok, up)
    want, = torch.autograd.grad(emb.tok[ids], emb.tok, up)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_tp_decode_step_two_ranks_on_one_card():
    """Tensor parallelism on the card: a float32 smoke SmolLM placed on a
    (1, 2) mesh of two gloo ranks of the one card (NCCL refuses two ranks
    on one GPU); its prefill and decode step within rtol 1e-4 / atol 1e-5
    of the one-device model's on every rank."""
    from repro_torch.launch.mesh import spawn

    import torch_tp_ranks
    _need_card()
    ranks = spawn(2, torch_tp_ranks.decode_body, "cuda", device_type="cuda",
                  axes=("data", "model"), shape=(1, 2))
    for r in ranks:
        np.testing.assert_allclose(r["tp"], r["one"], rtol=1e-4, atol=1e-5)
