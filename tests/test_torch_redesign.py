"""The host side of the redesigned dtANS kernels, on the CPU.

The CUDA kernels (`csrc/dtans_spmv.cu`, `csrc/dtans_decode.cu`) stage the
coding tables packed 12 bytes a slot (`pack.pack_tables`), take their
launch geometry and shared-memory plan from `kernels.tiling`, and always
run the reference's ``pipeline`` schedule. This file holds those pieces:
the packed tables round-trip exactly; every (slice, lane) maps to exactly
one (block, iteration, thread); every plan that `tiling.choose_bn` picks
fits the block's 232,448 bytes; and ``pipeline=True`` gives bitwise the
result of ``pipeline=False`` and agrees with the JAX package's jnp oracles
(rtol 1e-4 f32 / 1e-12 f64, the reference's tolerances). The kernels
themselves are held against their plain versions on the card
(`tests/test_torch_gpu.py`).
"""

import numpy as np
import pytest
import torch

from repro.core.csr_dtans import encode_matrix as r_encode
from repro.core.csr_dtans import spmv_gold as r_spmv_gold
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import decode_ref as r_decode_ref
from repro.kernels.ref import spmv_ref as r_spmv_ref
from repro.sparse.formats import CSR as RCSR

from repro_torch.core.bcsr_dtans import encode_bcsr_matrix
from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.core.params import TOY
from repro_torch.core.rgcsr_dtans import encode_rgcsr_matrix
from repro_torch.kernels import common, ops, tiling
from repro_torch.kernels import dtans_spmv as K
from repro_torch.kernels.pack import (pack_matrix, pack_tables, to_device,
                                      unpack_tables)
from repro_torch.kernels.ref import decode_ref
from repro_torch.serving.sparse_linear import SparseLinear
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.random_graphs import stencil_2d


def _dense(m, n, density, dtype, seed, quantized=False):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    if quantized:
        d = np.round(d * 2) / 2
    d[rng.random((m, n)) >= density] = 0
    return d


def _quantized_f32():
    """The matrix of tests/goldens/bitstream_quant_f32_w16_shared.json."""
    rng = np.random.default_rng(42)
    d = np.round(rng.standard_normal((12, 18)) * 2) / 4
    d[rng.random(d.shape) < 0.55] = 0
    return d.astype(np.float32)


def _escapes_toy():
    """The matrix of tests/goldens/bitstream_escapes_f64_w4_toy.json."""
    rng = np.random.default_rng(43)
    d = rng.standard_normal((9, 11))
    d[rng.random(d.shape) < 0.5] = 0
    return CSR.from_dense(d)


# The six tests/goldens/ bitstreams' matrices, plus a table whose base
# reaches 256 (so a digit group's radix can be exactly 2^32).
TABLE_CASES = {
    "stencil6-f64-w32": lambda: encode_matrix(stencil_2d(6),
                                              lane_width=32),
    "stencil6-f64-w8-split": lambda: encode_matrix(
        stencil_2d(6), lane_width=8, shared_table=False),
    "quant-f32-w16": lambda: encode_matrix(CSR.from_dense(_quantized_f32()),
                                           lane_width=16),
    "escapes-f64-w4-toy": lambda: encode_matrix(_escapes_toy(), params=TOY,
                                                lane_width=4),
    "rgcsr-stencil6-f64-G8": lambda: encode_rgcsr_matrix(stencil_2d(6),
                                                         group_size=8),
    "bcsr-stencil6-f64-2x2": lambda: encode_bcsr_matrix(stencil_2d(6),
                                                        (2, 2)),
    "stencil16-base256": lambda: encode_matrix(stencil_2d(16),
                                               lane_width=32),
}


@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_packed_tables_round_trip(name):
    """symbol, digit, base and is_esc come back exactly from the packed
    (T, 3 K) tensor the kernels stage, f64 sign bits and base 256
    included; the device matrix carries that tensor and counts it."""
    pm = pack_matrix(TABLE_CASES[name]())
    packed = pack_tables(pm.tab_symbol, pm.tab_digit, pm.tab_base,
                         pm.tab_is_esc, pm.params)
    T, K = pm.tab_symbol.shape
    assert packed.shape == (T, 3 * K) and packed.dtype == np.int32
    sym, dig, base, esc = unpack_tables(packed, pm.params)
    np.testing.assert_array_equal(sym, pm.tab_symbol.astype(np.uint64))
    np.testing.assert_array_equal(dig, pm.tab_digit)
    np.testing.assert_array_equal(base, pm.tab_base)
    np.testing.assert_array_equal(esc, pm.tab_is_esc)
    dm = to_device(pm, "cpu")
    np.testing.assert_array_equal(dm.tables.numpy(), packed)
    assert dm.nbytes == (dm.stream.nbytes + dm.esc.nbytes + dm.ns.nbytes
                         + dm.nnz.nbytes + T * K * 12)
    if name == "stencil6-f64-w8-split":
        assert T == 2
    if name == "stencil16-base256":
        assert int(pm.tab_base.max()) == 256
    if name == "stencil6-f64-w32":
        assert bool((pm.tab_symbol >= 2 ** 63).any())    # -1.0's sign bit


def test_pack_tables_refuses_what_a_slot_cannot_hold():
    sym = np.zeros((1, 8), np.uint64)
    ok = np.ones((1, 8), np.int32)
    pack_tables(sym, ok * 255, ok * 256, ok)
    for dig, base, esc in ((ok * 256, ok, ok), (ok, ok * 512, ok),
                           (ok, ok, ok * 2), (-ok, ok, ok)):
        with pytest.raises(ValueError, match="range"):
            pack_tables(sym, dig, base, esc)


def test_racc_two_pow_32_decodes_exactly(monkeypatch):
    """A table with base 256 makes a digit group's radix exactly 2^32 (the
    kernels' limb shift); the decode that meets it gives the JAX
    package's columns and value bits."""
    seen = []
    real = common.limb_mul_add

    def spy(d, m, a):
        seen.append(int(torch.as_tensor(m).max()))
        return real(d, m, a)

    monkeypatch.setattr(common, "limb_mul_add", spy)
    a = stencil_2d(16)
    pm = pack_matrix(encode_matrix(a, lane_width=32))
    cols, vals = decode_ref(pm)
    assert max(seen) == 2 ** 32
    rm = r_encode(RCSR(a.indptr, a.indices, a.values, a.shape),
                  lane_width=32)
    rcols, rvals = (np.asarray(v) for v in r_decode_ref(r_pack(rm)))
    np.testing.assert_array_equal(cols.numpy(), rcols)
    np.testing.assert_array_equal(vals.numpy().view(np.uint64),
                                  rvals.view(np.uint64))


# ---------------------------------------------------------------------------
# launch geometry and shared-memory plan
# ---------------------------------------------------------------------------

def _lane_map(geom, n_slices, lane_width, tile=0):
    """For every (slice, lane), the (block, iteration, thread) that decodes
    it, as the kernels index (`csrc/dtans_spmv.cu`, `csrc/dtans_decode.cu`
    and `make_group` in `csrc/dtans_decode.cuh`): an (S, L, 3) array. SpMM
    geometries map column tile ``tile``'s decoder threads."""
    s = np.arange(n_slices)[:, None]
    lane = np.arange(lane_width)[None, :]
    u, gi = s // geom.slices_per_unit, s % geom.slices_per_unit
    wide = geom.unit_warps > 1
    in_unit = lane if wide else gi * geom.group + lane   # thread in unit
    if geom.consumer_warps:                              # SpMM work items
        item = u * geom.col_tiles + tile
        block, it, thread = item % geom.blocks, item // geom.blocks, in_unit
    else:
        upb = geom.units_per_block
        block = (u // upb) % geom.blocks
        it = u // (upb * geom.blocks)
        thread = (u % upb) * geom.unit_warps * tiling.WARP + in_unit
    return np.stack(np.broadcast_arrays(block, it, thread), axis=-1)


def _assert_one_to_one(geom, S, L, tile=0):
    m = _lane_map(geom, S, L, tile).reshape(-1, 3).astype(np.int64)
    key = (m[:, 0] * (m[:, 1].max() + 1) + m[:, 1]) * geom.threads + m[:, 2]
    assert np.unique(key).size == S * L
    assert (m[:, 0] < geom.blocks).all() and (m[:, 2] < geom.threads).all()
    decoders = geom.unit_warps * tiling.WARP * geom.units_per_block
    assert (m[:, 2] < decoders).all()       # never a contraction warp


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_every_lane_width_maps_each_lane_once(kind):
    """For every L in 1..1024 (SpMM: up to `MAX_SPMM_LANE_WIDTH`), each
    (slice, lane) has exactly one (block, iteration, thread) of a decoder
    warp, and the plan fits the block."""
    top = 1024 if kind == "spmv" else tiling.MAX_SPMM_LANE_WIDTH
    for L in range(1, top + 1):
        bn = None
        if kind == "spmm":
            bn = tiling.choose_bn(tiling.unit_rows(L), 20, 8,
                                  tiling.spmm_fixed_bytes(2, L, 8)) or 20
        for S in (1, 37):
            g = tiling.geometry(S, L, 2, 8, bn=bn, batch=20)
            assert g.threads <= 1024 and g.smem <= tiling.MAX_SMEM_BYTES
            _assert_one_to_one(g, S, L, tile=g.col_tiles - 1)


@pytest.mark.parametrize("S,L", [(384, 128), (12288, 4)],
                         ids=["head", "blocked-4x4"])
def test_main_path_geometries(S, L):
    """The SmolLM-135M head (384 slices of 128 lanes) and the 4x4-pruned
    head as BCSR-dtANS (12,288 slices of 4 lanes): every lane decoded by
    one thread, every slice in flight at once on 132 SMs."""
    g = tiling.geometry(S, L, 1, 4)
    _assert_one_to_one(g, S, L)
    assert g.blocks * g.units_per_block >= g.units
    gm = tiling.geometry(S, L, 1, 4, bn=64, batch=512)
    for tile in (0, gm.col_tiles - 1):
        _assert_one_to_one(gm, S, L, tile)
    assert (g.group, g.slices_per_unit) == ((128, 1) if L == 128 else (4, 8))


def test_plan_fits_at_every_chosen_bn():
    """Every tile `choose_bn` picks beside the dtANS SpMM plan's fixed part
    (or the whole batch, where it returns None) fits 232,448 B, and so
    does every tile `tiling.dtans_bn` picks (at most 64 columns)."""
    for L in range(1, tiling.MAX_SPMM_LANE_WIDTH + 1, 7):
        for T in (1, 2):
            for item in (4, 8):
                fixed = tiling.spmm_fixed_bytes(T, L, item)
                for batch in (2, 33, 64, 512, 4096):
                    for widest in (None, tiling.DTANS_BN_MAX):
                        bn = tiling.choose_bn(tiling.unit_rows(L), batch,
                                              item, fixed, widest)
                        bt = batch if bn is None else bn
                        plan = tiling.smem_plan(T, L, item, bn=bt)
                        assert plan["total"] <= tiling.MAX_SMEM_BYTES, \
                            (L, T, item, batch, bn, plan)
                        assert plan["total"] == tiling.geometry(
                            3, L, T, item, bn=bt, batch=batch).smem
                    assert tiling.dtans_bn(L, T, batch, item) == bn
                    assert bt <= max(tiling.DTANS_BN_MAX, 1)


def test_head_tiles():
    """The SmolLM-135M head (L = 128, f32, one table): B = 64 untiled, B =
    512 in tiles of 64 (a wider tile ran slower on an H100)."""
    assert tiling.dtans_bn(128, 1, 64, 4) is None
    assert tiling.dtans_bn(128, 1, 512, 4) == 64
    assert tiling.choose_bn(128, 512, 4) == 96


def test_wide_spmm_refused_with_a_clear_error():
    """SpMM takes L up to 992; SpMV (and so ops.spmm at B = 1) up to
    1024."""
    d = _dense(1000, 6, 0.5, np.float32, 4)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=1000))
    dm = to_device(pm, "cpu")
    K.spmv_geometry(dm)
    with pytest.raises(ValueError, match="lane widths up to 992"):
        K.spmm_geometry(dm, 4, 4)
    x = np.ones((6, 1), np.float32)
    assert torch.equal(ops.spmm(pm, x, device="cpu")[:, 0],
                       ops.spmv(pm, x[:, 0], device="cpu"))


# ---------------------------------------------------------------------------
# pipeline=
# ---------------------------------------------------------------------------

PIPE_CASES = {
    "f64-2tab-L32": (lambda: stencil_2d(10).to_dense(), 32, False),
    "f32-escapes-L16": (lambda: _dense(90, 70, 0.3, np.float32, 3), 16,
                        True),
    "f64-escapes-L40": (lambda: _dense(100, 80, 0.3, np.float64, 5), 40,
                        True),
    "f32-quantized-L4": (lambda: _dense(60, 50, 0.3, np.float32, 6, True), 4,
                         True),
}


@pytest.fixture(scope="module", params=list(PIPE_CASES))
def pipe_case(request):
    factory, L, shared = PIPE_CASES[request.param]
    d = factory()
    rm = r_encode(RCSR.from_dense(d), lane_width=L, shared_table=shared)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=L,
                                   shared_table=shared))
    return request.param, d, rm, pm


def _rtol(d):
    return 1e-12 if d.dtype == np.float64 else 1e-4


def test_pipeline_spmv_bitwise_and_vs_reference(pipe_case):
    name, d, rm, pm = pipe_case
    x = np.random.default_rng(8).standard_normal(d.shape[1]).astype(d.dtype)
    piped = ops.spmv(pm, x, device="cpu", pipeline=True)
    assert torch.equal(piped, ops.spmv(pm, x, device="cpu"))
    np.testing.assert_allclose(piped.numpy(),
                               np.asarray(r_spmv_ref(r_pack(rm), x)),
                               rtol=_rtol(d), atol=1e-30, err_msg=name)


@pytest.mark.parametrize("bn", [None, 2])
def test_pipeline_spmm_bitwise_and_vs_reference(pipe_case, bn):
    name, d, rm, pm = pipe_case
    X = np.random.default_rng(9).standard_normal((d.shape[1], 5)).astype(
        d.dtype)
    piped = ops.spmm(pm, X, device="cpu", bn=bn, pipeline=True)
    assert torch.equal(piped, ops.spmm(pm, X, device="cpu", bn=bn))
    for b in range(X.shape[1]):
        np.testing.assert_allclose(piped[:, b].numpy(),
                                   r_spmv_gold(rm, X[:, b]), rtol=_rtol(d),
                                   atol=1e-6, err_msg=f"{name} column {b}")


def test_pipeline_on_blocked_pack_runs_fused():
    """A BCSR-dtANS pack runs the fused contraction either way."""
    d = _dense(40, 30, 0.3, np.float64, 10)
    pm = pack_matrix(encode_bcsr_matrix(CSR.from_dense(d), (4, 4)))
    assert pm.shared_cols
    X = np.random.default_rng(11).standard_normal((30, 3))
    got = ops.spmm(pm, X, device="cpu", pipeline=True)
    assert torch.equal(got, ops.spmm(pm, X, device="cpu", fused=False))
    np.testing.assert_allclose(got.numpy(), d @ X, rtol=1e-12, atol=1e-12)


def test_sparse_linear_apply_pipeline_bitwise():
    w = np.random.default_rng(12).standard_normal((8, 40)).astype(np.float32)
    sl = SparseLinear.from_dense(w, sparsity=0.5, lane_width=8,
                                 device="cpu")
    x = np.random.default_rng(13).standard_normal((3, 8)).astype(np.float32)
    assert torch.equal(sl.apply(x, pipeline=True), sl.apply(x))
    assert torch.equal(sl.apply(x[0], pipeline=True), sl.apply(x[0]))
