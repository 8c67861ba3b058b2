"""The port's host codec is byte-equal to the JAX package's.

`repro_torch.core.csr_dtans.encode_matrix` and
`repro_torch.kernels.pack.pack_matrix` run on the same seeded numpy
matrices as `repro`'s, and every stream, offset, escape stream, table and
packed array must match exactly — and match the frozen golden vectors in
``tests/goldens/`` for the CSR-dtANS cases.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import csr_dtans as r_csr_dtans
from repro.core.params import TOY as R_TOY
from repro.kernels import pack as r_pack
from repro.sparse import formats as r_formats
from repro.sparse import prune as r_prune
from repro.sparse.random_graphs import banded, erdos_renyi, stencil_2d

from repro_torch.core import csr_dtans
from repro_torch.core.params import PAPER, TOY, DtansParams
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.sparse import formats, prune

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _random_dense(m, n, density, dtype, seed, quantized=False):
    rng = _rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    if quantized:
        d = np.round(d * 2) / 2
    d[rng.random((m, n)) >= density] = 0
    return d


def _quantized_f32():
    rng = np.random.default_rng(42)
    d = np.round(rng.standard_normal((12, 18)) * 2) / 4
    d[rng.random(d.shape) < 0.55] = 0
    return d.astype(np.float32)


def _escape_heavy_f64():
    rng = np.random.default_rng(43)
    d = rng.standard_normal((9, 11))
    d[rng.random(d.shape) < 0.5] = 0
    return d


# name -> (dense factory, encode kwargs); the first ten mirror
# tests/test_kernels.py::_CASES, the rest the CSR-dtANS goldens.
CASES = {
    "stencil-f64": (lambda: stencil_2d(16).to_dense(),
                    dict(lane_width=32, shared_table=True)),
    "stencil-f64-2tab": (lambda: stencil_2d(16).to_dense(),
                         dict(lane_width=32, shared_table=False)),
    "er-f64": (lambda: erdos_renyi(200, 6, _rng(1)).to_dense(),
               dict(lane_width=128, shared_table=True)),
    "banded-f32": (lambda: banded(150, 4).to_dense().astype(np.float32),
                   dict(lane_width=64, shared_table=True)),
    "random-f64-escapes": (lambda: _random_dense(90, 70, 0.3, np.float64, 2),
                           dict(lane_width=16, shared_table=True)),
    "random-f32-escapes": (lambda: _random_dense(90, 70, 0.3, np.float32, 3),
                           dict(lane_width=16, shared_table=True)),
    "quantized-f32": (lambda: _random_dense(120, 80, 0.2, np.float32, 4,
                                            quantized=True),
                      dict(lane_width=32, shared_table=True)),
    "tall-skinny": (lambda: _random_dense(400, 9, 0.5, np.float64, 5),
                    dict(lane_width=128, shared_table=True)),
    "wide": (lambda: _random_dense(9, 400, 0.4, np.float64, 6),
             dict(lane_width=8, shared_table=True)),
    "empty-rows": (lambda: np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)]),
                   dict(lane_width=16, shared_table=True)),
    "many-escapes-f64": (lambda: _random_dense(80, 220, 0.3, np.float64, 7),
                         dict(lane_width=32, shared_table=True)),
    "golden-stencil6-w32": (lambda: stencil_2d(6).to_dense(),
                            dict(lane_width=32, shared_table=True)),
    "golden-stencil6-w8-split": (lambda: stencil_2d(6).to_dense(),
                                 dict(lane_width=8, shared_table=False)),
    "golden-quant-f32-w16": (_quantized_f32,
                             dict(lane_width=16, shared_table=True)),
    "golden-escapes-toy": (_escape_heavy_f64,
                           dict(lane_width=4, shared_table=True,
                                params="TOY")),
}

MAT_ARRAYS = ("stream", "slice_offsets", "esc_offsets", "row_nnz",
              "esc_count_by_domain", "pattern", "domain")
TABLE_FIELDS = ("slot_symbol", "slot_digit", "slot_base", "slot_is_esc")
TABLE_SCALARS = ("esc_first", "esc_base", "esc_raw_bits", "K", "M",
                 "used_slots")
PACK_ARRAYS = ("stream", "esc", "ns", "nnz", "row_valid", "tab_symbol",
               "tab_digit", "tab_base", "tab_is_esc")


def _encode_both(name):
    factory, kw = CASES[name]
    d = factory()
    kw = dict(kw)
    toy = kw.pop("params", None) == "TOY"
    ra = r_formats.CSR.from_dense(d)
    a = formats.CSR.from_dense(d)
    rm = r_csr_dtans.encode_matrix(ra, **kw, **({"params": R_TOY} if toy
                                                else {}))
    m = csr_dtans.encode_matrix(a, **kw, **({"params": TOY} if toy else {}))
    return d, ra, rm, a, m


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def encoded(request):
    return (request.param, *_encode_both(request.param))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def test_csr_from_dense_matches_reference(encoded):
    _, d, ra, _, a, _ = encoded
    for f in ("indptr", "indices", "values"):
        _same(getattr(ra, f), getattr(a, f), f)
    assert ra.shape == a.shape and ra.nbytes == a.nbytes


def test_encode_matrix_byte_equal(encoded):
    name, _, _, rm, _, m = encoded
    for f in MAT_ARRAYS:
        _same(getattr(rm, f), getattr(m, f), f"{name}.{f}")
    assert len(rm.esc_streams) == len(m.esc_streams)
    for t, (re, e) in enumerate(zip(rm.esc_streams, m.esc_streams)):
        _same(re, e, f"{name}.esc_streams[{t}]")
    assert len(rm.tables) == len(m.tables)
    for t, (rt, tt) in enumerate(zip(rm.tables, m.tables)):
        for f in TABLE_FIELDS:
            _same(getattr(rt, f), getattr(tt, f), f"{name}.tables[{t}].{f}")
        for f in TABLE_SCALARS:
            assert getattr(rt, f) == getattr(tt, f), f
        assert rt.first_slot == tt.first_slot
    assert rm.nbytes == m.nbytes
    assert rm.lane_width == m.lane_width and rm.shape == m.shape
    assert np.dtype(rm.dtype) == np.dtype(m.dtype)
    assert dict(vars(rm.params)) == dict(vars(m.params))


def test_pack_matrix_byte_equal(encoded):
    name, _, _, rm, _, m = encoded
    rp, p = r_pack.pack_matrix(rm), pack_matrix(m)
    for f in PACK_ARRAYS:
        _same(getattr(rp, f), getattr(p, f), f"{name}.packed.{f}")
    assert rp.pattern == p.pattern
    assert rp.max_nseg == p.max_nseg
    assert rp.lane_width == p.lane_width and rp.shape == p.shape
    assert rp.shared_cols is False and p.shared_cols is False


def test_decode_matrix_roundtrip(encoded):
    name, d, _, rm, a, m = encoded
    dec = csr_dtans.decode_matrix(m)
    _same(dec.indices, a.indices, f"{name} indices")
    _same(dec.values, a.values, f"{name} values")
    rdec = r_csr_dtans.decode_matrix(rm)
    _same(dec.indptr, rdec.indptr, f"{name} indptr")


def test_spmv_gold_matches_reference(encoded):
    name, d, _, rm, _, m = encoded
    x = _rng(10).standard_normal(d.shape[1]).astype(d.dtype)
    _same(csr_dtans.spmv_gold(m, x), r_csr_dtans.spmv_gold(rm, x),
          f"{name} spmv_gold")


def test_to_device_keeps_bits(encoded):
    """The torch tensors are bit-for-bit the packed arrays (unsigned words
    as signed patterns of the same width), cached per device."""
    _, _, _, _, _, m = encoded
    p = pack_matrix(m)
    dm = to_device(p, "cpu")
    assert to_device(p, "cpu") is dm
    assert dm.stream.dtype == torch.int32 and dm.esc.dtype == torch.int64
    _same(dm.stream.numpy().view(np.uint32).astype(np.uint64), p.stream,
          "stream")
    _same(dm.esc.numpy().view(np.uint64), p.esc, "esc")
    _same(dm.tab_symbol.numpy().view(np.uint64), p.tab_symbol, "tab_symbol")
    for f in ("ns", "nnz", "tab_digit", "tab_base", "tab_is_esc"):
        _same(getattr(dm, f).numpy(), getattr(p, f), f)
    assert dm.dtype == (torch.float64 if p.dtype == np.float64
                        else torch.float32)


GOLDENS = {
    "stencil6_f64_w32_shared": "golden-stencil6-w32",
    "stencil6_f64_w8_split": "golden-stencil6-w8-split",
    "quant_f32_w16_shared": "golden-quant-f32-w16",
    "escapes_f64_w4_toy": "golden-escapes-toy",
}


@pytest.mark.parametrize("golden", list(GOLDENS))
def test_golden_bitstream(golden):
    """The port's encode reproduces the frozen golden words."""
    with open(os.path.join(GOLDEN_DIR, f"bitstream_{golden}.json")) as f:
        want = json.load(f)
    _, _, _, _, m = _encode_both(GOLDENS[golden])
    assert m.nbytes == want["nbytes"]
    assert m.lane_width == want["lane_width"]
    assert list(m.shape) == want["shape"]
    assert np.dtype(m.dtype).name == want["dtype"]
    assert m.row_nnz.tolist() == want["row_nnz"]
    assert m.stream.tolist() == want["stream"]
    assert m.slice_offsets.tolist() == want["slice_offsets"]
    assert [e.tolist() for e in m.esc_streams] == want["esc_streams"]
    assert m.esc_offsets.tolist() == want["esc_offsets"]
    assert m.pattern.tolist() == want["pattern"]
    for t, wt in zip(m.tables, want["tables"]):
        assert t.esc_first == wt["esc_first"]
        assert t.esc_base == wt["esc_base"]
        assert t.used_slots == wt["used_slots"]


def test_goldens_cover_escapes_and_split_tables():
    mats = [_encode_both(c)[4] for c in GOLDENS.values()]
    assert any(m.esc_count_by_domain.sum() > 0 for m in mats)
    assert any(len(m.tables) == 2 for m in mats)


def test_many_escapes_case_escapes_at_paper_params():
    """The paper-parameter escape case really escapes (K = 4096 slots and
    more distinct f64 values than that)."""
    _, _, rm, _, m = _encode_both("many-escapes-f64")
    assert m.params == PAPER
    assert int(m.esc_count_by_domain.sum()) > 0
    assert int(rm.esc_count_by_domain.sum()) == int(
        m.esc_count_by_domain.sum())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sparsity,bits", [(0.5, 4), (0.8, 8)])
def test_prune_and_quantize_match_reference(dtype, sparsity, bits):
    w = (_rng(3).standard_normal((40, 64)) / 10).astype(dtype)
    ra = r_prune.codebook_quantize(r_prune.magnitude_prune(w, sparsity),
                                   bits=bits)
    a = prune.codebook_quantize(prune.magnitude_prune(w, sparsity),
                                bits=bits)
    for f in ("indptr", "indices", "values"):
        _same(getattr(ra, f), getattr(a, f), f)
    assert r_formats.best_baseline_nbytes(ra) == \
        formats.best_baseline_nbytes(a)


def test_params_validation_matches_reference():
    assert dict(vars(PAPER)) == {"w_bits": 32, "k_bits": 12, "l": 8,
                                 "o": 3, "f": 2, "m_bits": 8}
    with pytest.raises(ValueError):
        DtansParams(f=4, o=3)
