"""The dtANS kernels' parameter sets: every `DtansParams` the JAX package
decodes right, on the port's plain versions and host side.

The CUDA kernels (B1-B3: `csrc/dtans_spmv.cu`, `csrc/dtans_decode.cu`) are
compiled once per parameter set (`kernels._build`), with the set's slot
layout (`pack.pack_tables`), table placement and shared-memory plan
(`kernels.tiling`). Here, on the CPU, each set of `SETS` x f32 / f64 runs
through the port's plain `decode_ref`, `spmv_ref` and ``ops.spmm`` against
the JAX package's jnp oracles (`repro.kernels.ref`) and its numpy
`spmv_gold` (and its numpy `decode_matrix`) on the same seeded matrix:
decode bitwise, SpMV / SpMM within rtol 1e-12 (f64) / 1e-4 (f32). The
sets are `tests/param_sets.py`'s: `PAPER`, the reference's `TOY`, and
eight more that move the kernels' constants: ``(w_bits, k_bits, l, o, f,
m_bits)``. The kernels themselves are held
against their plain versions for each set on the card by
``tests/test_torch_gpu.py::test_param_set_kernels_vs_plain_on_card``
(that file imports no JAX).
"""

import functools

import numpy as np
import pytest
import torch
from param_sets import PARAM_SETS

from repro.core.csr_dtans import decode_matrix as r_decode_matrix
from repro.core.csr_dtans import encode_matrix as r_encode
from repro.core.csr_dtans import spmv_gold as r_spmv_gold
from repro.core.params import DtansParams as RParams
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import decode_ref as r_decode_ref
from repro.kernels.ref import spmv_ref as r_spmv_ref
from repro.sparse.formats import CSR as RCSR

from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.core.params import PAPER, TOY, DtansParams
from repro_torch.kernels import _build, ops, tiling
from repro_torch.kernels import dtans_spmv as K
from repro_torch.kernels.pack import (pack_matrix, pack_tables, to_device,
                                      unpack_tables)
from repro_torch.kernels.ref import decode_ref, spmv_ref
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.registry import get_format

RTOL = {np.float32: 1e-4, np.float64: 1e-12}

#: name -> (w_bits, k_bits, l, o, f, m_bits) (`param_sets`).
SETS = PARAM_SETS

#: Where each set's two tables go (`tiling.tables_in_smem`).
IN_SMEM = {"PAPER": True, "TOY": True, "K8": True, "K16": False,
           "W16": True, "W8": True, "M4": True, "L48": True, "M16": False,
           "L66": True}

M, N, DENSITY, LANE_WIDTH = 60, 50, 0.3, 16


def _params(name):
    return DtansParams(*SETS[name])


def _dense(dtype, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((M, N)).astype(dtype)
    d[rng.random((M, N)) >= DENSITY] = 0
    return d


@functools.lru_cache(maxsize=None)
def _case(name, dtype):
    """Both packages' encode of one seeded matrix at set ``name``: f64 with
    two tables (delta / value), f32 with one shared table; with x and X
    (B = 3). Cached per module: the K = 2^16 encodes take ~0.5 s."""
    d = _dense(dtype, 7 + len(name))
    shared = dtype == np.float32
    mat = encode_matrix(CSR.from_dense(d), params=_params(name),
                        lane_width=LANE_WIDTH, shared_table=shared)
    rmat = r_encode(RCSR.from_dense(d), params=RParams(*SETS[name]),
                    lane_width=LANE_WIDTH, shared_table=shared)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(N).astype(dtype)
    X = rng.standard_normal((N, 3)).astype(dtype)
    return d, mat, pack_matrix(mat), rmat, r_pack(rmat), x, X


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(SETS))
def test_plain_versions_match_the_reference(name, dtype):
    """The same pack byte for byte; decode bitwise the JAX package's gold
    decoder (`decode_matrix`) and, at f64, its jitted jnp oracle
    `decode_ref`; SpMV and SpMM within rtol of its `spmv_gold`. (One
    oracle compile a set: the compiles are most of this module's time.
    Its `spmv_ref` is held to the port's where the state overflows,
    `test_m16_state_overflow_is_the_references`.)"""
    d, mat, pm, rmat, rpm, x, X = _case(name, dtype)
    np.testing.assert_array_equal(pm.stream, rpm.stream)
    np.testing.assert_array_equal(pm.tab_base, rpm.tab_base)
    assert pm.pattern == tuple(rpm.pattern)
    cols, vals = decode_ref(pm)
    cols, vals = cols.numpy(), vals.numpy()
    gold = r_decode_matrix(rmat)
    rows_c = cols.reshape(-1, cols.shape[-1])[:M]
    rows_v = vals.reshape(-1, vals.shape[-1])[:M]
    real = rows_c >= 0
    np.testing.assert_array_equal(real.sum(1), np.diff(gold.indptr))
    np.testing.assert_array_equal(rows_c[real], gold.indices)
    np.testing.assert_array_equal(rows_v[real].view(np.uint8),
                                  gold.values.view(np.uint8))
    rtol = RTOL[dtype]
    if dtype == np.float64:
        rcols, rvals = r_decode_ref(rpm)
        np.testing.assert_array_equal(cols, np.asarray(rcols))
        np.testing.assert_array_equal(vals.view(np.uint8),
                                      np.asarray(rvals).view(np.uint8))
    y = spmv_ref(pm, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, r_spmv_gold(rmat, x), rtol=rtol,
                               atol=rtol)
    Y = ops.spmm(mat, torch.as_tensor(X), device="cpu").numpy()
    gold = np.stack([r_spmv_gold(rmat, X[:, j]) for j in range(3)], -1)
    np.testing.assert_allclose(Y, gold, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(Y, d.astype(np.float64) @ X, rtol=10 * rtol,
                               atol=10 * rtol)


@pytest.mark.parametrize("name", list(SETS))
def test_pack_tables_round_trip(name):
    """A set's tables come back exactly from its slot layout: 12 bytes a
    slot (a u32 meta word) where digit, base and is_esc fit 32 bits, 16
    (a u64) at m_bits = 16; the device matrix carries that layout."""
    p = _params(name)
    for dtype in (np.float32, np.float64):
        pm = _case(name, dtype)[2]
        T, Ks = pm.tab_symbol.shape
        assert Ks == p.K
        packed = pack_tables(pm.tab_symbol, pm.tab_digit, pm.tab_base,
                             pm.tab_is_esc, p)
        width = (2 + tiling.meta_words(p)) * p.K
        assert packed.shape == (T, width) and packed.dtype == np.int32
        assert packed.nbytes == T * p.K * tiling.slot_bytes(p)
        for got, want in zip(unpack_tables(packed, p),
                             (pm.tab_symbol.astype(np.uint64), pm.tab_digit,
                              pm.tab_base, pm.tab_is_esc)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(to_device(pm, "cpu").tables.numpy(),
                                      packed)
    assert tiling.slot_bytes(p) == (16 if name == "M16" else 12)


def test_m16_tables_reach_past_paper_slot():
    """M16's tables hold bases and digits past PAPER's 9-bit and 8-bit
    fields (its bases reach thousands): PAPER's slot refuses them, M16's
    own 16-byte slot holds them, and `to_device` (which every plain
    version goes through) packs them."""
    pm = _case("M16", np.float64)[2]
    assert int(pm.tab_base.max()) >= 512 and int(pm.tab_digit.max()) >= 256
    with pytest.raises(ValueError, match="range"):
        pack_tables(pm.tab_symbol, pm.tab_digit, pm.tab_base,
                    pm.tab_is_esc, PAPER)
    dm = to_device(pm, "cpu")
    assert tuple(dm.tables.shape) == (2, 4 * 2 ** 16)


@pytest.mark.parametrize("name", list(SETS))
def test_smem_plan_places_each_sets_tables(name):
    """Tables in shared memory where two fit beside the largest decode
    block, else in global memory (0 bytes of the plan); every SpMV and
    decode plan of every lane width fits a block, and so does every SpMM
    plan `ops.spmm` launches (the rest go one SpMV a column). PAPER's plan
    is byte for byte what it was: 98,304 bytes of tables."""
    p = _params(name)
    assert tiling.tables_in_smem(p) == IN_SMEM[name]
    for T in (1, 2):
        for L in (1, 4, 16, 32, 33, 128, 512, 992, 1024):
            for item in (4, 8):
                plan = tiling.smem_plan(T, L, item, params=p)
                want = tiling.table_bytes(T, p) if IN_SMEM[name] else 0
                assert plan["tables"] == (want + 15) & ~15
                dec = tiling.decode_geometry(7, L, T, item, params=p)
                assert dec.smem <= tiling.MAX_SMEM_BYTES
                assert tiling.geometry(7, L, T, item,
                                       params=p).smem <= dec.smem
                if tiling.spmm_by_columns(L, T, item, p):
                    # (or a ring of long segments outgrows the block)
                    assert L > tiling.MAX_SPMM_LANE_WIDTH or p.l >= 48
                    continue
                bn = tiling.dtans_bn(L, T, 512, item, p)
                g = tiling.geometry(7, L, T, item, bn=bn, batch=512,
                                    params=p)
                assert g.smem <= tiling.MAX_SMEM_BYTES
    if name == "PAPER":
        assert tiling.smem_plan(2, 128, 4)["tables"] == 98304
        assert tiling.decode_geometry(3, 1024, 2, 8, params=p).smem == 222464
        assert tiling.dtans_widest_bn(128, 1, 4, p) == 335
    if name == "K16":
        assert tiling.table_bytes(2, p) == 1572864


def test_l48_wide_slices_spmm_by_columns():
    """At l = 48 the SpMM ring of a 512-lane slice outgrows the block, so
    `ops.spmm` takes one SpMV a column: bitwise the plain SpMM."""
    p = _params("L48")
    assert not tiling.spmm_by_columns(128, 2, 8, p)
    assert tiling.spmm_by_columns(512, 1, 8, p)
    d = _dense(np.float64, 5)
    mat = encode_matrix(CSR.from_dense(d), params=p, lane_width=512)
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((N, 4)))
    got = ops.spmm(mat, X, device="cpu")
    dm = to_device(ops.get_packed(mat), "cpu")
    want = K.dtans_spmm_plain(dm, X).reshape(-1, 4)[:M]
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["K16", "L48", "W8", "TOY"])
@pytest.mark.parametrize("fmt", ["dtans", "rgcsr_dtans", "bcsr_dtans"])
def test_registry_carries_params(fmt, name):
    """``FormatSpec.spmv`` / ``spmm(params=...)`` encode and run at the
    set: the CSR-, RGCSR- and BCSR-dtANS packs carry it to the kernels'
    wrappers; within rtol of the dense product."""
    p = _params(name)
    spec = get_format(fmt)
    d = np.round(_dense(np.float64, 3) * 4) / 4
    a = CSR.from_dense(d)
    x = np.random.default_rng(4).standard_normal(N)
    knobs = dict(spec.conformance_knobs)
    packed = spec.pack(a, params=p, **knobs)
    assert packed.params == p
    y = spec.spmv(a, x, params=p, device="cpu", **knobs)
    np.testing.assert_allclose(np.asarray(y), d @ x, rtol=1e-12, atol=1e-12)
    X = np.random.default_rng(5).standard_normal((N, 3))
    Y = spec.spmm(a, torch.as_tensor(X), params=p, device="cpu", **knobs)
    np.testing.assert_allclose(np.asarray(Y), d @ X, rtol=1e-12,
                               atol=1e-12)


def test_shared_artifacts_keep_sets_apart():
    """One ``artifacts`` mapping memoizes each set's encode apart (PAPER's
    key as before)."""
    spec = get_format("dtans")
    a = CSR.from_dense(_dense(np.float64, 9))
    arts = {}
    paper = spec.pack(a, params=PAPER, artifacts=arts)
    k16 = spec.pack(a, params=_params("K16"), artifacts=arts)
    assert paper.params == PAPER and k16.params == _params("K16")
    assert spec.artifact_key(spec._knobs({})) in arts and len(arts) == 2


def test_m16_state_overflow_is_the_references():
    """Both packages' decoders hold the state in 96 bits, and a segment at
    M16 may grow it by M^l = 2^96 beyond a word: on a quantized matrix (few
    symbols, large bases) the reference's gold path runs off its stream
    and its oracle is far from the dense product. The port decodes it as
    the reference does, bit for bit (its kernels too: they are held to the
    plain versions); where the state fits (`_case`'s matrices) all agree
    with the dense product."""
    d = np.round(_dense(np.float64, 3) * 4) / 4
    p = _params("M16")
    assert p.w_bits + p.l * p.m_bits > 96
    rmat = r_encode(RCSR.from_dense(d), params=RParams(*SETS["M16"]),
                    lane_width=LANE_WIDTH)
    x = np.random.default_rng(4).standard_normal(N)
    with pytest.raises(IndexError):
        r_spmv_gold(rmat, x)
    rpm = r_pack(rmat)
    assert np.abs(np.asarray(r_spmv_ref(rpm, x)) - d @ x).max() > 1
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), params=p,
                                   lane_width=LANE_WIDTH))
    cols, vals = decode_ref(pm)
    rcols, rvals = r_decode_ref(rpm)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(rcols))
    np.testing.assert_array_equal(vals.numpy().view(np.uint8),
                                  np.asarray(rvals).view(np.uint8))


#: A valid set whose first slot spans three 4-bit stream words: the
#: reference's decoder reads two.
SPANS_THREE = (4, 12, 2, 6, 4, 8)


def test_kernels_refuse_a_set_the_reference_decodes_wrongly():
    """The one refusal left: a slot spanning more than the two stream
    words `segment_step` reads. The JAX package's oracle (and gold path)
    are far from the dense product there; the port's plain version copies
    the reference, and its kernels refuse the set by name."""
    d = _dense(np.float64, 2)
    x = np.random.default_rng(6).standard_normal(N)
    rmat = r_encode(RCSR.from_dense(d), params=RParams(*SPANS_THREE),
                    lane_width=LANE_WIDTH)
    assert np.abs(np.asarray(r_spmv_ref(r_pack(rmat), x)) - d @ x).max() > 1
    for ok in SETS:
        K.check_params(_params(ok))
    mat = encode_matrix(CSR.from_dense(d), params=DtansParams(*SPANS_THREE),
                        lane_width=LANE_WIDTH)
    dm = to_device(pack_matrix(mat), "cpu")
    with pytest.raises(ValueError, match="spans more than the two"):
        K.kernel_args(dm)


def test_m_bits_32_is_refused_by_name():
    """The kernels' own limit: a base of 2^32 does not fit their 32-bit
    digits. Such a set needs k_bits = 32 (M <= K), and its tables (2^32
    slots of 24 bytes) exceed a card's memory, so it is refused by name
    before any build; m_bits = 31 at the same K is taken."""
    with pytest.raises(ValueError, match="m_bits 32 > 31"):
        K.check_params(DtansParams(32, 32, 2, 2, 2, 32))
    K.check_params(DtansParams(32, 32, 2, 2, 2, 31))


def test_pattern_goes_as_words_past_64_positions():
    """Up to 64 segment positions the pattern is one signed 64-bit
    argument; past them an array of words (``PatternArg``), and the
    library's argument types say so."""
    assert K.pattern_arg([0, 1] * 4, 8) == 0b10101010
    assert K.pattern_arg([0, 1] * 32, 64) == -6148914691236517206
    words = K.pattern_arg([0, 1] * 33, 66)
    assert list(words) == [-6148914691236517206, 2]
    assert K.matrix_argtypes(PAPER) == K.MATRIX_ARGS
    l66, i = K.matrix_argtypes(_params("L66")), K._PATTERN
    assert K.MATRIX_ARGS[i] is K._LL and l66[i] is K._VP
    assert l66[:i] + l66[i + 1:] == K.MATRIX_ARGS[:i] + K.MATRIX_ARGS[i + 1:]


def test_one_library_a_set():
    """Each set builds its own library of the dtANS sources, named by the
    set and hashed over its defines; PAPER's keeps the bare stem; the
    comparator sources take no set."""
    paths = {_build.library_path("dtans_spmv", _params(n)) for n in SETS}
    assert len(paths) == len(SETS)
    assert _build.lib_name("dtans_decode", PAPER) == "dtans_decode"
    assert _build.lib_name("dtans_decode", TOY) == "dtans_decode-w2k3l2o3f2m2"
    assert _build.lib_name("sell_spmv", TOY) == "sell_spmv"
    k16 = _build.defines(_params("K16"))
    assert "-DDTANS_K_BITS=16" in k16 and "-DDTANS_TABLES_SMEM=0" in k16
    assert "-DDTANS_TABLES_SMEM=1" in _build.defines(PAPER)
