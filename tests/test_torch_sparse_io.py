"""The port's MatrixMarket reader and writer (`repro_torch.sparse.io`)
against the JAX package's (`repro.sparse.io`).

On the cases of `tests/test_sparse_io.py`: each package's `save_mtx`
writes the same bytes, each reads the other's file into the same CSR
arrays, both read the hand-written headers and bodies alike, and both
refuse the same malformed files.
"""

import gzip
import io

import numpy as np
import pytest

from repro.sparse.formats import CSR as RCSR
from repro.sparse.io import load_mtx as r_load
from repro.sparse.io import save_mtx as r_save
from repro.sparse.random_graphs import banded, stencil_2d

from repro_torch.sparse.formats import CSR
from repro_torch.sparse.io import load_mtx, save_mtx


def _random_13x17():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((13, 17))
    d[rng.random(d.shape) < 0.8] = 0
    return d


def _empty_rows():
    d = np.zeros((9, 4))
    d[0, 1] = 2.5
    d[8, 0] = -1.0
    return d


# name -> dense matrix (the matrices of tests/test_sparse_io.py)
MATRICES = {
    "banded": lambda: banded(200, 5).to_dense(),
    "stencil": lambda: stencil_2d(12).to_dense(),
    "random": _random_13x17,
    "empty-rows": _empty_rows,
    "precision": lambda: np.array([[np.pi, 0.0], [0.0, 1e-300]]),
    "f32": lambda: _random_13x17().astype(np.float32),
}


def _pair(d):
    return CSR.from_dense(d), RCSR.from_dense(d)


def _same(a, b):
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert a.values.dtype == b.values.dtype
    assert np.array_equal(a.values, b.values)


def _text(save, a, comment=None) -> str:
    buf = io.StringIO()
    save(buf, a, comment=comment)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_writers_write_the_same_bytes(name):
    a, ra = _pair(MATRICES[name]())
    comment = "test matrix\nsecond line"
    assert _text(save_mtx, a, comment) == _text(r_save, ra, comment)


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_each_reads_the_others_file(name, suffix, tmp_path):
    a, ra = _pair(MATRICES[name]())
    mine, theirs = tmp_path / f"port{suffix}", tmp_path / f"ref{suffix}"
    save_mtx(mine, a)
    r_save(theirs, ra)
    if suffix.endswith(".gz"):
        with gzip.open(mine, "rb") as f, gzip.open(theirs, "rb") as g:
            assert f.read() == g.read()
    else:
        assert mine.read_bytes() == theirs.read_bytes()
    _same(load_mtx(theirs), r_load(mine))
    _same(load_mtx(mine), r_load(theirs))
    # the reader gives float64 values; %.17g keeps every bit
    _same(load_mtx(mine), CSR(a.indptr, a.indices,
                              a.values.astype(np.float64), a.shape))


HAND_WRITTEN = {
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n"
               "% comment\n3 4 3\n1 1\n2 3\n3 4\n",
    "integer": "%%MatrixMarket matrix coordinate integer general\n"
               "2 2 2\n1 1 7\n2 2 -3\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 3\n1 1 2.0\n2 1 5.0\n3 2 -1.0\n",
    "skew-symmetric": "%%MatrixMarket matrix coordinate real "
                      "skew-symmetric\n2 2 1\n2 1 4.0\n",
    "array": "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "zero-nnz": "%%MatrixMarket matrix coordinate real general\n4 5 0\n",
}


@pytest.mark.parametrize("name", sorted(HAND_WRITTEN))
def test_both_read_hand_written_files_alike(name):
    txt = HAND_WRITTEN[name]
    got, want = load_mtx(io.StringIO(txt)), r_load(io.StringIO(txt))
    _same(got, want)
    # and the port writes back what the reference writes back
    assert _text(save_mtx, got) == _text(r_save, want)


BAD = [
    "not a banner at all\n1 1 0\n",
    "%%MatrixMarket matrix coordinate complex general\n1 1 0\n",
    "%%MatrixMarket matrix coordinate real hermitian\n1 1 0\n",
    "%%MatrixMarket tensor coordinate real general\n1 1 0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",
]


@pytest.mark.parametrize("txt", BAD, ids=range(len(BAD)))
def test_both_refuse_the_same_files(txt):
    with pytest.raises(ValueError):
        r_load(io.StringIO(txt))
    with pytest.raises(ValueError):
        load_mtx(io.StringIO(txt))


def test_gzipped_text_header(tmp_path):
    p = tmp_path / "x.mtx.gz"
    with gzip.open(p, "wt") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n"
                "1 1 1\n1 1 9.0\n")
    assert load_mtx(p).to_dense()[0, 0] == 9.0
    _same(load_mtx(p), r_load(p))
