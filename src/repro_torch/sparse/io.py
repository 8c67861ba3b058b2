"""MatrixMarket (.mtx) I/O — feed SuiteSparse-style matrices to the
tuner and benchmarks without a scipy dependency.

Supports the ``coordinate`` format with ``real`` / ``integer`` /
``pattern`` fields and ``general`` / ``symmetric`` / ``skew-symmetric``
symmetries, plus dense ``array real general`` files. ``.gz`` paths are
transparently decompressed. Writing always produces
``coordinate real general`` (the lossless lowest common denominator).

    from repro_torch.sparse.io import load_mtx, save_mtx
    a = load_mtx("suitesparse/bcsstk17.mtx.gz")   # -> formats.CSR
    decision = repro_torch.autotune.select(a)
"""

from __future__ import annotations

import gzip
import io as _io
import os

import numpy as np

from repro_torch.sparse.formats import CSR

_BANNER = "%%MatrixMarket"


def _open(path_or_file, mode: str):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    path = os.fspath(path_or_file)
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t"), True
    return open(path, mode), True


def load_mtx(path_or_file) -> CSR:
    """Read a MatrixMarket file into a `repro_torch.sparse.formats.CSR`."""
    f, owned = _open(path_or_file, "r")
    try:
        header = f.readline()
        if isinstance(header, bytes):
            raise ValueError("open MatrixMarket files in text mode")
        parts = header.strip().split()
        if len(parts) != 5 or parts[0] != _BANNER:
            raise ValueError(f"not a MatrixMarket file: {header!r}")
        _, obj, fmt, field, symmetry = (p.lower() for p in parts)
        if obj != "matrix":
            raise ValueError(f"unsupported object {obj!r}")
        if field == "complex":
            raise ValueError("complex matrices are not supported")
        if symmetry == "hermitian":
            raise ValueError("hermitian matrices are not supported")
        if fmt not in ("coordinate", "array"):
            raise ValueError(f"unsupported format {fmt!r}")
        if symmetry not in ("general", "symmetric", "skew-symmetric"):
            raise ValueError(f"unsupported symmetry {symmetry!r}")

        line = f.readline()
        while line and line.lstrip().startswith("%"):
            line = f.readline()
        dims = line.split()

        if fmt == "array":
            if symmetry != "general":
                raise ValueError("array format only supported as general")
            m, n = int(dims[0]), int(dims[1])
            data = np.loadtxt(f, dtype=np.float64, ndmin=1)
            if data.size != m * n:
                raise ValueError(
                    f"array body has {data.size} entries, expected {m * n}")
            return CSR.from_dense(data.reshape((n, m)).T)  # column-major

        m, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        if nnz == 0:
            return CSR(indptr=np.zeros(m + 1, dtype=np.int64),
                       indices=np.zeros(0, dtype=np.int64),
                       values=np.zeros(0, dtype=np.float64), shape=(m, n))
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)
        if body.shape[0] != nnz:
            raise ValueError(
                f"body has {body.shape[0]} entries, header says {nnz}")
        rows = body[:, 0].astype(np.int64) - 1
        cols = body[:, 1].astype(np.int64) - 1
        if field == "pattern":
            vals = np.ones(rows.size, dtype=np.float64)
        else:
            if body.shape[1] < 3:
                raise ValueError(f"{field!r} entries need a value column")
            vals = body[:, 2]
        if rows.size and ((rows < 0).any() or (rows >= m).any()
                          or (cols < 0).any() or (cols >= n).any()):
            raise ValueError("index out of range (file is 1-based)")

        if symmetry in ("symmetric", "skew-symmetric"):
            off = rows != cols          # mirror strictly-lower entries
            sign = -1.0 if symmetry == "skew-symmetric" else 1.0
            rows, cols, vals = (np.concatenate([rows, cols[off]]),
                                np.concatenate([cols, rows[off]]),
                                np.concatenate([vals, sign * vals[off]]))
        return CSR.from_coo(rows, cols, vals, (m, n),
                            sum_duplicates=False)
    finally:
        if owned:
            f.close()


def save_mtx(path_or_file, a: CSR, comment: str | None = None) -> None:
    """Write ``a`` as ``coordinate real general`` MatrixMarket."""
    f, owned = _open(path_or_file, "w")
    try:
        m, n = a.shape
        f.write(f"{_BANNER} matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{m} {n} {a.nnz}\n")
        rows = np.repeat(np.arange(m, dtype=np.int64), a.row_nnz())
        buf = _io.StringIO()
        for r, c, v in zip(rows, a.indices, a.values):
            buf.write(f"{r + 1} {c + 1} {v:.17g}\n")
        f.write(buf.getvalue())
    finally:
        if owned:
            f.close()
