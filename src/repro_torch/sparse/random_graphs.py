"""Random graph adjacency generators (paper Fig. 4): Erdős–Rényi,
Watts–Strogatz, Barabási–Albert. Used to reproduce the delta-encoding
entropy-reduction experiment and to generate benchmark matrices."""

from __future__ import annotations

import numpy as np

from repro_torch.sparse.formats import CSR


def erdos_renyi(n: int, avg_degree: float, rng: np.random.Generator) -> CSR:
    """G(n, p) with p = avg_degree / n; directed adjacency, unit values."""
    p = min(1.0, avg_degree / n)
    # sample via geometric gaps over the flattened index space (memory-safe)
    total = n * n
    est = int(total * p * 1.2 + 100)
    gaps = rng.geometric(p, size=est)
    pos = np.cumsum(gaps) - 1
    pos = pos[pos < total]
    while pos.size and (pos[-1] < total - 1):
        extra = rng.geometric(p, size=est // 4 + 16)
        more = pos[-1] + np.cumsum(extra)
        pos = np.concatenate([pos, more[more < total]])
        if more.size and more[-1] >= total:
            break
    rows, cols = pos // n, pos % n
    vals = np.ones(rows.size, dtype=np.float64)
    return CSR.from_coo(rows, cols, vals, (n, n))


def watts_strogatz(n: int, k: int, beta: float,
                   rng: np.random.Generator) -> CSR:
    """Ring lattice with k neighbors per side, rewired with prob beta."""
    rows = np.repeat(np.arange(n, dtype=np.int64), 2 * k)
    offs = np.concatenate([np.arange(1, k + 1), -np.arange(1, k + 1)])
    cols = (rows.reshape(n, 2 * k) + offs[None, :]).ravel() % n
    rewire = rng.random(rows.size) < beta
    cols[rewire] = rng.integers(0, n, size=int(rewire.sum()))
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = np.ones(rows.size, dtype=np.float64)
    return CSR.from_coo(rows, cols, vals, (n, n))


def barabasi_albert(n: int, m: int, rng: np.random.Generator) -> CSR:
    """Preferential attachment with m edges per new node (small-world)."""
    targets = list(range(m))
    repeated: list[int] = []
    rows, cols = [], []
    for v in range(m, n):
        for t in targets:
            rows.append(v)
            cols.append(t)
        repeated.extend(targets)
        repeated.extend([v] * m)
        # next targets: preferential sample from the degree-weighted list
        targets = [repeated[i] for i in
                   rng.integers(0, len(repeated), size=m)]
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.ones(rows.size, dtype=np.float64)
    return CSR.from_coo(rows, cols, vals, (n, n))


def stencil_2d(side: int, dtype=np.float64) -> CSR:
    """5-point 2-D Laplacian stencil — the classic scientific-computing
    matrix family where delta-encoding shines (paper Section IV-A)."""
    n = side * side
    idx = np.arange(n, dtype=np.int64)
    r, c = idx // side, idx % side
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0, dtype=dtype)]
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ok = (0 <= r + dr) & (r + dr < side) & (0 <= c + dc) & (c + dc < side)
        rows.append(idx[ok])
        cols.append(((r + dr) * side + (c + dc))[ok])
        vals.append(np.full(int(ok.sum()), -1.0, dtype=dtype))
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n, n))


def banded(n: int, bands: int, dtype=np.float64,
           rng: np.random.Generator | None = None) -> CSR:
    """Banded matrix with ``bands`` diagonals and few distinct values."""
    rng = rng or np.random.default_rng(0)
    offs = np.unique(np.concatenate([[0], rng.integers(-8, 9, size=bands)]))
    rows, cols, vals = [], [], []
    palette = rng.standard_normal(4).astype(dtype)
    for j, off in enumerate(offs):
        idx = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        rows.append(idx)
        cols.append(idx + off)
        vals.append(np.full(idx.size, palette[j % palette.size], dtype=dtype))
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n, n))


def block_sparse(n_block_rows: int, n_block_cols: int,
                 block: tuple = (4, 4), density: float = 0.05,
                 rng: np.random.Generator | None = None,
                 dtype=np.float64) -> CSR:
    """Block-structured sparsity: a uniform random ``density`` fraction
    of ``r x c`` tiles is fully dense (random values), the rest empty —
    the FEM / multi-DOF-mesh / structured-pruning pattern blocked
    formats exist for (every stored tile is 100% filled, so BCSR pays
    zero fill-in)."""
    r, c = block
    rng = rng or np.random.default_rng(0)
    mask = rng.random((n_block_rows, n_block_cols)) < density
    bi, bj = np.nonzero(mask)
    nb = bi.size
    dr = np.arange(r, dtype=np.int64)
    dc = np.arange(c, dtype=np.int64)
    rows = (bi[:, None] * r + dr[None, :]).repeat(c, axis=1).reshape(-1)
    cols = np.tile((bj[:, None] * c + dc[None, :]), (1, r)).reshape(-1)
    vals = rng.standard_normal(nb * r * c).astype(dtype)
    return CSR.from_coo(rows, cols, vals,
                        (n_block_rows * r, n_block_cols * c))
