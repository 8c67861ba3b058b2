"""Hand-made SELL and RGCSR packs that no matrix packs to.

The SELL / RGCSR SpMV (`csrc/padded_rows.cuh::spmv_lanes_kernel`) runs four
lanes a row and stops each row at its last real entry; the SpMM stops each
32-row chunk at its longest row. These packs hold what the packers never
make: -1 holes before a SELL row's last real entry, nonzero RGCSR deltas and
values past each row's count, and int32 running sums past 2^31. Their rows
hold `HAND_LENGTHS` entries: 0, 1, T - 1, T, T + 1 and 2T + 1 at T = 4
lanes a row, then 2 and the longest row, Wg = 12.

Used by `tests/test_torch_padded_spmv.py` (against the JAX package's
oracles), `tests/test_torch_gpu.py` and `chip_smoke.py` phase 3 (the
kernels on the card). Imports numpy and the port only.
"""

import numpy as np

from repro_torch.kernels import rgcsr_spmv as RG
from repro_torch.kernels import sell_spmv as SE

HAND_LENGTHS = (0, 1, 3, 4, 5, 9, 2, 12)


def hand_made_sell(dtype, n=13, seed=60) -> SE.PackedSELL:
    """A `PackedSELL` that no CSR packs to: 3 slices of 16 rows of
    `HAND_LENGTHS` entries, -1 holes before the last real entry of every
    third row, nonzero values at every -1 (rows of padding only
    included), and an index past n (clipped to n - 1)."""
    rng = np.random.default_rng(seed)
    S, L, wg = 3, 16, max(HAND_LENGTHS)
    idx = np.full((S * L, wg), -1, np.int32)
    val = rng.standard_normal((S * L, wg)).astype(dtype)
    for r in range(S * L):
        k = HAND_LENGTHS[r % len(HAND_LENGTHS)]
        idx[r, :k] = rng.integers(0, n, k)
        if k > 2 and r % 3 == 0:
            idx[r, rng.integers(0, k - 1, 2)] = -1
    idx[5, 0] = n + 5
    return SE.PackedSELL(indices=idx.reshape(S, L, wg),
                         values=val.reshape(S, L, wg), shape=(S * L, n),
                         lane_width=L)


def hand_made_rgcsr(dtype, n=13, seed=61, wrap=False) -> RG.PackedRGCSR:
    """A `PackedRGCSR` that no RGCSR packs to: 12 groups of 4 rows of
    `HAND_LENGTHS` entries, nonzero deltas and values past every row's
    count; with ``wrap``, rows 3 and 4 run their int32 sums past 2^31
    within the count (clipped to 0 and n - 1, then back in range)."""
    rng = np.random.default_rng(seed)
    S, G, wg = 12, 4, max(HAND_LENGTHS)
    deltas = rng.integers(-3, 4, (S * G, wg)).astype(np.int32)
    deltas[:, 0] = rng.integers(0, n, S * G)
    nnz = np.array([HAND_LENGTHS[r % len(HAND_LENGTHS)]
                    for r in range(S * G)], np.int32)
    if wrap:
        big = 2**31 - 1
        deltas[3, :4] = [5, big, 10, big]          # 5, < 0, < 0, 13
        deltas[4, :4] = [3, big - 9, 20, big]      # 3, > n, < 0, 12
    return RG.PackedRGCSR(
        deltas=deltas.reshape(S, G, wg),
        values=rng.standard_normal((S, G, wg)).astype(dtype),
        nnz=nnz.reshape(S, G), shape=(S * G, n), group_size=G)


# kind -> pack builder of (dtype, n); the format is the kind's first word.
HAND_MADE = {"sell": lambda dt, n: hand_made_sell(dt, n),
             "rgcsr": lambda dt, n: hand_made_rgcsr(dt, n),
             "rgcsr-wraps": lambda dt, n: hand_made_rgcsr(dt, n, 62, True)}
