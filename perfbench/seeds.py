"""Streams of randomness drawn from a run's ``--seed``.

Each input (weights, activations, the right-hand side, the sample of
answers kept for the comparison) has a stream of its own, derived from the
seed and the input's label, so that adding an input never shifts another.
"""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, label: str) -> int:
    """A 63-bit seed for ``label``'s stream; any whole ``seed`` works."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), zlib.crc32(label.encode())])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
