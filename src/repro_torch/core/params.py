"""dtANS parameter set (Section IV of the paper).

The paper's production choice for CSR-dtANS:
  W = 2^32  (stream word = one GPU 32-bit register)
  K = 2^12  (coding-table slots; table fits in shared memory)
  l = 8     (symbols per segment = 4 nonzeros x (delta, value))
  o = 3     (words consumed per segment, K^l == W^o)
  M = 2^8   (multiplicity cap, bounds per-segment radix growth)
  f = 2     (conditional loads per segment, M^l == W^f)

Constraints enforced (paper, Section IV-D):
  K^l >= W^o          (unpack surjective: every slot combination reachable)
  M^l <= W^f <= W^o   (all returned digits absorbable by f extractions)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DtansParams:
    w_bits: int = 32  # log2(W)
    k_bits: int = 12  # log2(K)
    l: int = 8        # symbols per segment
    o: int = 3        # words per segment
    f: int = 2        # conditional loads per segment
    m_bits: int = 8   # log2(M)

    @property
    def W(self) -> int:
        return 1 << self.w_bits

    @property
    def K(self) -> int:
        return 1 << self.k_bits

    @property
    def M(self) -> int:
        return 1 << self.m_bits

    def __post_init__(self) -> None:
        if not (0 < self.f <= self.o):
            raise ValueError(f"need 0 < f <= o, got f={self.f}, o={self.o}")
        if self.K ** self.l < self.W ** self.o:
            raise ValueError(
                f"unpack not surjective: K^l = {self.K}^{self.l} < W^o = "
                f"{self.W}^{self.o}")
        if self.M ** self.l > self.W ** self.f:
            raise ValueError(
                f"digit overflow possible: M^l = {self.M}^{self.l} > W^f = "
                f"{self.W}^{self.f}")
        if self.m_bits > self.k_bits:
            raise ValueError("M cannot exceed K")

    @property
    def exact_unpack(self) -> bool:
        """True iff pack/unpack is a bijection (no code-space waste)."""
        return self.K ** self.l == self.W ** self.o


# Paper production parameters (CSR-dtANS, Section IV-D).
PAPER = DtansParams(w_bits=32, k_bits=12, l=8, o=3, f=2, m_bits=8)

# Tiny parameters from the worked example in Section IV-D (word = 2 bits,
# K = 8, M = 4, l = 2, o = 3, f = 2). Used in unit tests.
TOY = DtansParams(w_bits=2, k_bits=3, l=2, o=3, f=2, m_bits=2)
