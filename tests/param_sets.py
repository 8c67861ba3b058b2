"""The dtANS parameter sets the port's kernels are tested and smoke-run
at, ``name -> (w_bits, k_bits, l, o, f, m_bits)``, in one place for
``tests/test_torch_params.py`` (CPU, against the JAX package),
``tests/test_torch_gpu.py`` (the kernels on the card) and
``chip_smoke.py`` phase 4o. Imports nothing.

`PAPER`, the reference's `TOY`, and sets that each move the kernels'
constants away from PAPER: K = 2^8 and 2^16 (the latter's 1,572,864
bytes of tables read from global memory), 16- and 8-bit stream words
(limb shifts), M = 2^4 and 2^16 (fold groups of 8 and of 2 digits; a
16-byte slot at 16 bits), l = 48 (a 64-bit escape mask and pattern),
o = 1 and o = 2, f = o; and L66, the degenerate corner of the domain:
2-slot tables, 22-bit words and 66 positions a segment (33 entries: a
64-bit entry mask; escape mask and pattern past 64 bits, the pattern
handed to the kernels as an array of words).
"""

PARAM_SETS = {
    "PAPER": (32, 12, 8, 3, 2, 8),
    "TOY": (2, 3, 2, 3, 2, 2),
    "K8": (32, 8, 4, 1, 1, 8),
    "K16": (32, 16, 4, 2, 1, 8),
    "W16": (16, 12, 4, 3, 2, 8),
    "W8": (8, 12, 2, 3, 2, 8),
    "M4": (32, 12, 8, 3, 1, 4),
    "L48": (32, 2, 48, 3, 3, 2),
    "M16": (32, 16, 6, 3, 3, 16),
    "L66": (22, 1, 66, 3, 3, 1),
}
