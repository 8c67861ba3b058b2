"""Operations and bytes of the work the cells do, from their shapes.

A multiply of an m x n matrix with nnz nonzeros by B columns does
2 * nnz * B operations and must move the matrix once (the bytes its pass
reads, as the port records them), x once (n * B values) and y once
(m * B values). An unpreconditioned CG set of ``iterations`` steps from
x = 0 does, as HPCG counts them: the first residual (one multiply and n
subtractions) and its dot (2n), then each step one multiply, two dots (4n)
and three vector updates (6n).
"""

from __future__ import annotations


def multiply_flops(nnz: int, batch: int = 1) -> float:
    return 2.0 * nnz * batch


def pass_bytes(matrix_bytes: float, rows: int, cols: int, batch: int,
               itemsize: int) -> float:
    return float(matrix_bytes) + (rows + cols) * batch * itemsize


def cg_set_flops(nnz: int, n: int, iterations: int) -> float:
    return ((iterations + 1) * multiply_flops(nnz) + 3.0 * n
            + iterations * 10.0 * n)
