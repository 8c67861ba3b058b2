"""Column tiling of the SpMM kernel, sized for Hopper.

The SpMM kernel (`csrc/dtans_spmv.cu::dtans_spmm_kernel`) keeps one
``(bn, rows)`` accumulator tile of the output in the block's shared memory
and reads x straight from device memory (through L2) in its ``(n, B)``
layout. So, unlike the JAX package's TPU budget, which had to hold the x
columns in VMEM too, only the accumulator tile counts here:
``rows * bn * itemsize`` against a shared-memory budget. ``rows`` is the
lane width rounded up to whole warps, as the block is.

The column tiles are the kernel's ``blockIdx.y``: each tile decodes the
slice again and contracts it against its ``bn`` columns. Tiling splits
only the B axis, so every output column sees exactly the arithmetic of the
untiled kernel: tiled results are bitwise equal to untiled ones at every
``bn``.

H100 facts behind the constants (NVIDIA's Hopper documentation): a block
may use 48 KB of shared memory without opting in, and up to 227 KB
(232,448 bytes) with ``cudaFuncAttributeMaxDynamicSharedMemorySize``; a
warp is 32 threads.
"""

from __future__ import annotations

#: Shared memory an accumulator tile may take by default: the 48 KB a block
#: gets without opting in. It leaves room for four such blocks per SM.
DEFAULT_SMEM_BYTES = 48 * 1024

#: Most shared memory one H100 block can opt in to (227 KB), static and
#: dynamic together.
MAX_SMEM_BYTES = 232448

#: The SpMM kernel's static shared memory: ``warp_tot[MAX_WARPS]`` and
#: ``smax`` in ``csrc/dtans_spmv.cu`` are 132 B, which ptxas lays out in
#: 144 B for sm_90a (``dtans_spmv.static_smem_bytes`` reads it from the
#: built kernel). The accumulator tile gets the rest of `MAX_SMEM_BYTES`.
STATIC_SMEM_BYTES = 144

#: Threads per warp: the block is the lane width rounded up to whole
#: warps, and tile widths snap down to a multiple of this.
WARP = 32

#: Floor tile width: below this the repeated decode per tile dwarfs the
#: contraction. 8 columns of a 1024-row f64 tile still fit the opt-in
#: limit.
MIN_BN = 8


def choose_bn(rows: int, batch: int, itemsize: int) -> int | None:
    """Widest column-tile width ``bn`` whose ``(rows, bn)`` accumulator
    tile fits `DEFAULT_SMEM_BYTES`, or ``None`` when the whole batch fits
    (untiled: one decode per slice for all columns)."""
    if batch <= 0:
        return None
    per_col = -(-int(rows) // WARP) * WARP * int(itemsize)
    if per_col <= 0:
        return None
    bn = int(DEFAULT_SMEM_BYTES // per_col)
    if bn >= batch:
        return None
    if bn >= WARP:
        bn = (bn // WARP) * WARP
    return max(bn, MIN_BN)
