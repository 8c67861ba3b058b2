"""Plain torch oracles for the dtANS kernels.

`spmv_ref` / `decode_ref` run the shared lock-step decoder
(`repro_torch.kernels.common`) over all slices at once. They are held
against the numpy gold path (`repro_torch.core.csr_dtans.spmv_gold`) and
against the JAX package's own oracles in the tests.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import bits_to_value, iter_segments
from repro_torch.kernels.pack import PackedMatrix, to_device


def spmv_ref(pm: PackedMatrix, x, y=None, *, device="cpu") -> torch.Tensor:
    """Oracle y = A x + y with on-the-fly dtANS decode."""
    dm = to_device(pm, device)
    m, n = pm.shape
    x = torch.as_tensor(x, dtype=dm.dtype, device=dm.device)
    acc = torch.zeros((dm.n_slices, pm.lane_width), dtype=dm.dtype,
                      device=dm.device)
    for _, cols, vbits, valid in iter_segments(dm):
        vals = bits_to_value(vbits, dm.dtype)
        xg = x[cols.clamp(0, n - 1)]
        acc = acc + torch.where(valid, vals * xg, 0).sum(dim=0)
    out = acc.reshape(-1)[:m]
    if y is not None:
        out = out + torch.as_tensor(y, dtype=dm.dtype, device=dm.device)
    return out


def decode_ref(pm: PackedMatrix, *, device="cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Oracle decompression: (cols, vals) as (S, L, max_nseg * l/2) padded
    tensors (cols == -1 marks padding, vals == 0 there)."""
    dm = to_device(pm, device)
    cols_out, vals_out = [], []
    for _, cols, vbits, valid in iter_segments(dm):
        vals = bits_to_value(vbits, dm.dtype)
        cols_out.append(torch.where(valid, cols, -1).to(torch.int32))
        vals_out.append(torch.where(valid, vals, 0))
    # (max_nseg, h, S, L) -> (S, L, max_nseg * h), segment-major per lane
    cols = torch.stack(cols_out).permute(2, 3, 0, 1)
    vals = torch.stack(vals_out).permute(2, 3, 0, 1)
    S, L = cols.shape[:2]
    return (cols.reshape(S, L, -1).contiguous(),
            vals.reshape(S, L, -1).contiguous())
