"""HPCG's 27-point operator, encoded by the port and solved by CG.

The benchmark builds the operator (`reference.hpcg`), draws x_true ~
N(0, 1) on the device from the seed and forms b = A x_true with the plain
CSR product. The port gets the CSR arrays through its public entries
(`encode_matrix`, `pack_matrix`, `to_device`) and the window drives
``ops.spmv`` (``v -> A v``), inside the CG sets of the traffic.

The reference runs the plain CG (`reference.sparse`) in float64 for the
same iterations from the same b. Compared: ``rnorm_gap``, the widest
relative gap between a set's residual norm and the reference's, over every
set of the window; ``x_gap``, the widest gap between the last set's x and
the reference's, over the largest |x|. The control is the reference in
float32, the precision below the configuration's float64.
"""

from __future__ import annotations

import torch

from perfbench.cases import Subject, worst
from perfbench.reference.hpcg import stencil27
from perfbench.reference.sparse import cg, csr_operator
from perfbench.seeds import derive


class Case:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        self.cfg, self.device = cfg, device
        self.dtype = getattr(torch, cfg["dtype"])
        self.indptr, self.indices, self.values, self.n = stencil27(
            cfg["nx"], cfg["ny"], cfg["nz"], dtype=cfg["dtype"],
            diagonal=cfg["diagonal"], off_diagonal=cfg["off_diagonal"])
        self.nnz = int(self.values.size)
        self.d_in = self.d_out = self.n
        g = torch.Generator(device=device).manual_seed(derive(seed, "x_true"))
        x_true = torch.randn(self.n, generator=g, device=device,
                             dtype=self.dtype)
        self.b = self._operator(self.dtype)(x_true)

    def _operator(self, dtype: torch.dtype):
        return csr_operator(self.indptr, self.indices, self.values, self.n,
                            dtype, self.device)

    def program(self) -> Subject:
        from repro_torch.core.csr_dtans import encode_matrix
        from repro_torch.kernels import ops
        from repro_torch.kernels.pack import pack_matrix, to_device
        from repro_torch.sparse.formats import CSR
        mat = encode_matrix(CSR(self.indptr, self.indices, self.values,
                                (self.n, self.n)),
                            lane_width=self.cfg["lane_width"])
        pm = pack_matrix(mat)
        to_device(pm, self.device)
        dev = self.device
        return Subject(lambda v: ops.spmv(pm, v, device=dev), self.dtype,
                       {"format": f"dtans lane_width={mat.lane_width}",
                        "compressed_bytes": mat.nbytes})

    def control(self) -> Subject:
        return Subject(self._operator(torch.float32), torch.float32,
                       {"control": "reference in float32"})

    def compare(self, produced: dict) -> dict:
        """``produced``: ``rnorms`` (one a set), ``x`` (the last set's) and
        ``iterations``."""
        x_ref, rn_ref = cg(self._operator(torch.float64),
                           self.b.to(torch.float64), produced["iterations"])
        x = produced["x"].to(torch.float64)
        return {
            "rnorm_gap": worst(abs(r - rn_ref) / rn_ref
                               for r in produced["rnorms"]),
            "x_gap": worst([(x - x_ref).abs().max() / x_ref.abs().max()])}


def make(cfg: dict, seed: int, device) -> Case:
    return Case(cfg, seed, torch.device(device))
