"""A dense projection pruned and served as a compressed `SparseLinear`.

The weight W (d_in x d_out, normal with the configuration's std) is drawn
on the device from the seed and handed to the port as the host array its
entry takes: `SparseLinear.from_dense(auto=True)` prunes it by magnitude,
snaps the survivors to a codebook, lets the autotuner pick the
entropy-coded format at the serving batch, encodes, packs and uploads it.
The window drives `SparseLinear.apply` (x: B x d_in -> B x d_out).

The reference prunes and snaps the same W again (`reference.prune`) and
multiplies in float64. Each compared answer is judged by its gap to the
reference relative to |x| . |W^T| (the sum of the magnitudes of the
products it adds up), which rounding in the configuration's precision keeps
near the unit round-off: ``y_gap`` is the widest such gap over every answer
kept. The control is the reference in TF32 (inputs rounded to 10 mantissa
bits, products summed in float32), the precision below float32 with TF32
off.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.cases import Subject, worst
from perfbench.reference.precision import round_tf32
from perfbench.reference.prune import pruned_quantized
from perfbench.seeds import derive


class Case:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        self.cfg, self.device = cfg, device
        self.d_in, self.d_out = cfg["d_model"], cfg["padded_vocab_size"]
        self.dtype = getattr(torch, cfg["dtype"])
        g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
        w = torch.randn(self.d_in, self.d_out, generator=g, device=device,
                        dtype=self.dtype).mul_(cfg["weight_std"])
        self.w = w.cpu().numpy()          # what both sides start from
        self.nnz = None                   # known once the reference prunes

    def program(self) -> Subject:
        from repro_torch.autotune import DecisionCache
        from repro_torch.serving.sparse_linear import SparseLinear
        layer = SparseLinear.from_dense(
            self.w, sparsity=self.cfg["sparsity"],
            value_bits=self.cfg["value_bits"], auto=True,
            autotune_batch=self.cfg["autotune_batch"],
            autotune_cache=DecisionCache(path=None), device=self.device)
        d = layer.decision
        return Subject(layer.apply, self.dtype, {
            "decision": f"{d.fmt} {dict(d.knobs)}",
            "compressed_bytes": layer.mat.nbytes})

    def _reference(self) -> np.ndarray:
        """W^T pruned and snapped, (d_out, d_in), by the reference."""
        wq = pruned_quantized(np.ascontiguousarray(self.w.T),
                              self.cfg["sparsity"], self.cfg["value_bits"])
        self.nnz = int(np.count_nonzero(wq))
        return wq

    def control(self) -> Subject:
        wt = round_tf32(torch.from_numpy(self._reference()).to(self.device)).T

        def apply(x):
            return round_tf32(x) @ wt
        return Subject(apply, self.dtype, {"control": "reference in TF32"})

    def compare(self, produced: dict) -> dict:
        """``produced``: ``x`` (batches, B, d_in) and ``y``, batch index ->
        the kept answer (B, d_out)."""
        wq = torch.from_numpy(self._reference()).to(self.device,
                                                     torch.float64)
        aw = wq.abs()
        gaps = []
        for b, y in produced["y"].items():
            x = produced["x"][b].to(torch.float64)
            diff = (y.to(torch.float64) - x @ wq.T).abs()
            scale = x.abs() @ aw.T
            rel = torch.where(scale > 0, diff / scale.clamp_min(1e-300),
                              torch.where(diff > 0, float("inf"), 0.0))
            gaps.append(float(rel.max()))
        return {"y_gap": worst(gaps)}


def make(cfg: dict, seed: int, device) -> Case:
    return Case(cfg, seed, torch.device(device))
