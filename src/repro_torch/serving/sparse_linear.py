"""SparseLinear: a dense projection replaced by a pruned, entropy-coded
weight matrix decoded on the fly (the paper's LLM-inference motivation,
Section I, made concrete).

Pipeline: dense W (d_in, d_out) -> magnitude prune -> codebook-quantize
surviving values (8-bit centroids make the value distribution low-entropy,
which is what dtANS compresses; raw float32 mantissas would all escape) ->
CSR-dtANS encode of W^T (so y = W^T-rows . x = SpMV per output neuron).
The encode runs once on the host (numpy); the pack is moved to the device
once.

`apply` contracts a batch of activations against the matrix through the
fused multi-RHS decode kernel (`ops.spmm`): one entropy decode per call
(per column tile), amortized over every request in the batch.

``from_dense(auto=True)`` lets the autotuner pick the entropy-coded
family and its knobs per matrix. A layer whose ``mat`` is a `BCSRdtANS`
(a ``bcsr_dtans`` decision, or structured-pruned weights encoded by
`core.bcsr_dtans.encode_bcsr_matrix` and built with the dataclass
constructor) serves the same way: its pack has ``shared_cols`` set, so
`ops.spmm` runs the fused shared-column contraction.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.csr_dtans import CSRdtANS, decode_matrix, encode_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.pack import PackedMatrix, check_device, to_device
from repro_torch.sparse.formats import best_baseline_nbytes
from repro_torch.sparse.prune import codebook_quantize, magnitude_prune


@dataclasses.dataclass
class SparseLinear:
    mat: CSRdtANS            # encodes W^T: (d_out rows, d_in cols)
    packed: PackedMatrix
    d_in: int
    d_out: int
    dense_bytes: int
    baseline_bytes: int      # best of CSR/COO/SELL on the pruned matrix
    decision: object = None  # autotune Decision when built with auto=True
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"))

    @classmethod
    def from_dense(cls, w, sparsity: float = 0.8, value_bits: int = 8,
                   lane_width: int = 128, shared_table: bool = True,
                   auto: bool = False, autotune_budget: int = 0,
                   autotune_batch: int = 1, autotune_cache=None,
                   autotune_measure: bool = False, autotune_machine=None,
                   mesh=None, n_shards: int | None = None,
                   device="cuda") -> "SparseLinear":
        """Compress a dense projection ``w`` (d_in, d_out) for
        decode-on-the-fly serving on ``device``.

        The source dtype is preserved end to end: a float64 projection
        prunes, quantizes, encodes and decodes in float64 (non-float inputs
        become float32 — the format codes float bit patterns).

        With ``auto=True`` the ``lane_width`` / ``shared_table`` knobs are
        ignored and chosen per matrix by `repro_torch.autotune`:
        `choose_dtans_config` fingerprints the pruned weight and picks the
        modeled-fastest configuration among every ``decodes=True`` family
        of `repro_torch.sparse.registry` (CSR-dtANS, RGCSR-dtANS,
        BCSR-dtANS, ...), and the winner's `FormatSpec.encode` builds the
        artifact. Every such family is a `CSRdtANS`, so `apply` serves any
        winner (a BCSR-dtANS one through the fused shared-column
        kernels). ``autotune_budget`` > 0 encodes the top candidates for
        exact sizes; ``autotune_measure=True`` further times those
        candidates' kernels on ``device`` and picks the measured-fastest
        (`repro_torch.autotune.measure`; the selection's artifact of the
        winner is served, not encoded again); ``autotune_batch`` prices
        (and times) the selection for a ``B``-RHS serving batch;
        ``autotune_machine`` substitutes a calibrated `MachineModel` for
        the default `repro_torch.autotune.H100` constants;
        ``autotune_cache`` overrides the default persistent cache (pass
        ``DecisionCache(path=None)`` for memory-only).

        Not ported yet, and refused with `NotImplementedError`: ``mesh=``
        and ``n_shards > 1`` (sharding, ROADMAP.md A6)."""
        if mesh is not None or (n_shards is not None and int(n_shards) != 1):
            raise NotImplementedError(
                "sharded SparseLinear (mesh= / n_shards > 1) is not ported "
                "yet (ROADMAP.md A6)")
        dev = check_device(device)           # before a long host encode
        if torch.is_tensor(w):
            w = w.detach().cpu().numpy()
        w_arr = np.asarray(w)
        if w_arr.dtype not in (np.float32, np.float64):
            w_arr = w_arr.astype(np.float32)
        d_in, d_out = w_arr.shape
        pruned = magnitude_prune(w_arr.T, sparsity)
        pruned = codebook_quantize(pruned, bits=value_bits)
        decision = None
        if auto:
            from repro_torch.autotune import H100, choose_dtans_config
            from repro_torch.sparse.registry import get_format
            arts: dict = {}
            decision = choose_dtans_config(
                pruned, warm=True, budget=autotune_budget,
                batch=autotune_batch, measure=autotune_measure,
                machine=autotune_machine
                if autotune_machine is not None else H100,
                cache=autotune_cache, device=dev, artifacts=arts)
            spec = get_format(decision.fmt)
            knobs = decision.knobs_dict()
            # The selection's own encode of the winner, where it made
            # one: the encoder is deterministic, so it is byte-equal to
            # a fresh `spec.encode`.
            mat = arts.get(spec.artifact_key(knobs))
            if not isinstance(mat, CSRdtANS):
                mat = spec.encode(pruned, **knobs)
        else:
            mat = encode_matrix(pruned, lane_width=lane_width,
                                shared_table=shared_table)
        _, bb = best_baseline_nbytes(pruned)
        sl = cls(mat=mat, packed=ops.get_packed(mat), d_in=d_in,
                 d_out=d_out, dense_bytes=w_arr.size * w_arr.dtype.itemsize,
                 baseline_bytes=bb, decision=decision, device=dev)
        to_device(sl.packed, dev)
        return sl

    @property
    def compressed_bytes(self) -> int:
        return self.mat.nbytes

    @property
    def compression_vs_dense(self) -> float:
        return self.dense_bytes / self.mat.nbytes

    @property
    def compression_vs_best_sparse(self) -> float:
        return self.baseline_bytes / self.mat.nbytes

    def apply(self, x, *, bn=None, pipeline: bool = False,
              metrics: obs.MetricsRegistry | None = None) -> torch.Tensor:
        """x: (..., d_in) -> (..., d_out), on the layer's device, in x's
        dtype.

        Every batch size routes through the fused SpMM kernel
        (`ops.spmm`): the matrix decodes once per call (per column tile)
        and contracts against all B flattened rows of ``x`` in-kernel
        (B == 1 runs the single-vector kernel and is bitwise equal to
        `ops.spmv`). Accumulation happens in the packed matrix's dtype
        (`ops.out_dtype`). Large batches are column-tiled automatically
        (`tiling.dtans_bn`); ``bn`` pins the tile width, cut to what a
        block's shared memory holds (`tiling.dtans_widest_bn`). ``pipeline``
        is the reference's decode-ahead schedule, which the kernels always
        run: either value gives the same bits.

        ``metrics``: registry the ``serving.*`` instruments land in (the
        process default when omitted)."""
        x = torch.as_tensor(x)
        dt = ops.out_dtype(self.packed)
        lead = x.shape[:-1]
        xb = x.to(device=self.device, dtype=dt).reshape(-1, self.d_in)
        reg = metrics if metrics is not None else obs.default_registry()
        reg.counter("serving.sparse_apply_calls").add(1)
        reg.histogram("serving.apply_batch").observe(xb.shape[0])
        with obs.span("serving.sparse_apply", batch=int(xb.shape[0]),
                      d_in=self.d_in, d_out=self.d_out):
            y = ops.spmm(self.packed, xb.T, device=self.device, bn=bn,
                         pipeline=pipeline)                 # (d_out, B)
        return y.T.reshape(*lead, self.d_out).to(x.dtype)

    @functools.cached_property
    def dense_weight(self) -> torch.Tensor:
        """The decoded matrix W^T (d_out, d_in) on the layer's device,
        decoded once by the numpy gold path."""
        w = decode_matrix(self.mat).to_dense()
        return torch.from_numpy(w).to(self.device)

    def apply_dense_reference(self, x) -> torch.Tensor:
        """Oracle: the decoded dense matrix times x (tests and the chip
        smoke run). Contracts in the matrix dtype, like `apply`."""
        x = torch.as_tensor(x)
        w = self.dense_weight
        return (x.to(device=self.device, dtype=w.dtype) @ w.T).to(x.dtype)
