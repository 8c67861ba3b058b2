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

``from_dense(n_shards=k)`` or ``from_dense(mesh=)`` row-partitions the
weight into a shard plan along the format's decode-slice boundaries, and
`apply` runs it through `repro_torch.kernels.shard_ops`: a per-shard loop
on the layer's device, or, under a mesh, each rank decoding only its own
shard and an all-reduce of the rows. Either gives bitwise the unsharded
layer's result. Such a layer encodes the whole matrix (``mat``) only when
`whole` is first called (by ``compressed_bytes`` or the dense reference):
`apply` never needs it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.csr_dtans import CSRdtANS, decode_matrix
from repro_torch.kernels import ops, shard_ops
from repro_torch.kernels.pack import PackedMatrix, check_device, to_device
from repro_torch.sparse.formats import best_baseline_nbytes
from repro_torch.sparse.prune import codebook_quantize, magnitude_prune
from repro_torch.sparse.registry import get_format


@dataclasses.dataclass
class SparseLinear:
    mat: CSRdtANS | None     # encodes W^T: (d_out rows, d_in cols); None
                             # on a sharded layer until `whole` encodes it
    packed: PackedMatrix | None
    d_in: int
    d_out: int
    dense_bytes: int
    baseline_bytes: int      # best of CSR/COO/SELL on the pruned matrix
    decision: object = None  # autotune Decision when built with auto=True
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"))
    mesh: object = None      # DeviceMesh the layer serves from (or None)
    plan: object = None      # sparse.shard.ShardPlan of a sharded layer
    _encode_whole: object = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

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

        ``mesh`` (a `torch.distributed.device_mesh.DeviceMesh` on
        ``device``'s type, every rank of it calling this) builds the layer
        for serving from several cards: the pruned weight is
        row-partitioned into as many shards as the mesh's ``"model"`` dim
        holds, along the winning format's decode-slice boundaries
        (`FormatSpec.shard`), each rank uploads only its own shard, and
        `apply` runs the all-reduce path of `repro_torch.kernels.shard_ops`.
        ``n_shards`` pins the shard count (without a mesh: the per-shard
        loop on ``device``); with a mesh it must equal the ``"model"`` dim,
        and a mesh on another device type than ``device`` raises too, both
        before any encode. A sharded layer encodes only its shards; the
        whole matrix waits for `whole`. With ``auto=True`` the selection is priced at
        the shard count it will serve on; at more than one shard it is the
        modeled sharded cost, never measured (the timing harness times one
        device)."""
        dev = check_device(device)           # before a long host encode
        k = ops.resolve_shards(mesh, n_shards)
        if mesh is not None:
            shard_ops.validate_mesh(k, mesh, dev)
        if torch.is_tensor(w):
            w = w.detach().cpu().numpy()
        w_arr = np.asarray(w)
        if w_arr.dtype not in (np.float32, np.float64):
            w_arr = w_arr.astype(np.float32)
        d_in, d_out = w_arr.shape
        pruned = magnitude_prune(w_arr.T, sparsity)
        pruned = codebook_quantize(pruned, bits=value_bits)
        decision, mat = None, None
        if auto:
            from repro_torch.autotune import H100, choose_dtans_config
            arts: dict = {}
            decision = choose_dtans_config(
                pruned, warm=True, budget=autotune_budget,
                batch=autotune_batch, n_shards=k,
                measure=autotune_measure if k == 1 else False,
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
                mat = None
        else:
            spec = get_format("dtans")
            knobs = {"lane_width": lane_width, "shared_table": shared_table}
        plan = spec.shard(pruned, k, **knobs) if k > 1 else None
        if mat is None and plan is None:
            mat = spec.encode(pruned, **knobs)
        _, bb = best_baseline_nbytes(pruned)
        sl = cls(mat=mat, packed=None if mat is None else ops.get_packed(mat),
                 d_in=d_in, d_out=d_out,
                 dense_bytes=w_arr.size * w_arr.dtype.itemsize,
                 baseline_bytes=bb, decision=decision, mesh=mesh, plan=plan)
        if plan is not None:
            sl._encode_whole = functools.partial(spec.encode, pruned, **knobs)
        return sl.to(dev)

    def to(self, device) -> "SparseLinear":
        """Serve from ``device``: the pack (or, on a sharded layer, the
        shards this process runs) moved there once and cached, and the
        layer's ``device`` set. Returns the layer. `from_dense` ends here;
        a layer built on the host (``device="cpu"``) moves to a card the
        same way. A CUDA request without a card raises, as does a mesh on
        another device type."""
        dev = check_device(device)
        if self.plan is None:
            to_device(self.packed, dev)
        else:
            if self.mesh is not None:
                shard_ops.validate_mesh(self.n_shards, self.mesh, dev)
            shard_ops.upload(self.plan, dev, mesh=self.mesh)
        self.device = dev
        return self

    @property
    def n_shards(self) -> int:
        """Row shards of the weight (1: the whole matrix on one card)."""
        return 1 if self.plan is None else self.plan.n_shards

    def whole(self) -> CSRdtANS:
        """``mat``, the whole matrix in one encode; a sharded layer from
        `from_dense` encodes it here on the first call (on the host, as
        long as the shards' encode) and keeps it."""
        if self.mat is None:
            self.mat = self._encode_whole()
            self.packed = ops.get_packed(self.mat)
        return self.mat

    @property
    def compressed_bytes(self) -> int:
        return self.whole().nbytes

    @property
    def compression_vs_dense(self) -> float:
        return self.dense_bytes / self.compressed_bytes

    @property
    def compression_vs_best_sparse(self) -> float:
        return self.baseline_bytes / self.compressed_bytes

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

        A sharded layer runs its plan through `shard_ops.shard_spmm` (the
        loop, or under the layer's mesh the all-reduce, which every rank
        calls with the same batch shape); the results are bitwise the
        unsharded layer's.

        ``metrics``: registry the ``serving.*`` instruments land in (the
        process default when omitted)."""
        x = torch.as_tensor(x)
        dt = (ops.out_dtype(self.packed) if self.plan is None
              else shard_ops.plan_dtype(self.plan))
        lead = x.shape[:-1]
        xb = x.to(device=self.device, dtype=dt).reshape(-1, self.d_in)
        reg = metrics if metrics is not None else obs.default_registry()
        reg.counter("serving.sparse_apply_calls").add(1)
        reg.histogram("serving.apply_batch").observe(xb.shape[0])
        with obs.span("serving.sparse_apply", batch=int(xb.shape[0]),
                      d_in=self.d_in, d_out=self.d_out,
                      n_shards=int(self.n_shards)):
            if self.plan is not None:
                y = shard_ops.shard_spmm(self.plan, xb.T, mesh=self.mesh,
                                         device=self.device, bn=bn,
                                         pipeline=pipeline)
            else:
                y = ops.spmm(self.packed, xb.T, device=self.device, bn=bn,
                             pipeline=pipeline)             # (d_out, B)
        return y.T.reshape(*lead, self.d_out).to(x.dtype)

    @functools.cached_property
    def dense_weight(self) -> torch.Tensor:
        """The decoded matrix W^T (d_out, d_in) on the layer's device,
        decoded once by the numpy gold path."""
        w = decode_matrix(self.whole()).to_dense()
        return torch.from_numpy(w).to(self.device)

    def apply_dense_reference(self, x) -> torch.Tensor:
        """Oracle: the decoded dense matrix times x (tests and the chip
        smoke run). Contracts in the matrix dtype, like `apply`."""
        x = torch.as_tensor(x)
        w = self.dense_weight
        return (x.to(device=self.device, dtype=w.dtype) @ w.T).to(x.dtype)
