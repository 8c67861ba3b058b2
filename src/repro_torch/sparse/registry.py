"""FormatSpec registry: one object per sparse-format family, one seam
for every layer that dispatches on a format (the port of the JAX
package's ``repro.sparse.registry``; knobs, sizes, cost terms and config
names are the reference's, the runners are torch and the port's CUDA
kernels).

Every consumer iterates the registry:

* ``knob_grid`` / ``candidates`` — the configuration sweep the
  autotuner and the exhaustive oracle both enumerate (a single source,
  so selector and oracle can never disagree about the candidate set);
* ``nbytes_exact`` / ``nbytes_estimate`` / ``nbytes_constructed`` —
  fingerprint-exact, fingerprint-estimated and constructed-truth byte
  counts (`select(budget=k)` refinement and the oracle use the last);
* ``cost_terms`` — the lock-step / row-sequential / decode work split
  the roofline model and `measure.calibrate`'s design matrix charge;
* ``pack`` / ``upload`` / ``runner`` / ``spmv_fn`` — the registered
  kernel path the timing harness and the conformance checks drive. A
  runner uploads the pack and its right-hand side when it is built, so
  a timed call copies nothing from the host;
* ``spmm_fn`` / ``spmm_runner`` / ``spmm`` — the multi-RHS path
  (``X: (n, B)`` -> ``Y: (m, B)``): fused SpMM kernels where the
  format has one, a generic per-column fallback otherwise, so every
  registered format serves batches;
* ``encode_knobs`` / ``decode_knobs`` — the canonical config-string
  round-trip (``"rgcsr_dtans[G=8,shared]"``);
* ``encode`` — the storable entropy-coded artifact serving builds
  (``decodes=True`` formats only).

Runners take ``device=`` (default ``"cuda"``): on the card the
kernel-backed formats launch the port's CUDA kernels through
`repro_torch.kernels.ops`; ``device="cpu"`` runs their plain torch
versions. csr / coo run a torch scatter-add (``index_add_``) and dense a
``torch.matmul``: neither has a hand-written kernel, by design.
``shard`` / ``shard_runner`` row-partition a matrix and run the plan,
per shard in a loop or one shard a rank of a process group
(`repro_torch.kernels.shard_ops`).

``fp`` arguments are duck-typed
`repro_torch.autotune.fingerprint.Fingerprint` objects; this module
imports nothing from ``repro_torch.autotune`` at load time so the
dependency points one way (autotune -> registry).

Adding a format touches exactly one file: subclass `FormatSpec`, call
`register`. The autotune sweep, the oracle and ``from_dense(auto=True)``
pick it up by iteration.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

import torch

from repro_torch.core.params import PAPER, DtansParams
from repro_torch.kernels.pack import check_device

#: dtANS interleave widths swept by the tuner (the reference's: a warp,
#: and the JAX package's TPU lane count); both are within the SpMM
#: kernel's `repro_torch.kernels.tiling.MAX_SPMM_LANE_WIDTH`.
DTANS_LANE_WIDTHS = (32, 128)
DTANS_SHARED_TABLE = (True, False)

#: Fill-in guard for the blocked entropy format: a block layout whose
#: stored-cell count exceeds this multiple of nnz is pointless to
#: encode (and expensive for the oracle), so the knob grid skips it.
BCSR_DTANS_MAX_FILL = 3.0


@dataclasses.dataclass(frozen=True)
class CostTerms:
    """Per-kernel work split of one (format, config) on one matrix.

    The roofline model charges ``lockstep`` element slots at
    ``spmv_ops_per_elem``, ``rowseq`` elements additionally at
    ``row_seq_penalty``, and ``decode`` elements at
    ``decode_ops_per_nnz`` — and `measure.calibrate` fits exactly those
    three coefficients, so a format's cost terms define both its
    modeled time and its calibration design-matrix row.
    """

    lockstep: float = 0.0
    rowseq: float = 0.0
    decode: float = 0.0

    @property
    def work_elems(self) -> float:
        """Total processed element slots (reporting)."""
        return self.lockstep + self.rowseq


@dataclasses.dataclass(frozen=True)
class KernelPass:
    """One pass of a format on the card, as its kernels run it: what the
    `H100` cost model (`repro_torch.autotune.cost_model.CardModel`)
    prices. ``kernel`` names the family of kernels (``"dtans"``,
    ``"padded"``: SELL / RGCSR / BCSR, ``"scatter"``: the torch stand-in of
    csr / coo; ``""``: priced on its `CostTerms` and launches alone),
    ``tiles`` the column tiles (reads, and decodes, of the matrix),
    ``lockstep`` the element slots its warps run in lock-step (None: the
    `CostTerms`' own), ``units`` the dtANS kernels' units (the SpMM's
    blocks take one unit and tile at a time) and ``staged`` whether a
    padded SpMM stages its x slab in shared memory."""

    kernel: str = ""
    tiles: int = 1
    launches: int = 1
    lockstep: float | None = None
    units: int = 0
    staged: bool = False


#: Config-string component spellings: knob name -> (prefix, parse).
_KNOB_PREFIX = {
    "group_size": "G=",
    "lane_width": "w=",
    "slice_height": "C=",
    "block_shape": "B=",
}


def _render_knob(name: str, value) -> str:
    if name == "shared_table":
        return "shared" if value else "split"
    if name == "block_shape":
        r, c = value
        return f"B={r}x{c}"
    # Unlisted knobs (third-party FormatSpecs) spell out their name.
    return f"{_KNOB_PREFIX.get(name, name + '=')}{value}"


def _parse_component(p: str, knob_names=()) -> tuple[str, object]:
    if p == "shared":
        return "shared_table", True
    if p == "split":
        return "shared_table", False
    head, eq, body = p.partition("=")
    if eq and head in knob_names:
        # A knob the spec literally declares wins over the reserved
        # short prefixes (a third-party spec may name a knob "G" or
        # "B"; the reserved meanings cannot apply to a spec that does
        # not declare group_size/block_shape anyway). Values round-trip
        # through their repr: int, then bool, then float, else the
        # string itself (mode=("fast", "safe")).
        if body in ("True", "False"):
            return head, body == "True"
        for conv in (int, float):
            try:
                return head, conv(body)
            except ValueError:
                pass
        return head, body
    for name, prefix in _KNOB_PREFIX.items():
        if p.startswith(prefix):
            body = p[len(prefix):]
            if name == "block_shape":
                r, _, c = body.partition("x")
                return name, (int(r), int(c))
            return name, int(body)
    raise ValueError(f"unknown config component {p!r}")


def _rhs(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A right-hand side as a tensor of the matrix's dtype on its device
    (no copy when it already is one)."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


class FormatSpec:
    """One sparse-format family: knobs, sizes, cost terms, kernels.

    Subclasses override the class attributes and the methods their
    family supports; `register` makes the format visible to every
    registry consumer. See the module docstring for the contract (and
    the JAX package's ``docs/formats.md`` for a worked example).
    """

    #: Family name — the ``fmt`` string everywhere.
    name: str = ""
    #: Enumerated by the autotuner's candidate search and the oracle.
    #: ``dense`` is registered but not selectable (it is the timing
    #: harness's bandwidth anchor, not a sparse candidate).
    selectable: bool = True
    #: Entropy-coded: owns an `encode` producing a decode-on-the-fly
    #: artifact (what serving's ``auto=True`` chooses among).
    decodes: bool = False
    #: Ordered knob domains: name -> default sweep tuple. The first
    #: entry of each domain is the knob's default.
    knob_domains: dict = {}
    #: Knobs always spelled in the config name (others appear only when
    #: they differ from the default — ``"sell"`` vs ``"sell[C=16]"``).
    named_knobs: tuple = ()
    #: Small-width knobs for the conformance corpus's tiny matrices.
    conformance_knobs: dict = {}

    # -- knobs -------------------------------------------------------

    def default_knobs(self) -> dict:
        return {k: v[0] for k, v in self.knob_domains.items()}

    def _knobs(self, knobs: dict) -> dict:
        """Defaults overlaid with ``knobs``; rejects unknown names."""
        unknown = set(knobs) - set(self.knob_domains)
        if unknown:
            raise ValueError(f"{self.name}: unknown knobs "
                             f"{sorted(unknown)}")
        out = self.default_knobs()
        out.update({k: v for k, v in knobs.items() if v is not None})
        if "block_shape" in out:
            out["block_shape"] = tuple(out["block_shape"])
        return out

    def normalize_knobs(self, knobs: dict | None = None) -> dict:
        """Public form of `_knobs`: defaults applied, names validated."""
        return self._knobs(knobs or {})

    def filter_knobs(self, knobs: dict) -> dict:
        """Drop None values and knobs this format does not declare —
        the one sanitization policy for caller-supplied knob sets (the
        cost model and the timing harness both accept a candidate's
        full knob surface and keep only what the format understands)."""
        return {k: v for k, v in knobs.items()
                if v is not None and k in self.knob_domains}

    def knob_grid(self, fp=None, overrides: dict | None = None
                  ) -> list[dict]:
        """Every knob combination the sweep enumerates for this format
        (``overrides`` narrows/extends individual knob domains; entries
        for knobs this format does not have are ignored). ``fp`` lets
        `admit` prune matrix-adaptive nonsense configurations."""
        axes = []
        for k, dom in self.knob_domains.items():
            if overrides and overrides.get(k) is not None:
                dom = tuple(overrides[k])
            axes.append([(k, v) for v in dom])
        grid = [self._knobs(dict(combo))
                for combo in itertools.product(*axes)]
        return [g for g in grid if fp is None or self.admit(fp, g)]

    def admit(self, fp, knobs: dict) -> bool:
        """Matrix-adaptive configuration filter (default: admit all)."""
        return True

    def encode_knobs(self, knobs: dict | None = None) -> str:
        """Canonical config name, e.g. ``"dtans[w=32,shared]"``."""
        kn = self._knobs(knobs or {})
        defaults = self.default_knobs()
        parts = [_render_knob(k, kn[k]) for k in self.knob_domains
                 if k in self.named_knobs or kn[k] != defaults[k]]
        return f"{self.name}[{','.join(parts)}]" if parts else self.name

    def decode_knobs(self, config_name: str) -> dict:
        """Inverse of `encode_knobs`; returns only the spelled knobs
        (defaults are applied by the consuming methods)."""
        fmt, _, rest = config_name.partition("[")
        if fmt != self.name:
            raise ValueError(f"config {config_name!r} is not a "
                             f"{self.name!r} config")
        out: dict = {}
        if rest:
            for p in rest.rstrip("]").split(","):
                k, v = _parse_component(p, tuple(self.knob_domains))
                if k not in self.knob_domains:
                    raise ValueError(
                        f"{self.name}: component {p!r} in "
                        f"{config_name!r} names no knob of this format")
                out[k] = v
        return out

    def interleave_width(self, knobs: dict | None = None) -> int | None:
        """Decode-slice interleave width of an encoded artifact
        (``decodes=True`` formats); None for plain formats."""
        return None

    def artifact_key(self, knobs: dict | None = None) -> tuple:
        """Key under which expensive constructed artifacts memoize in a
        shared ``artifacts`` mapping (oracle / measure / refinement)."""
        kn = self._knobs(knobs or {})
        return (self.name,) + tuple(kn[k] for k in self.knob_domains)

    # -- sizing ------------------------------------------------------

    def nbytes_exact(self, fp, **knobs) -> int | None:
        """Byte-exact size from the fingerprint alone, or None when the
        fingerprint cannot carry it (estimate + refinement instead)."""
        return None

    def nbytes_estimate(self, fp, *, params: DtansParams = PAPER,
                        **knobs) -> int:
        """Estimated size from fingerprint features (entropy formats)."""
        b = self.nbytes_exact(fp, **knobs)
        if b is None:
            raise NotImplementedError(
                f"{self.name}: no size estimate")
        return b

    def nbytes_constructed(self, a, *, params: DtansParams = PAPER,
                           artifacts: dict | None = None,
                           **knobs) -> int:
        """Constructed-truth size (builds/encodes; memoized under
        `artifact_key` when ``artifacts`` is given)."""
        raise NotImplementedError(f"{self.name}: nbytes_constructed")

    # -- cost model --------------------------------------------------

    def cost_terms(self, fp, **knobs) -> CostTerms:
        raise NotImplementedError(f"{self.name}: cost_terms")

    def kernel_passes(self, fp, batch: int, *, params: DtansParams = PAPER,
                      **knobs) -> KernelPass:
        """The `KernelPass` of one pass at ``batch`` right-hand sides on the
        card: how often it reads the matrix (and decodes it), the kernels
        it launches. Each kernel-backed family answers from its kernels'
        own tiling (`repro_torch.kernels.tiling`). Default: one tile, one
        launch."""
        return KernelPass()

    # -- kernels -----------------------------------------------------

    @property
    def spmv_fn(self):
        """The public ``repro_torch.kernels.ops`` entry point this
        format's runner drives, or None for the torch stand-ins (csr /
        coo / dense have no hand-written kernel by design)."""
        return None

    def pack(self, a, *, params: DtansParams = PAPER,
             artifacts: dict | None = None, **knobs):
        """Packed, runnable artifact for matrix ``a``."""
        raise NotImplementedError(f"{self.name}: pack")

    def upload(self, packed, device="cuda"):
        """`pack`'s tensors on ``device`` (built once and cached on the
        pack): an object with ``dtype`` and ``device``, for the formats
        whose runner drives a ``spmv_fn``."""
        raise NotImplementedError(f"{self.name}: upload")

    def runner(self, packed, x, *, device="cuda"):
        """Zero-arg callable computing ``y = A x`` from `pack`'s
        artifact (feed it to `repro_torch.autotune.measure.time_kernel`).
        The pack and ``x`` go to ``device`` now, once: a call copies
        nothing from the host."""
        fn = self.spmv_fn
        if fn is None:
            raise NotImplementedError(f"{self.name}: runner")
        d = self.upload(packed, device)
        xt = _rhs(x, d.dtype, d.device)
        return lambda: fn(packed, xt, device=d.device)

    def spmv(self, a, x, *, params: DtansParams = PAPER,
             device="cuda", **knobs):
        """One-shot ``y = A x`` through the registered kernel path —
        how the conformance checks drive every format."""
        packed = self.pack(a, params=params, **knobs)
        return self.runner(packed, x, device=device)()

    # -- multi-RHS (SpMM) --------------------------------------------

    @property
    def spmm_fn(self):
        """The public multi-RHS ``repro_torch.kernels.ops`` entry point
        (``X: (n, B)`` -> ``Y: (m, B)``), or None when the format has
        no fused SpMM kernel — `spmm_runner` then falls back to one
        `runner` call per column, so EVERY registered format exposes a
        batched path (third-party specs included) and gains the fused
        kernel by overriding only this property."""
        return None

    def spmm_runner(self, packed, x, *, device="cuda", bn=None,
                    tile_mode: str = "auto", pipeline: bool = False):
        """Zero-arg callable computing ``Y = A X`` (``X: (n, B)``) from
        `pack`'s artifact — the batched analogue of `runner`, driven by
        the timing harness (``measure.spmv_runner(batch=B)``) and the
        conformance checks; the pack and ``x`` are uploaded once, here.

        ``bn`` pins the kernel's column tile, ``tile_mode`` names the
        reference's tile schedule (`repro_torch.kernels.tiling.
        check_tile_mode`: one schedule runs) and ``pipeline`` the
        decode-ahead schedule (`repro_torch.kernels.ops.spmm`) —
        kernel-backed families only. The per-column fallback ignores
        ``bn`` and ``tile_mode`` (a column loop is already maximally
        tiled), stacks the columns with ``torch.stack`` on the device,
        and rejects ``pipeline`` for formats with nothing to decode, so
        third-party specs join unchanged."""
        from repro_torch.kernels.tiling import check_tile_mode
        check_tile_mode(tile_mode)
        fn = self.spmm_fn
        if pipeline and not self.decodes:
            raise ValueError(f"{self.name}: pipeline= only applies to "
                             "entropy-decoding formats")
        if fn is not None:
            kw = {}
            if bn is not None:
                kw["bn"] = bn
            if tile_mode != "auto":
                kw["tile_mode"] = tile_mode
            if pipeline:
                kw["pipeline"] = True
            d = self.upload(packed, device)
            xt = _rhs(x, d.dtype, d.device)
            return lambda: fn(packed, xt, device=d.device, **kw)
        x2 = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if x2.ndim != 2:
            raise ValueError(f"{self.name}: spmm_runner expects x of "
                             f"shape (n, B); got {tuple(x2.shape)}")
        runners = [self.runner(packed, x2[:, b].contiguous(),
                               device=device)
                   for b in range(x2.shape[1])]
        return lambda: torch.stack([torch.as_tensor(r()) for r in runners],
                                   dim=-1)

    def spmm(self, a, x, *, params: DtansParams = PAPER,
             device="cuda", bn=None, tile_mode: str = "auto",
             pipeline: bool = False, **knobs):
        """One-shot ``Y = A X`` through the registered batched kernel
        path — how the conformance checks sweep every format over B
        (and, with ``bn`` / ``tile_mode`` / ``pipeline``, over the tiled
        schedules, bitwise equal to the untiled kernel)."""
        packed = self.pack(a, params=params, **knobs)
        return self.spmm_runner(packed, x, device=device, bn=bn,
                                tile_mode=tile_mode,
                                pipeline=pipeline)()

    # -- sharding (multi-device row partition) -----------------------

    def shard_unit(self, knobs: dict | None = None) -> int:
        """Row alignment of a shard boundary: the height of the
        format's independent row unit (decode slice / group / block
        row).  Slices never straddle shards, so `shard` cuts only at
        multiples of this.  Default: the encoded interleave width for
        the ``decodes=True`` families, 1 (any row) otherwise."""
        return int(self.interleave_width(knobs) or 1)

    def shard(self, a, n_shards: int, *, params: DtansParams = PAPER,
              artifacts: dict | None = None, only: int | None = None,
              **knobs):
        """Row-partition matrix ``a`` into an ``n_shards``-way
        `repro_torch.sparse.shard.ShardPlan` — the registry-generic seam
        (same pattern as `spmm_runner`): boundaries at `shard_unit`
        multiples, each row block packed through this family's own
        `pack`, per-shard sizes exact via `nbytes_constructed`.  A
        third-party spec that implements the single-device contract
        shards for free.

        ``artifacts`` memoizes each shard's expensive constructed
        artifact under ``artifact_key + (n_shards, k)`` — one mapping
        shared with the oracle / refinement convention.

        ``only`` packs shard ``only`` alone, the others left None with size
        0: what one rank of a mesh, which runs its own shard, needs."""
        from repro_torch.sparse.shard import ShardPlan, csr_row_block, \
            shard_boundaries
        kn = self._knobs(knobs)
        unit = self.shard_unit(kn)
        bounds = shard_boundaries(a.shape[0], n_shards, unit)
        arts = artifacts if artifacts is not None else {}
        shards = []
        sizes = []
        for k in range(n_shards):
            if only is not None and k != only:
                shards.append(None)
                sizes.append(0)
                continue
            sub = csr_row_block(a, bounds[k], bounds[k + 1])
            key = self.artifact_key(kn) + ("shard", n_shards, k)
            sub_arts = arts.setdefault(key, {})
            shards.append(self.pack(sub, params=params,
                                    artifacts=sub_arts, **kn))
            sizes.append(int(self.nbytes_constructed(
                sub, params=params, artifacts=sub_arts, **kn)))
        return ShardPlan(fmt=self.name,
                         knobs=tuple((k, kn[k]) for k in
                                     self.knob_domains),
                         n_shards=int(n_shards), unit=unit,
                         boundaries=bounds, shards=tuple(shards),
                         shard_nbytes=tuple(sizes), shape=a.shape,
                         dtype=np.dtype(a.values.dtype))

    def shard_runner(self, plan, x, *, mesh=None, device="cuda",
                     bn=None, tile_mode: str = "auto",
                     pipeline: bool = False):
        """Zero-arg callable computing ``y = A x`` (1-D ``x``) or
        ``Y = A X`` (2-D ``x``) from a `shard` plan: the sharded analogue
        of `runner` / `spmm_runner`; ``x`` goes to ``device`` now, once.
        With a ``mesh`` whose ``"model"`` dim matches ``plan.n_shards``,
        the kernel-backed families run one shard a rank and all-reduce
        the rows (`repro_torch.kernels.shard_ops`); otherwise, and for
        packs without a shard adapter, a per-shard loop through this
        family's single-device runners, so EVERY registered format
        (third-party specs included) has a sharded path."""
        from repro_torch.kernels import shard_ops, tiling
        tiling.check_tile_mode(tile_mode)
        xt = _rhs(x, shard_ops.plan_dtype(plan), check_device(device))
        if xt.ndim == 1:
            return lambda: shard_ops.shard_spmv(plan, xt, mesh=mesh,
                                                device=xt.device,
                                                pipeline=pipeline)
        return lambda: shard_ops.shard_spmm(plan, xt, mesh=mesh,
                                            device=xt.device, bn=bn,
                                            tile_mode=tile_mode,
                                            pipeline=pipeline)

    # -- encoded artifact (decodes=True formats) ---------------------

    def encode(self, a, *, params: DtansParams = PAPER, **knobs):
        """Storable entropy-coded artifact (serving's build path)."""
        raise TypeError(f"format {self.name!r} is not entropy-coded")

    # -- candidates --------------------------------------------------

    def candidates(self, fp, overrides: dict | None = None, *,
                   params: DtansParams = PAPER
                   ) -> list[tuple[dict, int, bool]]:
        """``(knobs, nbytes, exact_size)`` per sweep point — what the
        cost model prices and the oracle refines."""
        out = []
        for knobs in self.knob_grid(fp, overrides):
            b = self.nbytes_exact(fp, **knobs)
            if b is None:
                out.append((knobs,
                            int(self.nbytes_estimate(fp, params=params,
                                                     **knobs)), False))
            else:
                out.append((knobs, int(b), True))
        return out


class KnobbedConfigMixin:
    """Accessors shared by the dataclasses that carry a ``(fmt,
    knobs)`` configuration (`repro_torch.autotune.cost_model.Candidate`,
    `repro_torch.autotune.search.Decision`): one implementation of the
    config-name rendering and the per-knob convenience properties, so
    the two can never drift apart. Expects ``self.fmt: str`` and
    ``self.knobs: tuple[(name, value), ...]``."""

    def knobs_dict(self) -> dict:
        return dict(self.knobs)

    @property
    def config_name(self) -> str:
        return get_format(self.fmt).encode_knobs(self.knobs_dict())

    @property
    def lane_width(self) -> int | None:
        """Interleave width of the encoded artifact for the dtANS
        family (== group size / block height for the aligned variants);
        None for plain formats."""
        kn = self.knobs_dict()
        if "lane_width" in kn:
            return kn["lane_width"]
        return get_format(self.fmt).interleave_width(kn)

    @property
    def shared_table(self) -> bool | None:
        return self.knobs_dict().get("shared_table")

    @property
    def group_size(self) -> int | None:
        return self.knobs_dict().get("group_size")

    @property
    def block_shape(self) -> tuple | None:
        return self.knobs_dict().get("block_shape")


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, FormatSpec] = {}


def register(spec: FormatSpec, *, replace: bool = False) -> FormatSpec:
    """Make ``spec`` visible to every registry consumer."""
    if not spec.name:
        raise ValueError("FormatSpec.name must be set")
    if spec.name in _REGISTRY and not replace:
        raise ValueError(f"format {spec.name!r} already registered "
                         f"(pass replace=True to override)")
    _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_format(name: str) -> FormatSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown format {name!r} "
                         f"(registered: {sorted(_REGISTRY)})") from None


def format_names(*, selectable: bool | None = None,
                 decodes: bool | None = None) -> tuple[str, ...]:
    """Registered family names, registration order, optionally filtered."""
    return tuple(s.name for s in iter_formats(selectable=selectable,
                                              decodes=decodes))


def iter_formats(*, selectable: bool | None = None,
                 decodes: bool | None = None) -> tuple[FormatSpec, ...]:
    return tuple(s for s in _REGISTRY.values()
                 if (selectable is None or s.selectable == selectable)
                 and (decodes is None or s.decodes == decodes))


def parse_config(config_name: str) -> tuple[FormatSpec, dict]:
    """Canonical config string -> (spec, spelled knobs)."""
    fmt = config_name.partition("[")[0]
    spec = get_format(fmt)
    return spec, spec.decode_knobs(config_name)


# --------------------------------------------------------------------------
# Built-in formats
# --------------------------------------------------------------------------


class DenseSpec(FormatSpec):
    """Dense ``A @ x`` — calibration's bandwidth anchor, never a sparse
    candidate."""

    name = "dense"
    selectable = False

    def nbytes_exact(self, fp, **knobs) -> int:
        return int(fp.rows) * int(fp.cols) * int(fp.value_bytes)

    def nbytes_constructed(self, a, *, params=PAPER, artifacts=None,
                           **knobs) -> int:
        m, n = a.shape
        return m * n * a.values.dtype.itemsize

    def cost_terms(self, fp, **knobs) -> CostTerms:
        return CostTerms(lockstep=float(fp.rows) * float(fp.cols))

    def pack(self, a, *, params=PAPER, artifacts=None, **knobs):
        return a.to_dense()

    def runner(self, packed, x, *, device="cuda"):
        dev = check_device(device)
        d = torch.as_tensor(packed, device=dev)
        xt = _rhs(x, d.dtype, dev)
        return lambda: torch.matmul(d, xt)

    def spmm_runner(self, packed, x, *, device="cuda", bn=None,
                    tile_mode: str = "auto", pipeline: bool = False):
        # Dense ``A @ X`` is the same contraction for any number of
        # right-hand sides — the single-vector runner already is the
        # batched bandwidth anchor. ``torch.matmul`` tiles the
        # contraction itself, so the tile knobs are accepted and ignored.
        from repro_torch.kernels.tiling import check_tile_mode
        check_tile_mode(tile_mode)
        return self.runner(packed, x, device=device)


class _RowSeqSpec(FormatSpec):
    """Shared machinery of the row-sequential baselines (csr / coo).

    There is no hand-written kernel for them (the paper abandons row-
    sequential SpMV on GPUs for the reason the cost model charges
    ``row_seq_penalty``); the measurable stand-in is the torch
    scatter-add SpMV, as the JAX package's is XLA's.
    """

    def cost_terms(self, fp, **knobs) -> CostTerms:
        return CostTerms(rowseq=float(fp.nnz))

    def kernel_passes(self, fp, batch, *, params=PAPER, **knobs):
        # `runner`'s four launches: the zero fill, the gather of x, the
        # products and the ``index_add_``, at any batch
        return KernelPass("scatter", launches=4)

    def pack(self, a, *, params=PAPER, artifacts=None, **knobs):
        return a

    def runner(self, packed, x, *, device="cuda"):
        """The scatter-add ``y[row] += v * x[col]`` over every nonzero
        (``index_add_``), for a 1-D ``x`` or an (n, B) one. On the card
        ``index_add_`` adds in no fixed order: hold its result to a
        tolerance, not bitwise."""
        dev = check_device(device)
        a = packed
        m = a.shape[0]
        rows = torch.as_tensor(np.repeat(np.arange(m, dtype=np.int64),
                                         np.diff(a.indptr)), device=dev)
        idx = torch.as_tensor(np.asarray(a.indices, dtype=np.int64),
                              device=dev)
        vals = torch.as_tensor(np.asarray(a.values), device=dev)
        xt = _rhs(x, vals.dtype, dev)
        terms = vals.reshape(-1, *[1] * (xt.ndim - 1))
        shape = (m, *xt.shape[1:])
        return lambda: torch.zeros(shape, dtype=vals.dtype,
                                   device=dev).index_add_(
            0, rows, terms * xt[idx])

    def spmm_runner(self, packed, x, *, device="cuda", bn=None,
                    tile_mode: str = "auto", pipeline: bool = False):
        # Batched scatter-add stand-in: one (m, B) accumulator, the
        # same row scatter, every RHS column updated per nonzero; the
        # tile knobs are accepted and ignored (no kernel, no tile).
        from repro_torch.kernels.tiling import check_tile_mode
        check_tile_mode(tile_mode)
        return self.runner(packed, x, device=device)


class CsrSpec(_RowSeqSpec):
    name = "csr"

    def nbytes_exact(self, fp, **knobs) -> int:
        return fp.nnz * (4 + fp.value_bytes) + (fp.rows + 1) * 4

    def nbytes_constructed(self, a, *, params=PAPER, artifacts=None,
                           **knobs) -> int:
        return a.nbytes


class CooSpec(_RowSeqSpec):
    name = "coo"

    def nbytes_exact(self, fp, **knobs) -> int:
        return fp.nnz * (8 + fp.value_bytes)

    def nbytes_constructed(self, a, *, params=PAPER, artifacts=None,
                           **knobs) -> int:
        from repro_torch.sparse.formats import COO
        return COO.from_csr(a).nbytes


class SellSpec(FormatSpec):
    name = "sell"
    knob_domains = {"slice_height": (32,)}
    conformance_knobs = {"slice_height": 16}

    def nbytes_exact(self, fp, *, slice_height=32) -> int:
        nslices = -(-fp.rows // slice_height) if fp.rows else 0
        return (fp.lockstep(slice_height) * (4 + fp.value_bytes)
                + (nslices + 1) * 4)

    def nbytes_constructed(self, a, *, params=PAPER, artifacts=None,
                           slice_height=32) -> int:
        from repro_torch.sparse.formats import SELL
        return SELL.from_csr(a, slice_height=slice_height).nbytes

    def cost_terms(self, fp, *, slice_height=32) -> CostTerms:
        return CostTerms(lockstep=float(fp.lockstep(slice_height)))

    def kernel_passes(self, fp, batch, *, params=PAPER, **knobs):
        return _padded_pass(fp, batch, chunked=True)

    @property
    def spmv_fn(self):
        from repro_torch.kernels import ops
        return ops.sell_spmv

    @property
    def spmm_fn(self):
        from repro_torch.kernels import ops
        return ops.sell_spmm

    def shard_unit(self, knobs=None) -> int:
        return int(self._knobs(knobs or {})["slice_height"])

    def pack(self, a, *, params=PAPER, artifacts=None, slice_height=32):
        from repro_torch.kernels.sell_spmv import pack_sell
        return pack_sell(a, lane_width=int(slice_height))

    def upload(self, packed, device="cuda"):
        from repro_torch.kernels.sell_spmv import to_device
        return to_device(packed, device)


class RgcsrSpec(FormatSpec):
    name = "rgcsr"
    named_knobs = ("group_size",)
    conformance_knobs = {"group_size": 8}

    @property
    def knob_domains(self):
        from repro_torch.sparse.rgcsr import RGCSR_GROUP_SIZES
        return {"group_size": RGCSR_GROUP_SIZES}

    def nbytes_exact(self, fp, *, group_size=4) -> int:
        from repro_torch.sparse.rgcsr import local_indptr_bytes
        G = int(group_size)
        ngroups = -(-fp.rows // G) if fp.rows else 0
        lb = local_indptr_bytes(fp.group_max_nnz(G))
        return (fp.nnz * (4 + fp.value_bytes) + ngroups * (G + 1) * lb
                + (ngroups + 1) * 4)

    def nbytes_constructed(self, a, *, params=PAPER, artifacts=None,
                           group_size=4) -> int:
        from repro_torch.sparse.rgcsr import rgcsr_nbytes_exact
        return rgcsr_nbytes_exact(a.row_nnz(), group_size,
                                  a.values.dtype.itemsize)

    def cost_terms(self, fp, *, group_size=4) -> CostTerms:
        return CostTerms(lockstep=float(fp.lockstep(group_size)))

    def kernel_passes(self, fp, batch, *, params=PAPER, **knobs):
        return _padded_pass(fp, batch, chunked=True)

    @property
    def spmv_fn(self):
        from repro_torch.kernels import ops
        return ops.rgcsr_spmv

    @property
    def spmm_fn(self):
        from repro_torch.kernels import ops
        return ops.rgcsr_spmm

    def shard_unit(self, knobs=None) -> int:
        return int(self._knobs(knobs or {})["group_size"])

    def pack(self, a, *, params=PAPER, artifacts=None, group_size=4):
        from repro_torch.kernels.rgcsr_spmv import pack_rgcsr
        from repro_torch.sparse.rgcsr import RGCSR
        return pack_rgcsr(RGCSR.from_csr(a, int(group_size)))

    def upload(self, packed, device="cuda"):
        from repro_torch.kernels.rgcsr_spmv import to_device
        return to_device(packed, device)


class _DtansFamilySpec(FormatSpec):
    """Shared machinery of the entropy-coded families: artifact-
    memoized encodes, `ops.spmv` / `ops.spmm` runners (a BCSR-dtANS
    pack has ``shared_cols`` set, so its runners reach the fused
    shared-column kernels), serving `encode`."""

    decodes = True

    def _encode(self, a, *, params: DtansParams, **knobs):
        raise NotImplementedError

    def encode(self, a, *, params: DtansParams = PAPER, **knobs):
        return self._encode(a, params=params, **self._knobs(knobs))

    def _artifact(self, a, *, params: DtansParams,
                  artifacts: dict | None, **knobs):
        kn = self._knobs(knobs)
        enc = artifacts if artifacts is not None else {}
        # another parameter set is another artifact (PAPER's keys as ever)
        key = self.artifact_key(kn) + (() if params == PAPER else (params,))
        mat = enc.get(key)
        if mat is None:
            mat = self._encode(a, params=params, **kn)
            enc[key] = mat
        return mat

    def nbytes_constructed(self, a, *, params=PAPER, artifacts=None,
                           **knobs) -> int:
        return int(self._artifact(a, params=params, artifacts=artifacts,
                                  **knobs).nbytes)

    @property
    def spmv_fn(self):
        from repro_torch.kernels import ops
        return ops.spmv

    @property
    def spmm_fn(self):
        from repro_torch.kernels import ops
        return ops.spmm

    def pack(self, a, *, params=PAPER, artifacts=None, **knobs):
        from repro_torch.kernels import ops
        # get_packed caches the pack on the encoded object, so repeat
        # measurements of a memoized artifact never re-pack.
        return ops.get_packed(self._artifact(a, params=params,
                                             artifacts=artifacts,
                                             **knobs))

    def upload(self, packed, device="cuda"):
        from repro_torch.kernels.pack import to_device
        return to_device(packed, device)

    def kernel_passes(self, fp, batch, *, params=PAPER, **knobs):
        from repro_torch.kernels import tiling
        kn = self._knobs(knobs)
        L = self.interleave_width(kn)
        tables = 1 if kn.get("shared_table", True) else 2
        tiles, launches = tiling.dtans_spmm_passes(L, tables, batch,
                                                   fp.value_bytes, params)
        # a unit's rows decode in lock-step (`tiling.unit_rows`); blocked
        # layouts decode their filled cells (`CostTerms`)
        lock = (None if self.name == "bcsr_dtans"
                else fp.lockstep(tiling.unit_rows(L)))
        units = tiling.geometry(-(-fp.rows // L), L, tables, fp.value_bytes,
                                params=params).units
        return KernelPass("dtans", tiles, launches, lock, units=units)


class DtansSpec(_DtansFamilySpec):
    name = "dtans"
    knob_domains = {"lane_width": DTANS_LANE_WIDTHS,
                    "shared_table": DTANS_SHARED_TABLE}
    named_knobs = ("lane_width", "shared_table")
    conformance_knobs = {"lane_width": 16}

    def interleave_width(self, knobs=None):
        return int(self._knobs(knobs or {})["lane_width"])

    def nbytes_estimate(self, fp, *, params=PAPER, lane_width=32,
                        shared_table=True) -> int:
        from repro_torch.autotune.cost_model import dtans_nbytes_estimate
        return dtans_nbytes_estimate(fp, lane_width=lane_width,
                                     shared_table=shared_table,
                                     params=params)

    def cost_terms(self, fp, *, lane_width=32,
                   shared_table=True) -> CostTerms:
        w = float(fp.lockstep(lane_width))
        return CostTerms(lockstep=w, decode=w)

    def _encode(self, a, *, params, lane_width, shared_table):
        from repro_torch.core.csr_dtans import encode_matrix
        return encode_matrix(a, params=params, lane_width=int(lane_width),
                             shared_table=bool(shared_table))


class RgcsrDtansSpec(_DtansFamilySpec):
    name = "rgcsr_dtans"
    named_knobs = ("group_size", "shared_table")
    conformance_knobs = {"group_size": 8}

    @property
    def knob_domains(self):
        from repro_torch.sparse.rgcsr import RGCSR_GROUP_SIZES
        # Shared table only in the default sweep: the group sweep
        # already multiplies the candidate set, and split tables never
        # paid off at narrow interleave widths (table bytes double,
        # stream bits do not).
        return {"group_size": RGCSR_GROUP_SIZES,
                "shared_table": (True,)}

    def interleave_width(self, knobs=None):
        return int(self._knobs(knobs or {})["group_size"])

    def nbytes_estimate(self, fp, *, params=PAPER, group_size=4,
                        shared_table=True) -> int:
        from repro_torch.autotune.cost_model import rgcsr_dtans_nbytes_estimate
        return rgcsr_dtans_nbytes_estimate(fp, group_size=group_size,
                                           shared_table=shared_table,
                                           params=params)

    def cost_terms(self, fp, *, group_size=4,
                   shared_table=True) -> CostTerms:
        w = float(fp.lockstep(group_size))
        return CostTerms(lockstep=w, decode=w)

    def _encode(self, a, *, params, group_size, shared_table):
        from repro_torch.core.rgcsr_dtans import encode_rgcsr_matrix
        return encode_rgcsr_matrix(a, group_size=int(group_size),
                                   params=params,
                                   shared_table=bool(shared_table))


def _padded_pass(fp, batch: int, *, chunked: bool) -> KernelPass:
    """The SELL / RGCSR / BCSR pass (`tiling.padded_spmm_passes`), the
    SpMM's x slab staged in shared memory where it fits
    (`tiling.padded_geometry`). ``chunked``: a warp runs a chunk of 32
    rows in lock-step (SELL, RGCSR); BCSR's lock-step slots are its
    filled block cells (`CostTerms`)."""
    from repro_torch.kernels import tiling
    tiles, launches = tiling.padded_spmm_passes(batch, fp.value_bytes)
    staged = batch > 1 and tiling.padded_spmm_staged(
        fp.rows, fp.cols, batch, fp.value_bytes)
    lock = fp.lockstep(tiling.WARP) if chunked else None
    return KernelPass("padded", tiles, launches, lock, staged=staged)


def block_count(fp, block_shape) -> tuple[int, bool]:
    """(nonempty r x c blocks, exact?) from a fingerprint — exact for
    any shape via the fingerprint's lazily-derived block-fill feature;
    worst case one block per nonzero only for hand-built fingerprints
    without stashed CSR structure. THE single fallback policy for both
    blocked specs' sizing, cost terms and admit guard."""
    nb = fp.block_nonempty(tuple(block_shape))
    if nb is not None:
        return int(nb), True
    return int(fp.nnz), False


class BcsrSpec(FormatSpec):
    """Blocked CSR (`repro_torch.sparse.bcsr`) — registered purely through
    this module: no dispatch site anywhere names it."""

    name = "bcsr"
    named_knobs = ("block_shape",)
    conformance_knobs = {"block_shape": (4, 4)}

    @property
    def knob_domains(self):
        from repro_torch.sparse.bcsr import BCSR_BLOCK_SHAPES
        return {"block_shape": BCSR_BLOCK_SHAPES}

    def nbytes_exact(self, fp, *, block_shape=(2, 2)) -> int | None:
        from repro_torch.sparse.bcsr import bcsr_nbytes_exact
        nb, exact = block_count(fp, block_shape)
        if not exact:
            return None
        return bcsr_nbytes_exact(nb, fp.rows, tuple(block_shape),
                                 fp.value_bytes)

    def nbytes_estimate(self, fp, *, params=PAPER,
                        block_shape=(2, 2)) -> int:
        from repro_torch.sparse.bcsr import bcsr_nbytes_exact
        nb, _ = block_count(fp, block_shape)
        return bcsr_nbytes_exact(nb, fp.rows, tuple(block_shape),
                                 fp.value_bytes)

    def nbytes_constructed(self, a, *, params=PAPER, artifacts=None,
                           block_shape=(2, 2)) -> int:
        from repro_torch.sparse.bcsr import (bcsr_nbytes_exact,
                                       count_nonempty_blocks)
        nb = count_nonempty_blocks(a.indptr, a.indices, a.shape,
                                   tuple(block_shape))
        return bcsr_nbytes_exact(nb, a.shape[0], tuple(block_shape),
                                 a.values.dtype.itemsize)

    def cost_terms(self, fp, *, block_shape=(2, 2)) -> CostTerms:
        r, c = block_shape
        nb, _ = block_count(fp, block_shape)
        return CostTerms(lockstep=float(nb * r * c))

    def kernel_passes(self, fp, batch, *, params=PAPER, **knobs):
        return _padded_pass(fp, batch, chunked=False)

    @property
    def spmv_fn(self):
        from repro_torch.kernels import ops
        return ops.bcsr_spmv

    @property
    def spmm_fn(self):
        from repro_torch.kernels import ops
        return ops.bcsr_spmm

    def shard_unit(self, knobs=None) -> int:
        return int(self._knobs(knobs or {})["block_shape"][0])

    def pack(self, a, *, params=PAPER, artifacts=None,
             block_shape=(2, 2)):
        from repro_torch.kernels.bcsr_spmv import pack_bcsr
        from repro_torch.sparse.bcsr import BCSR
        return pack_bcsr(BCSR.from_csr(a, tuple(block_shape)))

    def upload(self, packed, device="cuda"):
        from repro_torch.kernels.bcsr_spmv import to_device
        return to_device(packed, device)


class BcsrDtansSpec(_DtansFamilySpec):
    """dtANS entropy coding over the blocked index layout — the
    existing decode machinery composing with a new `FormatSpec`, zero
    kernel changes (`BCSRdtANS` IS a `CSRdtANS`)."""

    name = "bcsr_dtans"
    named_knobs = ("block_shape", "shared_table")
    conformance_knobs = {"block_shape": (2, 2)}

    @property
    def knob_domains(self):
        from repro_torch.sparse.bcsr import BCSR_BLOCK_SHAPES
        return {"block_shape": BCSR_BLOCK_SHAPES,
                "shared_table": (True,)}

    def interleave_width(self, knobs=None):
        return int(self._knobs(knobs or {})["block_shape"][0])

    def admit(self, fp, knobs) -> bool:
        """Skip block layouts whose fill-in dwarfs the nonzeros: the
        stream cannot win, and the oracle would pay a full encode of
        ``fill x nnz`` symbols to prove it. When the block count is not
        exactly known (a hand-built fingerprint without stashed
        structure), admit — the worst-case fallback count would veto
        every shape >= 2x2 regardless of the actual block structure,
        and the estimate-then-refine path can still decide."""
        r, c = knobs["block_shape"]
        blocks, exact = block_count(fp, knobs["block_shape"])
        if not exact:
            return True
        return blocks * r * c / max(fp.nnz, 1) <= BCSR_DTANS_MAX_FILL

    def nbytes_estimate(self, fp, *, params=PAPER, block_shape=(2, 2),
                        shared_table=True) -> int:
        from repro_torch.autotune.cost_model import bcsr_dtans_nbytes_estimate
        return bcsr_dtans_nbytes_estimate(fp, block_shape=block_shape,
                                          shared_table=shared_table,
                                          params=params)

    def cost_terms(self, fp, *, block_shape=(2, 2),
                   shared_table=True) -> CostTerms:
        r, c = block_shape
        blocks, _ = block_count(fp, block_shape)
        w = float(blocks * r * c)
        return CostTerms(lockstep=w, decode=w)

    def _encode(self, a, *, params, block_shape, shared_table):
        from repro_torch.core.bcsr_dtans import encode_bcsr_matrix
        return encode_bcsr_matrix(a, block_shape=tuple(block_shape),
                                  params=params,
                                  shared_table=bool(shared_table))


for _spec in (DenseSpec(), CsrSpec(), CooSpec(), SellSpec(),
              RgcsrSpec(), DtansSpec(), RgcsrDtansSpec(),
              BcsrSpec(), BcsrDtansSpec()):
    register(_spec)
del _spec
