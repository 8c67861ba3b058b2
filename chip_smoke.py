#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each raising on failure (no phase falls back to the CPU):

1. device: the card's name, count and power limit; no CUDA card -> exit 1.
2. build: compiles ``kernels/csrc/*.cu`` with nvcc from the checkout, the
   dtANS sources once per parameter set of phase 4o.
3. kernels against their plain torch versions on the card, on seeded
   matrices (f64 and f32, shared and split tables, escape-heavy values, lane
   widths 8..128, empty rows): SpMV and SpMM at B in {3, 64}; a ragged
   column tile (bn=24) and SpMM at B=1 must be bitwise equal to the untiled
   kernel and to SpMV; ``ops.decode`` must give `decode_ref`'s columns and
   value bits. The same matrices packed as SELL (slice heights 16, 32,
   128), RGCSR (groups 4, 8, 16, 32) and BCSR (every registry block shape)
   go through the comparator kernels the same way, bitwise their plain
   versions, each SpMM column bitwise its SpMV; two RGCSR-dtANS encodes go
   through the dtANS kernels, and BCSR-dtANS encodes at 2x2, 4x4 and 40x2
   through the fused shared-column kernels, bitwise their plain versions
   and the generic kernels. Hand-made SELL and RGCSR packs that no matrix
   packs to (-1 holes before real entries, deltas past each row's count,
   int32 running sums past 2^31, rows of 0, 1, 3, 4, 5 and 9 entries; x
   of 13 and 13,000 rows) hold the SpMV and SpMM bitwise their plain
   versions. A lane-width sweep (L in `SWEEP_L`, 1 to 1024)
   holds the dtANS kernels and decode bitwise against their plain versions
   on an escape-heavy quantized f32 matrix, an f64 matrix with two tables
   and a matrix whose table base reaches 256 (a digit group's radix of
   2^32), with tiles, B=1 SpMM vs SpMV and ``pipeline=True`` vs ``False``;
   ``ops.spmm`` at L = 1024 (one SpMV launch a column) and with ``bn=400``
   at L = 128 (a tile cut to fit shared memory), bitwise the plain SpMM.
4. the main path at full width: the tied LM head of SmolLM-135M (d_model
   576, vocab 49152) compressed by ``SparseLinear.from_dense`` with its
   defaults, serving a few requests through ``apply``; each is held
   against ``apply_dense_reference`` and the plain path, and both kernels'
   launch counters must have risen.
4b. the comparator path at full width: the head's own pruned matrix packed
   as SELL (slice height 32), RGCSR (groups 4 and 32) and BCSR (2x2) serves
   the same request shapes through ``ops.sell_spmm`` / ``ops.rgcsr_spmm`` /
   ``ops.bcsr_spmm``, held against the dense product and, bitwise, the
   plain versions; all six comparator kernels' launch counters must have
   risen.
4c. the blocked path at full width: the head's shape pruned in 4x4 tiles
   (`block_sparse`, density 0.2, 8-bit codebook) encoded as BCSR-dtANS
   4x4 and served by a ``SparseLinear`` through the fused shared-column
   kernels (their counters must rise), held against the dense product, the
   fused plain version and, bitwise, the generic kernels
   (``fused=False``); the same matrix as BCSR 4x4 through
   ``ops.bcsr_spmm``. Its host encode and host decode depend on the seed
   alone and run in a process of their own from the start, beside phases
   2-4b.
4d. decode: ``ops.decode`` of the phase-4 head and the phase-4c matrix,
   columns and value bits equal to `decode_ref` and the real entries
   exactly the host's `decode_matrix`; the kernel's counter must rise.
4e. the autotuned head: the phase-4 weight built by
   ``SparseLinear.from_dense(auto=True, autotune_measure=True)`` (budget
   2, B=64, the `H100` cost model, a memory-only decision cache): the two
   best-modeled entropy-coded candidates are encoded and their CUDA
   kernels timed (CUDA graphs between CUDA events); the winner, the
   runner-up and phase 4's configuration are timed again as phase 5 times
   and the script says whether the ranking holds; the winner serves the phase-4
   request shapes, each held against the dense product of the head's
   pruned weight and, bitwise, the winner's plain path on the card (and
   phase 4's outputs, where it picks phase 4's configuration); the
   winner's launch counters must have risen. The `H100` model prices each
   measured candidate within `MODEL_BAND` (2x) of its time, and
   ``choose_dtans_config(budget=0)`` (estimates, no encode) picks at B=1
   and B=64, each held against the fastest configuration measured here.
4f. the registry and calibration on the card: every registered format's
   ``FormatSpec`` runners (B = 1, 8) on two of `measure._calibration_suite`'s
   matrices, the kernel-backed ones bitwise their plain versions, csr /
   coo / dense within tolerance of the dense product (every comparator and
   dtANS kernel's counter must rise); then ``measure.calibrate(base=H100,
   small=True)`` times the calibration configurations' runners on its five
   matrices, and the `H100` model (fitted by
   ``experiments/autotune_calibration/fit_h100.py``) prices each within
   `MODEL_BAND` of its time.
4g. the serving engine at full width: SmolLM-135M (30 layers, d_model 576,
   9 / 3 heads, d_ff 1536, vocab 49152, tied; float32 where the config
   says bfloat16, TF32 off), layer weights from a generator seeded
   `SEED`, the tied embedding set to phase 4's ``w.T``, so phase 4's layer
   is its compressed head with no new encode. `ENGINE_PROMPTS` (8 prompts,
   8 new tokens each) go through ``Engine(slots=4, max_seq=64,
   sparse_head=...)`` (every step one ``dtans_spmm`` launch, nothing
   else) and a ``slots=1`` engine (one ``dtans_spmv`` a step), token for
   token the same; the first pooled step's logits are held against the
   decoded head (rtol 1e-4, atol 1e-5) and, bitwise, the plain path. A
   dense-head engine serves the same requests (no kernel launched). Both
   engines' decode step, TTFT, prefill and tokens/s are logged, and a
   pooled step is split by CUDA events around ``decode_hidden`` and
   around the head (50 steps a head, the heads taking turns; percentiles
   10 / 50 / 90), beside each part's device time alone and its launches
   (the nodes of a CUDA graph of it).
4h. the ssm family at full width: mamba2-130m (24 SSM layers, d_model
   768, d_inner 1536, 24 heads of 64, state 128, conv 4, chunk 256, vocab
   50280, tied; attention-free; float32 where the config says bfloat16,
   TF32 off), weights from a generator seeded `SEED`, nothing cut. Its
   head compressed by ``Engine.compress_lm_head`` at ``from_dense``'s
   defaults (a host encode of ~7.7 M nonzeros, made on the host beside
   phases 2-4c from the same seeded weights, checked by a digest of the
   head, moved to the card by ``SparseLinear.to``) serves `SSM_PROMPTS`
   (4g's, the last 301 tokens long, so its prefill runs two chunks of 256,
   the second padded; ``max_seq=320``)
   through the same three engines and checks as 4g (`_serve_and_check`:
   ``dtans_spmm`` launches equal to the pooled steps, ``dtans_spmv`` to
   the sequential ones, pooled == sequential, logits against the decoded
   head and the plain path), and the same split of a pooled step; the
   dense f32 head (154.4 MB) exceeds the 50 MB L2, the compressed one
   fits. The long prompt's 300-token chunked prefill is held against 299
   single-token steps over the same tokens (last logits within 1e-3 of
   their largest |logit|, argmax equal) and timed.
4i. the row-sharded head: phase 4's weight built by
   ``SparseLinear.from_dense(n_shards=4)`` (its four shards of 96 slices
   encoded on the host beside phases 2-4c, then moved to the card by
   ``SparseLinear.to``, where ``from_dense`` ends; the whole head is not
   encoded, the layer never needs it).
   The per-shard loop serves B =
   1, 4, 64 and 512 bitwise phase 4's layer, 4 launches a pass, and
   phase 4g's requests through a pooled engine (4 launches a step) with
   4g's token streams; a pooled step (``decode_hidden`` and the sharded
   head) captures into one CUDA graph; the sharded head's times beside
   phase 4's. Then the same plan (its host packs, not encoded again) on
   4 gloo ranks on this one card (NCCL refuses two ranks on one GPU), each
   uploading only its own shard, bitwise the loop path at B = 1 and 64 on
   every rank, with the wall time of a pass; and every registered format's
   plan of a phase-3 matrix on 2 and 4 ranks against the format's
   single-device runner (bitwise for the kernel-backed formats; csr / coo
   / dense, which add in no fixed order on the card, within `RTOL`).
4j. training at full width: SmolLM-135M (30 layers, d_model 576, 9 / 3
   heads, d_ff 1536, vocab 49152, tied) in its own bfloat16 with float32
   masters, ``remat=False``, AdamW lr 3e-4, 2 microbatches, on
   `SyntheticTokens` batches of 16 x 512 (`examples/train_lm.py`'s full
   run). One trainer runs 30 steps uninterrupted, each step between CUDA
   events (p10 / 50 / 90, tokens/s, peak memory); a second from the same
   weights checkpoints every 10 steps into a temporary directory, crashes
   at step 25, restores step 20 (every leaf of its parameters and
   optimizer state bitwise what it saved) and resumes to 30: the final
   losses within 1e-4 (the reference's limit), the loss falling. The
   trained head is scored by `examples/train_lm_torch.py::sparse_head_eval`
   at sparsity 0.8: all 8192 hidden rows through one ``apply`` (one
   ``dtans_spmm`` launch, counted), held against the decoded head (rtol
   1e-4, atol 1e-5), its first 64 rows applied alone and through the plain
   path bitwise the pool's; the B = 8192 pass timed beside dense
   ``torch.matmul`` and cuSPARSE CSR. Then every `configs.ARCH_IDS` smoke
   config trains 3 steps through ``repro_torch.launch.train.main`` (one
   also with Adafactor, one at 2 microbatches with gradient compression):
   finite losses, every parameter's gradient finite and nonzero.
4k. data parallelism and elasticity at full width: 4j's SmolLM-135M on 2
   gloo ranks of this one card (``DataParallelTrainer`` over a ``"data"``
   mesh, 8 x 512 each, the f32 gradients all-reduced in one flat bucket),
   then shrunk in the same world to one rank (``resize``: the state
   resharded onto a one-rank mesh, the global batch of 16 kept in 2
   microbatches): every step's loss held against a one-rank ``Trainer`` on
   the concatenated shard batches (`DP_LOSS_RTOL`); the all-reduce bytes
   ``op_cost`` counts in a step equal the gradients' bytes plus the 4-byte
   loss, and half of them with ``grad_compress``; step p50 by CUDA events
   with the all-reduces' share.
4l. the CG solve: ``examples/cg_solver_torch.py``'s CG on
   ``stencil_2d(512)`` in float64 (262,144 unknowns; encoded beside phases
   2-4c) to a relative residual
   of 1e-10 through B1 (``dtans_spmv``: iterations + 1 launches), and the
   same CG through cuSPARSE CSR: both errors against ``x_true`` under kappa
   x tol, the iteration counts within 2%; ms an iteration; one SpMV of each
   timed as phase 5 times B=1, beside the bound.
4m. ``examples/quickstart_torch.py`` on the card: its SpMV and its
   ``SparseLinear(auto=True)`` batch launch kernels (counted).
4n. tensor parallelism at full width: 4g's SmolLM-135M (f32, TF32 off) on
   a (1 data, 3 model) mesh of 3 gloo ranks on this one card (NCCL
   refuses two ranks on one GPU), its parameters DTensors placed by the
   sharding rules (each rank's bytes exactly the specs' reckoning); 4g's
   8 prompts prefilled into a head-sharded cache, then 16 greedy decode
   steps through phase 4's weight as a 3-shard compressed head (each rank
   encodes its own shard, at once; ``dtans_spmm`` launches counted on
   every rank): the head's output bitwise the one-device loop over the
   three shards, the dense TP logits within rtol 1e-4 / atol 1e-5 x
   max|logit| of the one-device model's on the same tokens, the tokens
   the one-device model's and (first 8) 4g's streams, a differing token
   allowed only inside its top-2 gap. ``op_cost`` counts one decode
   step's collectives: Megatron's 2 all-reduces a layer, the embedding's
   and the logits' gather, nothing else. Three ``TensorParallelTrainer``
   steps in f32 (8 x 512) within 1e-4 of a one-rank ``Trainer``, then 5
   steps of 4j's bf16 configuration within `DP_LOSS_RTOL`; prefill,
   decode-step and train-step times by CUDA events on rank 0 with the
   collectives' share. Then the optimizer state placed by the specs, f32
   at a global batch of 6 x 512, AdamW: 3 ZeRO-1 steps on a (3 data, 1
   model) mesh of the same ranks (each rank's optimizer bytes the
   dry-run's reckoning, a third of the state; every weight bitwise a
   ``zero1=False`` run's on that mesh; a checkpoint of whole tensors
   written), that checkpoint restored on the (1, 3) mesh for 2 more
   steps, and 3 steps with FSDP forced on (3, 1) (parameter and AdamW
   bytes a rank the reckoning, the state 3x the parameters); every loss
   within 1e-4 of a one-rank ``Trainer`` run uninterrupted; step ms and
   the collectives' share on rank 0 (the last step's collectives over the
   warm untimed step before it).
4o. parameter sets: the dtANS kernels compiled for each set of
   `PARAM_SETS` (`tests/param_sets.py`: PAPER, TOY and eight that move
   its constants: K = 2^8 and 2^16, whose 1.5 MB of tables stay in global
   memory, 16- and 8-bit words, M = 2^4 and 2^16 with its 16-byte slots,
   l = 48, o = 1 and 2, and L66's 2-slot tables, 22-bit words and 66
   positions a segment). (a) Each set's encodes of tests/test_torch_params.py's
   matrices (f32 on one table, f64 on two) and of a band of 109,970
   nonzeros (f32, f64) go through ``ops.spmv`` (B1), ``ops.spmm`` at B =
   4 and 64 (B2) and ``ops.decode`` (B3), bitwise the plain versions and
   within `RTOL` of the float64 product, the launches counted per set;
   the band's f32 kernels are timed beside their plain versions,
   cuSPARSE CSR and the bound. (b) Phase 4's head encoded at `HEAD_SET`
   (K16) goes the same way at B = 1, 4, 64, and each kernel is timed in
   turns with phase 4's PAPER head (PAPER, K16, K16, PAPER), beside its
   plain version, cuSPARSE CSR, the bound (the set's own table bytes) and
   both heads' bytes. Every encode runs from the start in a process of
   its own beside phases 2-4b (`params_host`).
The roofline check: ``launch.dryrun.run_cell`` on 4j's cell (one card),
   counted on a fake process group of one rank; its bound must lie below
   4j's measured step p50, and the roofline's 80 GiB within 5% of the
   card's memory.
5. times on the card (CUDA events) per batch size: kernel, plain version,
   the library calls (cuSPARSE CSR ``torch.sparse_csr_tensor @ x``, and
   BSR ``torch.sparse_bsr_tensor @ x`` for the blocked rows where it runs;
   timed only; a row's ``library_ms`` is the faster of them), dense
   matmul, and the bound, for every kernel; the SELL, RGCSR and BCSR SpMM
   rows (B = 4, 8, 64, 512) also as a ratio to cuSPARSE CSR. The B=1
   rows (kernel and library calls) are timed without the Python loop
   around the entry point: the median of 5 replays of a CUDA graph of 20
   calls (where capture fails, of loops of the C entry alone), the loop's
   time of earlier runs beside; decode is timed the same way. Phase 2 logs
   the registers and spills of every SELL / RGCSR / BCSR SpMM and SpMV
   instantiation and of the decode kernel's (f32 / f64, each block
   size), PAPER's dtANS ptxas lines, and each other set's most registers
   and spilled bytes.

Prints a ``{"kernels": [...]}`` line (each dtANS kernel once more per
parameter set, ``name[SET]``), the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. ``--json PATH`` also
writes every number it measured to PATH. Phases 4j-4n and the roofline
check (after 4j) need nothing of the earlier ones: ``python -c "import
chip_smoke as c; c.phase_device(); c.phase_build(); c.phase_dp()"`` runs
one alone (``c.phase_tp()`` without 4g's streams compares the tokens with
the one-device model's only). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import functools
import hashlib
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.append(str(ROOT / "tests"))  # hand_made_packs, torch_shard_ranks
sys.path.append(str(ROOT / "examples"))  # train_lm, cg_solver, quickstart

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import configs, obs  # noqa: E402
from repro_torch.autotune import H100, DecisionCache, measure  # noqa: E402
from repro_torch.autotune import choose_dtans_config  # noqa: E402
from repro_torch.core.bcsr_dtans import encode_bcsr_matrix  # noqa: E402
from repro_torch.core.csr_dtans import decode_matrix, encode_matrix  # noqa: E402
from repro_torch.core.params import DtansParams  # noqa: E402
from repro_torch.core.rgcsr_dtans import encode_rgcsr_matrix  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens  # noqa: E402
from repro_torch.kernels import _build, ops, shard_ops, tiling  # noqa: E402
from repro_torch.kernels import bcsr_spmv as BC  # noqa: E402
from repro_torch.kernels import dtans_decode as DD  # noqa: E402
from repro_torch.kernels import dtans_spmv as K  # noqa: E402
from repro_torch.kernels import rgcsr_spmv as RG  # noqa: E402
from repro_torch.kernels import sell_spmv as SE  # noqa: E402
from repro_torch.kernels.pack import pack_matrix, to_device  # noqa: E402
from repro_torch.kernels.ref import decode_ref  # noqa: E402
from repro_torch.launch import dryrun, op_cost, roofline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_debug_mesh, spawn  # noqa: E402
from repro_torch.launch.sharding import local_shape  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.models.sharding import full, tp_context  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.sparse_linear import SparseLinear  # noqa: E402
from repro_torch.sparse.bcsr import BCSR, BCSR_BLOCK_SHAPES  # noqa: E402
from repro_torch.sparse.formats import CSR, best_baseline_nbytes  # noqa: E402
from repro_torch.sparse.prune import codebook_quantize, magnitude_prune  # noqa: E402
from repro_torch.sparse.random_graphs import block_sparse, stencil_2d  # noqa: E402
from repro_torch.sparse import registry  # noqa: E402
from repro_torch.sparse.rgcsr import RGCSR  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.data_parallel import DataParallelTrainer  # noqa: E402
from repro_torch.train.elastic import reshard  # noqa: E402
from repro_torch.train.tensor_parallel import TensorParallelTrainer  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

import quickstart_torch  # noqa: E402
from cg_solver_torch import cg as cg_torch  # noqa: E402
from hand_made_packs import HAND_MADE  # noqa: E402
from param_sets import PARAM_SETS as SET_TUPLES  # noqa: E402
from torch_shard_ranks import rank_spmm  # noqa: E402
from train_lm_torch import sparse_head_eval  # noqa: E402

SEED = 0
D_MODEL, VOCAB = 576, 49152          # src/repro/configs/smollm_135m.py
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12              # H100 SXM, outside the tensor cores
FP64_FLOP_PER_S = 34e12
RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"dtans_spmv": CSRC + "dtans_spmv.cu",
          "dtans_spmm": CSRC + "dtans_spmv.cu",
          "dtans_spmv_shared": CSRC + "dtans_spmv.cu",
          "dtans_spmm_shared": CSRC + "dtans_spmv.cu",
          "dtans_decode": CSRC + "dtans_decode.cu",
          "sell_spmv": CSRC + "sell_spmv.cu",
          "sell_spmm": CSRC + "sell_spmv.cu",
          "rgcsr_spmv": CSRC + "rgcsr_spmv.cu",
          "rgcsr_spmm": CSRC + "rgcsr_spmv.cu",
          "bcsr_spmv": CSRC + "bcsr_spmv.cu",
          "bcsr_spmm": CSRC + "bcsr_spmv.cu"}
REPLACES = {"dtans_spmv": "src/repro/kernels/dtans_spmv.py:134",
            "dtans_spmm": "src/repro/kernels/dtans_spmv.py:210",
            "dtans_spmv_shared": "src/repro/kernels/dtans_spmv.py:117",
            "dtans_spmm_shared": "src/repro/kernels/dtans_spmv.py:189",
            "dtans_decode": "src/repro/kernels/dtans_decode.py:54",
            "sell_spmv": "src/repro/kernels/sell_spmv.py:60",
            "sell_spmm": "src/repro/kernels/sell_spmv.py:96",
            "rgcsr_spmv": "src/repro/kernels/rgcsr_spmv.py:73",
            "rgcsr_spmm": "src/repro/kernels/rgcsr_spmv.py:117",
            "bcsr_spmv": "src/repro/kernels/bcsr_spmv.py:77",
            "bcsr_spmm": "src/repro/kernels/bcsr_spmv.py:111"}
L2_BYTES = 50 * 10**6                # H100 SXM L2 cache
SELL_L, RGCSR_G = (16, 32, 128), (4, 8, 16, 32)   # phase 3 layouts
# Per comparator format: the SpMV / SpMM wrappers, their plain versions,
# the ops entries and the launch counters.
WRAPPERS = {
    "sell": (SE.sell_spmv, SE.sell_spmm, SE.sell_spmv_plain,
             SE.sell_spmm_plain, ops.sell_spmv, ops.sell_spmm, SE.launches),
    "rgcsr": (RG.rgcsr_spmv, RG.rgcsr_spmm, RG.rgcsr_spmv_plain,
              RG.rgcsr_spmm_plain, ops.rgcsr_spmv, ops.rgcsr_spmm,
              RG.launches),
    "bcsr": (BC.bcsr_spmv, BC.bcsr_spmm, BC.bcsr_spmv_plain,
             BC.bcsr_spmm_plain, ops.bcsr_spmv, ops.bcsr_spmm, BC.launches),
}
MODULES = {"sell": SE, "rgcsr": RG, "bcsr": BC}


def comparator_pack(csr: CSR, fmt: str, rows):
    """``csr`` packed as ``fmt``: SELL at slice height ``rows``, RGCSR at
    group size ``rows``, BCSR at block shape ``rows``."""
    if fmt == "sell":
        return SE.pack_sell(csr, rows)
    if fmt == "rgcsr":
        return RG.pack_rgcsr(RGCSR.from_csr(csr, rows))
    return BC.pack_bcsr(BCSR.from_csr(csr, rows))

RESULTS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return (f"{torch.cuda.get_device_name(0)}, power limit "
            f"{RESULTS['device']['power_limit']}")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    RESULTS["device"] = {"name": name, "count": count,
                         "power_limit": smi.split(",")[-1].strip(),
                         "nvidia_smi": smi,
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda}
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 references
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> _build.Build:
    """Every library PAPER runs, one ``nvcc`` each, all started together;
    logs their ptxas lines. Then starts the dtANS sources' builds for the
    other sets of `PARAM_SETS` (phase 4o's), niced, beside phases 3-4n;
    returns that build (`phase_set_build` waits for it)."""
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    RESULTS["build_s"] = secs
    log(f"[build] {sorted(libs)} in {secs:.1f} s")
    for stem in libs:
        text = _build.log_path(stem).read_text() if \
            _build.log_path(stem).exists() else ""
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {stem}: {line.strip()}")
    RESULTS["kernel_registers"] = rows = kernel_registers()
    for r in rows:
        log(f"[build] {r['stem']} {r['kernel']}<{r['type']}, {r['args']}>: "
            f"{r['registers']} registers, spill {r['spill_stores']} B "
            f"stores / {r['spill_loads']} B loads")
    static = K.static_smem_bytes()
    log(f"[build] SpMM static shared memory {static} B "
        f"(tiling.STATIC_SMEM_BYTES = {tiling.STATIC_SMEM_BYTES})")
    if static > tiling.STATIC_SMEM_BYTES:
        raise AssertionError("tiling.STATIC_SMEM_BYTES is below the "
                             "kernel's static shared memory")
    RESULTS["set_build_started_s"] = time.perf_counter() - t0
    return _build.start_build(
        _build.PARAM_SOURCES,
        tuple(p for n, p in PARAM_SETS.items() if n != "PAPER"), nice=19)


def phase_set_build(build: _build.Build) -> None:
    """Waits for the sets' build of `phase_build` (raising if a compile
    failed), then logs each set's most registers and spilled bytes over
    its kernels, and its static shared memory."""
    t0 = time.perf_counter()
    libs = build.wait()
    log(f"[build] {len(libs)} set libraries ready ({time.perf_counter() - t0:.1f} s "
        f"waited): {sorted(libs)}")
    sets = RESULTS["set_registers"] = {}
    for name, p in PARAM_SETS.items():
        for stem in _build.PARAM_SOURCES:
            lines = _build.ptxas(_build.log_path(stem, p).read_text())
            sets[f"{stem}[{name}]"] = {
                "most_registers": max(v[0] for v in lines.values()),
                "spill_bytes": sum(v[2] + v[3] for v in lines.values()),
                "kernels": len(lines)}
        static = K.static_smem_bytes(p)
        assert static <= tiling.STATIC_SMEM_BYTES, (name, static)
    log("[build] per set (most registers / spill stores+loads over its "
        "kernels): " + "; ".join(f"{k} {v['most_registers']} / "
                                f"{v['spill_bytes']} B"
                                for k, v in sets.items()))


_WARP_KERNEL = re.compile(r"spmm_warp_kernelI([fd]).*?ELi(\d+)ELi(\d+)"
                          r"ENS_\d+(StagedX|GlobalX)")
_BCSR_SPMV = re.compile(r"bcsr_spmv_kernelI([fd])Lb([01])")
_LANES_SPMV = re.compile(r"spmv_lanes_kernelI([fd]).*?(SellRow|RgcsrRow)")
_DECODE = re.compile(r"dtans_decode_kernelI([fd])Li(\d+)E")


def _kernel_name(mangled: str) -> tuple | None:
    """(kernel, value type, template arguments) of a padded SpMM, SELL /
    RGCSR SpMV, BCSR SpMV or decode instantiation's mangled name, else
    None."""
    m = _DECODE.search(mangled)
    if m:
        return ("dtans_decode_kernel", m.group(1),
                f"threads<={m.group(2)}")
    m = _WARP_KERNEL.search(mangled)
    if m:
        return ("spmm_warp_kernel", m.group(1),
                f"bw={m.group(2)}, nc={m.group(3)}, {m.group(4)}")
    m = _LANES_SPMV.search(mangled)
    if m:
        return ("spmv_lanes_kernel", m.group(1), m.group(2))
    m = _BCSR_SPMV.search(mangled)
    if m:
        return ("bcsr_spmv_kernel", m.group(1),
                "staged" if m.group(2) == "1" else "L1")
    return None


def kernel_registers() -> list:
    """Registers and spills of every SELL / RGCSR / BCSR SpMM instantiation
    (``spmm_warp_kernel``), SELL / RGCSR SpMV (``spmv_lanes_kernel``), BCSR
    SpMV (``bcsr_spmv_kernel``) and decode (``dtans_decode_kernel``), read
    from the builds' ``-Xptxas -v`` logs."""
    rows = []
    for stem in ("sell_spmv", "rgcsr_spmv", "bcsr_spmv", "dtans_decode"):
        path = _build.log_path(stem)
        text = path.read_text() if path.exists() else ""
        for mangled, (regs, _, stores, loads) in _build.ptxas(text).items():
            cur = _kernel_name(mangled)
            if cur is not None:
                rows.append({
                    "stem": stem, "kernel": cur[0],
                    "type": "float" if cur[1] == "f" else "double",
                    "args": cur[2], "registers": regs,
                    "spill_stores": stores, "spill_loads": loads})
    return rows


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _random_csr(m, n, density, dtype, seed, quantized=False) -> CSR:
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    if quantized:
        d = np.round(d * 2) / 2
    d[rng.random((m, n)) >= density] = 0
    return CSR.from_dense(d)


def _banded_f32(n: int, bw: int) -> CSR:
    rng = np.random.default_rng(7)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        a[i, lo:hi] = rng.standard_normal(hi - lo).astype(np.float32)
    return CSR.from_dense(a)


CASES = [
    # name, matrix factory, lane_width, shared_table
    ("stencil-f64", lambda: stencil_2d(16), 32, True),
    ("stencil-f64-2tab", lambda: stencil_2d(16), 32, False),
    ("banded-f32", lambda: _banded_f32(150, 4), 64, True),
    ("random-f64-escapes", lambda: _random_csr(300, 260, 0.3, np.float64, 2),
     16, True),
    ("random-f32-escapes-2tab",
     lambda: _random_csr(300, 260, 0.3, np.float32, 3), 16, False),
    ("quantized-f32", lambda: _random_csr(120, 80, 0.2, np.float32, 4, True),
     32, True),
    ("tall-skinny", lambda: _random_csr(400, 9, 0.5, np.float64, 5), 128,
     True),
    ("wide", lambda: _random_csr(9, 400, 0.4, np.float64, 6), 8, True),
    ("empty-rows", lambda: CSR.from_dense(
        np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)])), 16, True),
]


def _err(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple:
    """(max abs error, passes): |got - want| <= rtol (|want| + max|want|),
    rtol the reference's (1e-4 f32, 1e-12 f64); the max|want| term is the
    floor for rows whose sum cancels."""
    diff = (got - want).abs()
    scale = want.abs().max().item() if want.numel() else 0.0
    ok = bool((diff <= RTOL[dtype] * (want.abs() + scale)).all().item())
    return (diff.max().item() if diff.numel() else 0.0), ok


def _check_dtans(name: str, a: CSR, mat, rng) -> float:
    """The dtANS kernels on one encoded matrix against their plain versions
    and the dense product; returns the largest |kernel - plain|."""
    pm = pack_matrix(mat)
    dm = to_device(pm, "cuda")
    dt = dm.dtype
    n = a.shape[1]
    x = torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    yk = K.dtans_spmv(dm, x)
    yp = K.dtans_spmv_plain(dm, x)
    torch.cuda.synchronize()
    err, ok = _err(yk, yp, dt)
    dense = torch.as_tensor(a.to_dense(), device="cuda")
    ed, okd = _err(ops.spmv(pm, x), dense @ x, dt)
    assert ok and okd, f"{name}: spmv kernel {err} / dense {ed}"
    worst = err
    # B = 1 through the SpMM kernel and through ops.spmm: bitwise spmv
    assert torch.equal(K.dtans_spmm(dm, x[:, None])[..., 0], yk), \
        f"{name}: spmm kernel at B=1 != spmv kernel"
    assert torch.equal(ops.spmm(pm, x[:, None])[:, 0], ops.spmv(pm, x)), \
        f"{name}: ops.spmm at B=1 != ops.spmv"
    for B in (3, 64):
        X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dt,
                            device="cuda")
        Yk = K.dtans_spmm(dm, X)
        Yp = K.dtans_spmm_plain(dm, X)
        Yt = K.dtans_spmm(dm, X, bn=24)
        torch.cuda.synchronize()
        err, ok = _err(Yk, Yp, dt)
        assert ok, f"{name}: spmm B={B} kernel vs plain {err}"
        assert torch.equal(Yt, Yk), f"{name}: tiled bn=24 != untiled, B={B}"
        worst = max(worst, err)
    _check_decode(name, pm)
    return worst


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _check_decode(name: str, pm) -> None:
    """``ops.decode`` (the kernel) against `decode_ref` (its plain version)
    on the card: columns exactly, values bit for bit."""
    cols, vals = ops.decode(pm)
    want_c, want_v = decode_ref(pm, device="cuda")
    torch.cuda.synchronize()
    assert torch.equal(cols, want_c), f"{name}: decoded columns differ"
    assert torch.equal(_bits(vals), _bits(want_v)), \
        f"{name}: decoded value bits differ"


def _check_fused(name: str, mat, rng) -> None:
    """The fused shared-column kernels on a BCSR-dtANS encode: bitwise
    their plain versions and the generic kernels, tiles and B=1 included,
    and ``ops`` with ``fused=None`` bitwise ``fused=False``."""
    pm = pack_matrix(mat)
    assert pm.shared_cols, f"{name}: BCSR-dtANS pack lacks shared_cols"
    dm = to_device(pm, "cuda")
    n = mat.shape[1]
    x = torch.as_tensor(rng.standard_normal(n), dtype=dm.dtype,
                        device="cuda")
    yk = K.dtans_spmv(dm, x, shared_cols=True)
    assert torch.equal(yk, K.dtans_spmv_plain(dm, x, shared_cols=True)), \
        f"{name}: fused spmv kernel != fused plain"
    assert torch.equal(yk, K.dtans_spmv(dm, x)), \
        f"{name}: fused spmv kernel != generic kernel"
    assert torch.equal(ops.spmv(pm, x), ops.spmv(pm, x, fused=False))
    assert torch.equal(K.dtans_spmm(dm, x[:, None], shared_cols=True)[..., 0],
                       yk), f"{name}: fused spmm at B=1 != fused spmv"
    for B in (3, 64):
        X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dm.dtype,
                            device="cuda")
        Yk = K.dtans_spmm(dm, X, shared_cols=True)
        assert torch.equal(Yk, K.dtans_spmm_plain(dm, X, shared_cols=True)), \
            f"{name}: fused spmm kernel != fused plain, B={B}"
        assert torch.equal(Yk, K.dtans_spmm(dm, X)), \
            f"{name}: fused spmm kernel != generic kernel, B={B}"
        assert torch.equal(K.dtans_spmm(dm, X, bn=24, shared_cols=True), Yk)
        assert torch.equal(ops.spmm(pm, X), ops.spmm(pm, X, fused=False))
    torch.cuda.synchronize()


def _comparator_packs(a: CSR):
    """``a`` in every comparator layout of phase 3: (label, format, pack)."""
    for L in SELL_L:
        yield f"sell L={L}", "sell", comparator_pack(a, "sell", L)
    for G in RGCSR_G:
        yield f"rgcsr G={G}", "rgcsr", comparator_pack(a, "rgcsr", G)
    for bs in BCSR_BLOCK_SHAPES:
        yield (f"bcsr {bs[0]}x{bs[1]}", "bcsr",
               comparator_pack(a, "bcsr", bs))


def _check_comparators(name: str, a: CSR, rng) -> float:
    """SELL, RGCSR and BCSR kernels against their plain versions (bitwise)
    and the dense product; tiles, B=1 and every SpMM column bitwise.
    Returns the largest |kernel - plain|."""
    dense = torch.as_tensor(a.to_dense(), device="cuda")
    n = a.shape[1]
    worst = 0.0
    for label, fmt, pk in _comparator_packs(a):
        spmv, spmm, spmv_plain, spmm_plain, op_spmv, op_spmm, _ = \
            WRAPPERS[fmt]
        dm = MODULES[fmt].to_device(pk, "cuda")
        dt = dm.dtype
        what = f"{name} {label}"
        x = torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
        yk = spmv(dm, x)
        yp = spmv_plain(dm, x)
        err, _ = _err(yk, yp, dt)
        ed, okd = _err(op_spmv(pk, x), dense @ x, dt)
        assert torch.equal(yk, yp) and okd, \
            f"{what}: spmv kernel {err} / dense {ed}"
        worst = max(worst, err)
        assert torch.equal(spmm(dm, x[:, None])[..., 0], yk), \
            f"{what}: spmm kernel at B=1 != spmv kernel"
        assert torch.equal(op_spmm(pk, x[:, None])[:, 0], op_spmv(pk, x)), \
            f"{what}: ops spmm at B=1 != ops spmv"
        for B in (3, 64):
            X = torch.as_tensor(rng.standard_normal((n, B)), dtype=dt,
                                device="cuda")
            Yk = spmm(dm, X)
            Yp = spmm_plain(dm, X)
            err, _ = _err(Yk, Yp, dt)
            ed, okd = _err(op_spmm(pk, X), dense @ X, dt)
            assert torch.equal(Yk, Yp) and okd, \
                f"{what}: spmm B={B} kernel {err} / dense {ed}"
            assert torch.equal(spmm(dm, X, bn=24), Yk), \
                f"{what}: tiled bn=24 != untiled, B={B}"
            for b in range(B):
                yb = spmv(dm, X[:, b].contiguous())
                assert torch.equal(Yk[..., b], yb), \
                    f"{what}: spmm column {b} != spmv, B={B}"
            worst = max(worst, err)
    torch.cuda.synchronize()
    return worst


def _check_hand_made(rng) -> list:
    """The SELL / RGCSR kernels on the hand-made packs
    (`tests/hand_made_packs.py`), f32 and f64, x of 13 and 13,000 rows (the
    SpMM's x slab staged in shared memory, and too large for it: read
    through L1): SpMV and SpMM (B = 3, 40) bitwise their plain versions,
    every SpMM column bitwise the SpMV. Returns the labels checked."""
    labels = []
    for dtype in (np.float32, np.float64):
        for n in (13, 13000):
            for kind, make in HAND_MADE.items():
                fmt = kind.split("-")[0]
                spmv, spmm, spmv_plain, spmm_plain, *_ = WRAPPERS[fmt]
                dm = MODULES[fmt].to_device(make(dtype, n), "cuda")
                what = f"hand-made {kind} {np.dtype(dtype).name} n={n}"
                X = torch.as_tensor(rng.standard_normal((n, 40)),
                                    dtype=dm.dtype, device="cuda")
                cols = [spmv(dm, X[:, b].contiguous()) for b in range(40)]
                assert torch.equal(_bits(cols[0]),
                                   _bits(spmv_plain(dm, X[:, 0]))), \
                    f"{what}: spmv kernel != plain"
                for B in (3, 40):
                    Y = spmm(dm, X[:, :B].contiguous())
                    assert torch.equal(_bits(Y), _bits(spmm_plain(
                        dm, X[:, :B]))), f"{what}: spmm B={B} != plain"
                    for b in range(B):
                        assert torch.equal(_bits(Y[..., b]),
                                           _bits(cols[b])), \
                            f"{what}: spmm column {b} != spmv"
                labels.append(what)
    torch.cuda.synchronize()
    return labels


def phase_kernels() -> None:
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for name, factory, lw, shared in CASES:
        a = factory()
        mat = encode_matrix(a, lane_width=lw, shared_table=shared)
        worst = _check_dtans(name, a, mat, rng)
        worst_cmp = _check_comparators(name, a, rng)
        esc = int(mat.esc_count_by_domain.sum())
        dt = "float64" if a.values.dtype == np.float64 else "float32"
        rows.append({"case": name, "lane_width": lw, "dtype": dt,
                     "tables": len(mat.tables), "escapes": esc,
                     "max_abs_err": worst, "comparators_max_abs_err":
                     worst_cmp})
        log(f"[kernels] {name:24s} L={lw:3d} {dt:7s} T={len(mat.tables)} "
            f"esc={esc:6d} max|k-plain| dtans={worst:.3e} "
            f"sell/rgcsr={worst_cmp:.3e} ok")
    hand = _check_hand_made(rng)
    rows.append({"case": "hand-made sell / rgcsr packs", "packs": hand,
                 "bitwise": True})
    log(f"[kernels] {len(hand)} hand-made SELL / RGCSR packs (-1 holes, "
        f"deltas past the count, int32 sums past 2^31; n = 13 and "
        f"13,000): spmv, spmm and every spmm column bitwise plain")
    for name, a, G in (
            ("rgcsr-dtans stencil6 G=8", stencil_2d(6), 8),
            ("rgcsr-dtans random-f32 G=16",
             _random_csr(300, 260, 0.3, np.float32, 3), 16)):
        worst = _check_dtans(name, a, encode_rgcsr_matrix(a, group_size=G),
                             rng)
        rows.append({"case": name, "lane_width": G, "max_abs_err": worst})
        log(f"[kernels] {name:28s} max|k-plain|={worst:.3e} ok")
    for name, factory, _, shared in CASES:
        a = factory()
        for bs in ((2, 2), (4, 4), (40, 2)):
            what = f"bcsr-dtans {name} {bs[0]}x{bs[1]}"
            mat = encode_bcsr_matrix(a, block_shape=bs, shared_table=shared)
            worst = _check_dtans(what, a, mat, rng)
            _check_fused(what, mat, rng)
            rows.append({"case": what, "lane_width": bs[0],
                         "max_abs_err": worst, "fused_bitwise": True})
            log(f"[kernels] {what:36s} max|k-plain|={worst:.3e}, fused "
                f"bitwise plain and generic ok")
    RESULTS["kernel_cases"] = rows
    phase_sweep()


# The lane widths of the sweep: packed narrow slices (1 to 32 lanes, several
# slices a warp), one warp, and slices over 2 to 32 warps (SpMM takes up to
# `tiling.MAX_SPMM_LANE_WIDTH`).
SWEEP_L = (1, 3, 4, 8, 31, 32, 33, 40, 64, 100, 128, 256, 1024)


def _sweep_csr(L: int, kind: str, seed: int) -> CSR:
    """A matrix of 1.5 slices of L rows (at least 600 rows), 160 columns and
    0 to 23 nonzeros a row (so the lanes of a slice end at different
    segments, some rows are empty), about 7,000 to 18,500 nonzeros:
    ``quant`` f32 quantized to 2^-16 (more levels than a table's 4096
    slots: escapes at many positions), ``f64`` random doubles (the same),
    ``base256`` f32 of two values in runs (table base 256)."""
    rng = np.random.default_rng(seed)
    m, n = max(L + L // 2 + 1, 600), 160
    lens = rng.integers(0, 24, size=m)
    indptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    if kind == "base256":
        starts = rng.integers(0, n - 24, size=m)
        indices = np.concatenate([s0 + np.arange(k)
                                  for s0, k in zip(starts, lens)])
        values = np.where(np.arange(indptr[-1]) % 7 == 0, -1.0, 1.0)
    else:
        indices = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                                  for k in lens])
        values = rng.standard_normal(indptr[-1]) * 2
        if kind == "quant":
            values = np.round(values * 65536) / 65536
    dtype = np.float64 if kind == "f64" else np.float32
    return CSR(indptr, indices.astype(np.int32), values.astype(dtype),
               (m, n))


def _check_sweep(label: str, pm, rng) -> None:
    """One sweep matrix: SpMV, SpMM, tiles, B=1, ``pipeline`` and decode,
    kernel vs plain bitwise."""
    dm = to_device(pm, "cuda")
    n = pm.shape[1]
    X = torch.as_tensor(rng.standard_normal((n, 7)), dtype=dm.dtype,
                        device="cuda")
    x = X[:, 0].contiguous()
    y = K.dtans_spmv(dm, x)
    assert torch.equal(y, K.dtans_spmv_plain(dm, x)), f"{label}: spmv"
    assert torch.equal(ops.spmv(pm, x, pipeline=True), ops.spmv(pm, x)), \
        f"{label}: spmv pipeline"
    if pm.lane_width <= tiling.MAX_SPMM_LANE_WIDTH:
        Y = K.dtans_spmm(dm, X)
        assert torch.equal(Y, K.dtans_spmm_plain(dm, X)), f"{label}: spmm"
        assert torch.equal(K.dtans_spmm(dm, X, bn=3), Y), f"{label}: bn=3"
        assert torch.equal(K.dtans_spmm(dm, X[:, :1].contiguous())[..., 0],
                           y), f"{label}: spmm B=1 != spmv"
        assert torch.equal(ops.spmm(pm, X, pipeline=True), ops.spmm(pm, X)), \
            f"{label}: spmm pipeline"
    else:
        try:
            K.dtans_spmm(dm, X)
        except ValueError as exc:
            assert "lane widths up to" in str(exc), exc
        else:
            raise AssertionError(f"{label}: spmm took L={pm.lane_width}")
    _check_c1(label, pm, dm, X, rng)
    _check_decode(label, pm)
    torch.cuda.synchronize()


def _check_c1(label: str, pm, dm, X: torch.Tensor, rng) -> None:
    """What the SpMM kernel refuses and ``ops.spmm`` serves, bitwise the
    plain SpMM: a lane width past `tiling.MAX_SPMM_LANE_WIDTH` (one SpMV
    launch a column, each counted) and, at L = 128, an explicit tile of
    400 columns, wider than a block's shared memory holds (cut to
    `tiling.dtans_widest_bn`)."""
    m, n = pm.shape
    if tiling.spmm_by_columns(pm.lane_width):
        before = K.launches["dtans_spmv"]
        got = ops.spmm(pm, X)
        assert K.launches["dtans_spmv"] - before == X.shape[1], label
    elif pm.lane_width == 128:
        X = torch.as_tensor(rng.standard_normal((n, 400)), dtype=dm.dtype,
                            device="cuda")
        got = ops.spmm(pm, X, bn=400)
    else:
        return
    want = K.dtans_spmm_plain(dm, X).reshape(-1, X.shape[1])[:m]
    assert torch.equal(got, want), f"{label}: ops.spmm != plain SpMM (C1)"


def phase_sweep() -> None:
    rng = np.random.default_rng(SEED + 5)
    rows, seen_esc, seen_256 = [], 0, 0
    for L in SWEEP_L:
        for kind, shared in (("quant", True), ("f64", False),
                             ("base256", True)):
            a = _sweep_csr(L, kind, L)
            mat = encode_matrix(a, lane_width=L, shared_table=shared)
            pm = pack_matrix(mat)
            esc = int(mat.esc_count_by_domain.sum())
            base = int(pm.tab_base.max())
            label = f"sweep L={L} {kind}"
            _check_sweep(label, pm, rng)
            seen_esc = max(seen_esc, esc)
            seen_256 += base == 256
            rows.append({"case": label, "nnz": a.nnz, "tables":
                         len(mat.tables), "escapes": esc, "max_base": base,
                         "bitwise": True})
        log(f"[sweep] L={L:4d}: quant / f64 2-table / base-256 matrices, "
            f"spmv, spmm, bn=3, B=1, pipeline and decode bitwise plain"
            + ("; ops.spmm by columns bitwise plain"
               if tiling.spmm_by_columns(L) else "")
            + ("; ops.spmm bn=400 cut to fit, bitwise plain"
               if L == 128 else ""))
    assert seen_esc > 1000 and seen_256 > 0, (seen_esc, seen_256)
    RESULTS["sweep_cases"] = rows


# ---------------------------------------------------------------------------
# 4. the main path at full width
# ---------------------------------------------------------------------------

REQUESTS = [
    # name, input shape, bn
    ("decode-step", (4, 1, D_MODEL), None),
    ("B=1", (1, D_MODEL), None),
    ("B=8", (8, D_MODEL), None),
    ("B=64", (64, D_MODEL), None),
    ("B=512 bn=64", (512, D_MODEL), 64),
]


def phase_main_path() -> SparseLinear:
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    t0 = time.perf_counter()
    sl = SparseLinear.from_dense(w, sparsity=0.8, value_bits=8,
                                 lane_width=128, shared_table=True,
                                 device="cuda")
    enc_s = time.perf_counter() - t0
    pm = sl.packed
    RESULTS["head"] = {
        "d_in": sl.d_in, "d_out": sl.d_out, "nnz": sl.mat.nnz,
        "encode_s": enc_s, "compressed_bytes": sl.compressed_bytes,
        "dense_bytes": sl.dense_bytes, "baseline_bytes": sl.baseline_bytes,
        "compression_vs_dense": sl.compression_vs_dense,
        "compression_vs_best_sparse": sl.compression_vs_best_sparse,
        "slices": pm.n_slices, "max_nseg": pm.max_nseg,
        "stream_words": int(sl.mat.stream.size),
        "escapes": int(sl.mat.esc_count_by_domain.sum()),
        "max_table_base": int(pm.tab_base.max()),
    }
    log(f"[main] head W^T {VOCAB}x{D_MODEL} f32, nnz {sl.mat.nnz}, encode "
        f"{enc_s:.1f} s, {sl.compressed_bytes} B compressed: "
        f"{sl.compression_vs_dense:.3f}x vs dense, "
        f"{sl.compression_vs_best_sparse:.3f}x vs best sparse "
        f"({sl.baseline_bytes} B); S={pm.n_slices} "
        f"max_nseg={pm.max_nseg} max base={int(pm.tab_base.max())}")

    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda") for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    ys = [sl.apply(x, bn=bn) for x, (_, _, bn) in zip(xs, REQUESTS)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = dict(K.launches)
    log(f"[main] served {len(REQUESTS)} requests in {serve_s * 1e3:.1f} ms "
        f"(first calls included); launches {counts}")
    assert counts["dtans_spmv"] > 0 and counts["dtans_spmm"] > 0, counts
    RESULTS["launches"] = counts

    dm = to_device(pm, "cuda")
    errs = {"dtans_spmv": 0.0, "dtans_spmm": 0.0}
    rels = dict(errs)
    for (name, shape, bn), x, y in zip(REQUESTS, xs, ys):
        assert y.shape == (*shape[:-1], VOCAB) and torch.isfinite(y).all()
        ref = sl.apply_dense_reference(x)
        xb = x.reshape(-1, D_MODEL)
        B = xb.shape[0]
        if B == 1:
            plain = K.dtans_spmv_plain(dm, xb[0]).reshape(-1)[:VOCAB, None]
            kern = "dtans_spmv"
        else:
            plain = K.dtans_spmm_plain(dm, xb.T.contiguous(), bn).reshape(
                -1, B)[:VOCAB]
            kern = "dtans_spmm"
        plain = plain.T.reshape(y.shape)
        torch.cuda.synchronize()
        ok_ref = torch.allclose(y, ref, rtol=1e-4, atol=1e-5)
        e_plain, ok_plain = _err(y, plain, torch.float32)
        e_ref = (y - ref).abs().max().item()
        errs[kern] = max(errs[kern], e_plain)
        rels[kern] = max(rels[kern], e_plain / max(
            plain.abs().max().item(), 1e-30))
        log(f"[main] {name:12s} out {tuple(y.shape)} |y-dense|={e_ref:.3e} "
            f"|y-plain|={e_plain:.3e}")
        assert ok_ref and ok_plain, f"{name}: dense {e_ref} plain {e_plain}"
    RESULTS["main_max_abs_err"] = errs
    RESULTS["main_max_rel_err"] = rels
    return sl


# ---------------------------------------------------------------------------
# 4b. the comparator path at full width
# ---------------------------------------------------------------------------

# The head's comparator layouts: SELL at the format registry's slice height,
# RGCSR at its default group and at a warp-sized group, BCSR at the
# registry's default block shape.
HEAD_PACKS = (("sell L=32", "sell", 32), ("rgcsr G=4", "rgcsr", 4),
              ("rgcsr G=32", "rgcsr", 32), ("bcsr 2x2", "bcsr", (2, 2)))


def _work(csr: CSR, fmt: str, rows, pk) -> tuple[int, int]:
    """(bytes, stored cells) one pass needs, padding not counted: the real
    entries' index and value bytes, plus SELL's per-row stops and RGCSR's
    per-row counts (S * L or S * G of them); for BCSR each stored block's
    4-byte column and r * c values, fill-in included, plus its
    per-block-row stops (S of them)."""
    item = csr.values.dtype.itemsize
    if fmt == "bcsr":
        r, c = rows
        n_blocks = int((pk.block_cols >= 0).sum())
        return (n_blocks * (4 + r * c * item) + pk.block_cols.shape[0] * 4,
                n_blocks * r * c)
    return (csr.nnz * (4 + item) + -(-csr.shape[0] // rows) * rows * 4,
            csr.nnz)


def phase_comparators(sl: SparseLinear) -> tuple[CSR, dict]:
    """Serves the request shapes through the comparator ops on the head's
    own pruned matrix; returns the CSR and the packs by label."""
    t0 = time.perf_counter()
    csr = decode_matrix(sl.mat)
    packs = {}
    for label, fmt, rows in HEAD_PACKS:
        pk = comparator_pack(csr, fmt, rows)
        packs[label] = (fmt, rows, pk, MODULES[fmt].to_device(pk, "cuda"))
    pack_s = time.perf_counter() - t0
    wg = next(iter(packs.values()))[3].values.shape[1]
    log(f"[cmp] head CSR nnz {csr.nnz}, longest row {wg}; packed and "
        f"uploaded in {pack_s:.1f} s")
    sizes = {}
    for label, (fmt, rows, pk, dm) in packs.items():
        real, cells = _work(csr, fmt, rows, pk)
        width = int(dm.values.shape[1])     # padded positions a row
        sizes[label] = {"stored_bytes": dm.nbytes, "real_bytes": real,
                        "cells": cells, "row_positions": width}
        log(f"[cmp] {label:10s} stored {dm.nbytes} B on the card (padded "
            f"to {width} positions a row), {real} B exact for {cells} "
            f"cells, vs {sl.compressed_bytes} B for the dtANS head; "
            f"{_l2_note(dm.nbytes)}")
    RESULTS["comparator_packs"] = sizes

    rng = np.random.default_rng(SEED + 3)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda").reshape(-1, D_MODEL).T.contiguous()
          for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    for mod in MODULES.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    ys = {label: [WRAPPERS[fmt][5](pk, X, bn=bn)
                  for X, (_, _, bn) in zip(xs, REQUESTS)]
          for label, (fmt, _, pk, _) in packs.items()}
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = {k: v for mod in MODULES.values()
              for k, v in mod.launches.items()}
    log(f"[cmp] served {len(REQUESTS)} request shapes x {len(packs)} packs "
        f"in {serve_s * 1e3:.1f} ms; launches {counts}")
    assert all(v > 0 for v in counts.values()), counts
    RESULTS["launches"].update(counts)

    errs = {k: 0.0 for k in counts}
    rels = dict(errs)
    w_dense = sl.dense_weight
    for label, (fmt, _, _, dm) in packs.items():
        _, _, spmv_plain, spmm_plain, *_ = WRAPPERS[fmt]
        for (name, _, bn), X, y in zip(REQUESTS, xs, ys[label]):
            B = X.shape[1]
            assert y.shape == (VOCAB, B) and torch.isfinite(y).all()
            if B == 1:
                plain = spmv_plain(dm, X[:, 0]).reshape(-1)[:VOCAB, None]
                kern = f"{fmt}_spmv"
            else:
                plain = spmm_plain(dm, X, bn).reshape(-1, B)[:VOCAB]
                kern = f"{fmt}_spmm"
            e_dense, ok_dense = _err(y, w_dense @ X, torch.float32)
            e_plain, ok_plain = _err(y, plain, torch.float32)
            errs[kern] = max(errs[kern], e_plain)
            rels[kern] = max(rels[kern], e_plain / max(
                plain.abs().max().item(), 1e-30))
            log(f"[cmp] {label:10s} {name:12s} |y-dense|={e_dense:.3e} "
                f"|y-plain|={e_plain:.3e}")
            assert ok_dense and torch.equal(y, plain), \
                f"{label} {name}: dense {e_dense} plain {e_plain}"
    RESULTS["main_max_abs_err"].update(errs)
    RESULTS["main_max_rel_err"].update(rels)
    return csr, packs


def _l2_note(nbytes: int) -> str:
    fits = nbytes <= L2_BYTES
    return (f"{'fits' if fits else 'exceeds'} the 50 MB L2, so warm repeats "
            f"{'stay in L2' if fits else 're-read HBM'}")


# ---------------------------------------------------------------------------
# 4c. the blocked path at full width
# ---------------------------------------------------------------------------

BLOCK = (4, 4)           # structured pruning in 4x4 tiles
BLOCK_DENSITY = 0.2      # 1 - the head's sparsity 0.8
# The weights' scale: phase 4's head draws std 0.02 (a trained LM head's
# scale), so the two phases' outputs, and the absolute floor of the check
# against the dense product, are on one scale.
WEIGHT_STD = 0.02


def blocked_host() -> dict:
    """4c's host work, from `SEED` alone: the head's shape pruned in 4x4
    tiles (weights of std `WEIGHT_STD`), codebook-quantized as
    `from_dense` does (``q``), encoded as BCSR-dtANS 4x4 (``mat``) and
    decoded again by the host decoder (``filled``), which walks the
    12,288 slices one by one (~100-250 s on the card's host), with both
    times. `main` runs it in a process of its own from the start, beside
    phases 2-4b (at module level: the process imports this script by
    name)."""
    t0 = time.perf_counter()
    tiles = block_sparse(
        VOCAB // BLOCK[0], D_MODEL // BLOCK[1], BLOCK, density=BLOCK_DENSITY,
        rng=np.random.default_rng(SEED), dtype=np.float32)
    q = codebook_quantize(CSR(tiles.indptr, tiles.indices,
                              tiles.values * np.float32(WEIGHT_STD),
                              tiles.shape), bits=8)
    mat = encode_bcsr_matrix(q, block_shape=BLOCK)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    filled = decode_matrix(mat)
    return {"q": q, "mat": mat, "filled": filled, "encode_s": enc_s,
            "host_decode_s": time.perf_counter() - t0}


def phase_blocked(host: dict | None = None) -> dict:
    """The head's shape pruned in 4x4 tiles, encoded as BCSR-dtANS 4x4
    and decoded on the host (`blocked_host`: ``host`` where `main` ran it
    beside the earlier phases) and served by a `SparseLinear` through the
    fused shared-column kernels; the same matrix through ``fused=False``
    and as BCSR 4x4."""
    host = host or blocked_host()
    q, mat, filled = host["q"], host["mat"], host["filled"]
    enc_s, host_decode_s = host["encode_s"], host["host_decode_s"]
    sl = SparseLinear(mat=mat, packed=pack_matrix(mat), d_in=D_MODEL,
                      d_out=VOCAB, dense_bytes=VOCAB * D_MODEL * 4,
                      baseline_bytes=best_baseline_nbytes(q)[1],
                      device=torch.device("cuda"))
    pm = sl.packed
    dm = to_device(pm, "cuda")
    assert pm.shared_cols and pm.lane_width == BLOCK[0]
    # decoded once, for `apply_dense_reference` (the cached
    # `dense_weight` it would decode itself) and for phase 4d
    sl.dense_weight = torch.from_numpy(filled.to_dense()).to(sl.device)
    pb = comparator_pack(q, "bcsr", BLOCK)
    db = BC.to_device(pb, "cuda")
    bcsr_bytes, cells = _work(q, "bcsr", BLOCK, pb)
    RESULTS["blocked"] = {
        "nnz": q.nnz, "n_blocks": mat.n_blocks, "encode_s": enc_s,
        "host_decode_s": host_decode_s,
        "compressed_bytes": sl.compressed_bytes,
        "compression_vs_dense": sl.compression_vs_dense,
        "compression_vs_best_sparse": sl.compression_vs_best_sparse,
        "slices": pm.n_slices, "max_nseg": pm.max_nseg,
        "escapes": int(mat.esc_count_by_domain.sum()),
        "bcsr_exact_bytes": bcsr_bytes, "bcsr_stored_bytes": db.nbytes,
        "bcsr_slots": int(pb.values.shape[1])}
    log(f"[blk] W^T {VOCAB}x{D_MODEL} f32 in {BLOCK[0]}x{BLOCK[1]} tiles, "
        f"nnz {q.nnz} ({mat.n_blocks} blocks), BCSR-dtANS encode "
        f"{enc_s:.1f} s: {sl.compressed_bytes} B, "
        f"{sl.compression_vs_dense:.3f}x vs dense, "
        f"{sl.compression_vs_best_sparse:.3f}x vs best sparse; S="
        f"{pm.n_slices} L={pm.lane_width} max_nseg={pm.max_nseg}; host "
        f"decode_matrix {host_decode_s:.1f} s")
    log(f"[blk] BCSR {BLOCK[0]}x{BLOCK[1]}: {bcsr_bytes} B exact, "
        f"{db.nbytes} B on the card ({pb.values.shape[1]} slots a block "
        f"row); {_l2_note(db.nbytes)}")

    rng = np.random.default_rng(SEED + 4)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda") for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    ys = [sl.apply(x, bn=bn) for x, (_, _, bn) in zip(xs, REQUESTS)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = dict(K.launches)
    log(f"[blk] served {len(REQUESTS)} requests in {serve_s * 1e3:.1f} ms "
        f"(first calls included); launches {counts}")
    assert counts["dtans_spmv_shared"] > 0 and \
        counts["dtans_spmm_shared"] > 0, counts
    assert counts["dtans_spmv"] == 0 and counts["dtans_spmm"] == 0, counts
    RESULTS["launches"].update(
        {k: counts[k] for k in ("dtans_spmv_shared", "dtans_spmm_shared")})

    Xs = [x.reshape(-1, D_MODEL).T.contiguous() for x in xs]
    BC.reset_launches()
    yb = [ops.bcsr_spmm(pb, X, bn=bn) for X, (_, _, bn) in zip(Xs, REQUESTS)]
    torch.cuda.synchronize()
    counts = dict(BC.launches)
    log(f"[blk] the same requests as BCSR {BLOCK[0]}x{BLOCK[1]}: launches "
        f"{counts}")
    assert all(v > 0 for v in counts.values()), counts
    RESULTS["launches"].update(counts)

    errs = {k: 0.0 for k in ("dtans_spmv_shared", "dtans_spmm_shared",
                             "bcsr_spmv", "bcsr_spmm")}
    rels = dict(errs)
    w_dense = sl.dense_weight
    for (name, shape, bn), x, X, y, y_b in zip(REQUESTS, xs, Xs, ys, yb):
        B = X.shape[1]
        assert y.shape == (*shape[:-1], VOCAB) and torch.isfinite(y).all()
        ref = sl.apply_dense_reference(x)
        ok_ref = torch.allclose(y, ref, rtol=1e-4, atol=1e-5)
        e_ref = (y - ref).abs().max().item()
        fused = ops.spmm(pm, X, bn=bn)
        generic = ops.spmm(pm, X, bn=bn, fused=False)
        assert torch.equal(fused, generic), f"{name}: fused != fused=False"
        assert torch.equal(y, fused.T.reshape(y.shape)), \
            f"{name}: apply != ops.spmm"
        if B == 1:
            plain = K.dtans_spmv_plain(dm, X[:, 0], shared_cols=True)
            plain_b = BC.bcsr_spmv_plain(db, X[:, 0])
            kind = "spmv"
        else:
            plain = K.dtans_spmm_plain(dm, X, bn, shared_cols=True)
            plain_b = BC.bcsr_spmm_plain(db, X, bn)
            kind = "spmm"
        plain = plain.reshape(-1, B)[:VOCAB]
        plain_b = plain_b.reshape(-1, B)[:VOCAB]
        torch.cuda.synchronize()
        for kern, got, want in ((f"dtans_{kind}_shared", fused, plain),
                                (f"bcsr_{kind}", y_b, plain_b)):
            e_plain, _ = _err(got, want, torch.float32)
            errs[kern] = max(errs[kern], e_plain)
            rels[kern] = max(rels[kern], e_plain / max(
                want.abs().max().item(), 1e-30))
            assert torch.equal(got, want), f"{name}: {kern} != plain"
        e_b, ok_b = _err(y_b, w_dense @ X, torch.float32)
        log(f"[blk] {name:12s} out {tuple(y.shape)} |y-dense|={e_ref:.3e} "
            f"fused == plain == fused=False bitwise; BCSR |y-dense|="
            f"{e_b:.3e}, == plain bitwise")
        assert ok_ref and ok_b, f"{name}: dense {e_ref} / BCSR {e_b}"
    RESULTS["main_max_abs_err"].update(errs)
    RESULTS["main_max_rel_err"].update(rels)
    return {"sl": sl, "q": q, "pb": pb, "db": db, "filled": filled}


# ---------------------------------------------------------------------------
# 4d. decode
# ---------------------------------------------------------------------------

def phase_decode(sl: SparseLinear, csr: CSR, blk: dict) -> None:
    """``ops.decode`` of the head and of the blocked matrix: columns and
    value bits equal to `decode_ref`, real entries exactly the host's
    `decode_matrix`."""
    mats = {"dtans L=128": (sl, csr),
            "bcsr-dtans 4x4": (blk["sl"], blk["filled"])}
    torch.cuda.synchronize()
    DD.reset_launches()
    outs = {label: ops.decode(s.packed) for label, (s, _) in mats.items()}
    torch.cuda.synchronize()
    counts = dict(DD.launches)
    log(f"[dec] decoded {len(outs)} matrices; launches {counts}")
    assert counts["dtans_decode"] > 0, counts
    RESULTS["launches"].update(counts)
    sizes = {}
    for label, (s, host) in mats.items():
        cols, vals = outs[label]
        want_c, want_v = decode_ref(s.packed, device="cuda")
        assert torch.equal(cols, want_c), f"{label}: columns != decode_ref"
        assert torch.equal(_bits(vals), _bits(want_v)), \
            f"{label}: value bits != decode_ref"
        m = s.mat.shape[0]
        c = cols.reshape(-1, cols.shape[-1])[:m]
        v = vals.reshape(-1, vals.shape[-1])[:m]
        real = c >= 0
        indptr = torch.as_tensor(host.indptr, device="cuda")
        assert torch.equal(real.sum(dim=1), indptr.diff()), \
            f"{label}: real entries per row != decode_matrix"
        assert torch.equal(c[real].long(),
                           torch.as_tensor(host.indices, device="cuda")), \
            f"{label}: columns != decode_matrix"
        assert torch.equal(_bits(v[real]), _bits(torch.as_tensor(
            host.values, device="cuda"))), f"{label}: values != decode_matrix"
        nbytes = cols.nbytes + vals.nbytes
        sizes[label] = {"shape": list(cols.shape), "out_bytes": nbytes}
        log(f"[dec] {label:14s} out {tuple(cols.shape)} int32 + "
            f"{str(vals.dtype).replace('torch.', '')}, {nbytes} B: == "
            f"decode_ref bitwise, real entries == decode_matrix")
    RESULTS["main_max_abs_err"]["dtans_decode"] = 0.0
    RESULTS["main_max_rel_err"]["dtans_decode"] = 0.0
    RESULTS["decode"] = sizes


# ---------------------------------------------------------------------------
# 4e. the autotuned head
# ---------------------------------------------------------------------------

AUTO_BATCH = 64     # a batched serving step: SpMM passes of 0.15-0.5 ms
AUTO_BUDGET = 2     # candidates encoded at full width and timed
# The `H100` model's band: modeled over measured time of a pass (C5).
MODEL_BAND = (0.5, 2.0)


def _all_launches() -> dict:
    return {k: v for mod in (K, SE, RG, BC, DD) for k, v in
            mod.launches.items()}


def _reset_all() -> None:
    for mod in (K, SE, RG, BC, DD):
        mod.reset_launches()


def phase_autotuned(sl: SparseLinear) -> SparseLinear:
    """The head's weight (phase 4's draw) built by ``from_dense(auto=True,
    autotune_measure=True)`` on the `H100` model: the selection times the
    top candidates' CUDA kernels (a CUDA graph of each, between CUDA
    events) at B=`AUTO_BATCH`, and the ranking is checked again on phase
    5's timer; the winner serves the request shapes. Each output is held against the
    dense product of the head's pruned weight (phase 4's layer: every
    family codes that same matrix losslessly; a host decode of a
    narrow-slice winner would take minutes) and, bitwise, the winner's
    plain path on the card."""
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    auto = SparseLinear.from_dense(
        w, sparsity=0.8, value_bits=8, auto=True,
        autotune_budget=AUTO_BUDGET, autotune_measure=True,
        autotune_batch=AUTO_BATCH, autotune_cache=DecisionCache(path=None),
        autotune_machine=H100, device="cuda")
    torch.cuda.synchronize()
    select_s = time.perf_counter() - t0
    sel_counts = {k: v for k, v in _all_launches().items() if v}
    d = auto.decision
    log(f"[auto] from_dense(auto=True, budget={AUTO_BUDGET}, measure, "
        f"B={AUTO_BATCH}, H100 model) in {select_s:.1f} s (encodes "
        f"included): {d.config_name}, {d.nbytes} B, modeled "
        f"{d.modeled_time * 1e3:.4f} ms, measured "
        f"{d.measured_time * 1e3:.4f} ms | {card()}")
    for cfg, nbytes, modeled, measured in d.leaderboard:
        meas = "-" if measured is None else f"{measured * 1e3:.4f} ms"
        log(f"[auto]   {cfg:26s} {nbytes:9d} B modeled "
            f"{modeled * 1e3:.4f} ms measured {meas}")
    log(f"[auto] selection launches {sel_counts}")
    assert d.machine == "h100" and d.batch == AUTO_BATCH and d.refined
    assert d.measured_time is not None and d.measured_time > 0
    assert sum(row[3] is not None for row in d.leaderboard) == AUTO_BUDGET
    assert sel_counts, "the measured selection launched no kernel"
    # The `H100` model (C5) against the selection's own timings.
    band = {cfg: modeled / measured
            for cfg, _, modeled, measured in d.leaderboard
            if measured is not None}
    for cfg, q in band.items():
        log(f"[auto]   modeled / measured {cfg:26s} {q:.3f} (B="
            f"{AUTO_BATCH}) | {card()}")
    assert all(MODEL_BAND[0] <= q <= MODEL_BAND[1] for q in band.values()), \
        f"the H100 model is off its 2x band on the head: {band}"
    # Phase 4's configuration in the same harness and currency (a CUDA
    # graph of the call, as `select` timed the candidates).
    X = torch.as_tensor(np.random.default_rng(SEED + 7).standard_normal(
        (D_MODEL, AUTO_BATCH)), dtype=torch.float32, device="cuda")
    t_phase4 = measure.time_kernel(
        registry.get_format("dtans").spmm_runner(sl.packed, X,
                                                 device="cuda"),
        device="cuda")
    log(f"[auto] phase 4's dtans[w=128,shared] in the same harness: "
        f"{t_phase4 * 1e3:.4f} ms (IQR {t_phase4.iqr * 1e3:.4f} ms) | "
        f"{card()}")
    # The ranking on kernel time alone, timed as phase 5 times (`device_ms`:
    # 5 replays of a 20-call graph): winner, runner-up (encoded again; the
    # selection's artifacts stay inside `from_dense`) and phase 4's pack.
    pruned = codebook_quantize(magnitude_prune(w.T, 0.8), bits=8)
    up_spec, up_knobs = registry.parse_config(d.leaderboard[1][0])
    t0 = time.perf_counter()
    up_packed = up_spec.pack(pruned, **up_knobs)
    up_encode_s = time.perf_counter() - t0
    packs = {d.config_name: (registry.get_format(d.fmt), auto.packed),
             d.leaderboard[1][0]: (up_spec, up_packed),
             "phase 4 dtans[w=128,shared]": (registry.get_format("dtans"),
                                             sl.packed)}
    graph = {}
    for name, (spec, packed) in packs.items():
        t = device_ms(spec.spmm_runner(packed, X, device="cuda"))
        assert t["by"] == "graph", (name, t["by"])
        graph[name] = t["ms"]
        log(f"[auto]   graph-timed {name:28s} {t['ms']:.4f} ms "
            f"(runs {', '.join(f'{r:.4f}' for r in t['runs'])}) | {card()}")
    names = list(graph)
    holds = graph[names[0]] <= graph[names[1]]
    gap = graph[names[1]] / graph[names[0]] - 1.0
    log(f"[auto] the measured ranking {'holds' if holds else 'flips'} on "
        f"kernel time: {names[0]} {graph[names[0]]:.4f} ms vs "
        f"{names[1]} {graph[names[1]]:.4f} ms (runner-up {gap:+.2%}; "
        f"encoded again in {up_encode_s:.1f} s)")
    choices = _modeled_choices(pruned, d, t_phase4, packs)
    shared = bool(auto.packed.shared_cols)
    # (a BCSR-dtANS winner codes the block-filled matrix: more entries)
    assert shared or (auto.mat.nnz == sl.mat.nnz and np.array_equal(
        auto.mat.row_nnz, sl.mat.row_nnz)), "not the head's pruned matrix"

    kinds = ("dtans_spmv_shared", "dtans_spmm_shared") if shared else \
        ("dtans_spmv", "dtans_spmm")
    rng = np.random.default_rng(SEED + 5)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device="cuda") for _, shape, _ in REQUESTS]
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    ys = [auto.apply(x, bn=bn) for x, (_, _, bn) in zip(xs, REQUESTS)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = {k: v for k, v in _all_launches().items() if v}
    log(f"[auto] served {len(REQUESTS)} requests in {serve_s * 1e3:.1f} ms "
        f"(first calls included); launches {counts}")
    assert all(counts.get(k, 0) > 0 for k in kinds), counts

    dm = to_device(auto.packed, "cuda")
    same_as_4 = d.config_name == "dtans[w=128,shared]"
    for (name, shape, bn), x, y in zip(REQUESTS, xs, ys):
        assert y.shape == (*shape[:-1], VOCAB) and torch.isfinite(y).all()
        xb = x.reshape(-1, D_MODEL)
        B = xb.shape[0]
        if B == 1:
            plain = K.dtans_spmv_plain(dm, xb[0], shared_cols=shared)
        else:
            plain = K.dtans_spmm_plain(dm, xb.T.contiguous(), bn,
                                       shared_cols=shared)
        plain = plain.reshape(-1, B)[:VOCAB].T.reshape(y.shape)
        ref = sl.apply_dense_reference(x)
        torch.cuda.synchronize()
        ok_ref = torch.allclose(y, ref, rtol=1e-4, atol=1e-5)
        e_ref = (y - ref).abs().max().item()
        log(f"[auto] {name:12s} out {tuple(y.shape)} |y-dense|={e_ref:.3e}, "
            f"== plain bitwise")
        assert ok_ref, f"{name}: dense {e_ref}"
        assert torch.equal(y, plain), f"{name}: kernel != plain"
        if same_as_4:
            assert torch.equal(y, sl.apply(x, bn=bn)), \
                f"{name}: not bitwise phase 4's output"
    if same_as_4:
        log("[auto] the winner is phase 4's configuration: outputs "
            "bitwise phase 4's")
    RESULTS["autotune"] = {
        "decision": d.to_dict(), "config": d.config_name,
        "select_s": select_s, "serve_s": serve_s,
        "phase4_config_measured_s": float(t_phase4),
        "graph_ms": graph, "ranking_holds_on_graph": holds,
        "runner_up_gap_on_graph": gap, "modeled_over_measured": band,
        "budget0": choices,
        "launches_selection": sel_counts, "launches_serving": counts}
    return auto


def _modeled_choices(pruned: CSR, d, t_phase4, packs: dict) -> dict:
    """`choose_dtans_config(budget=0)` on the head (estimates, no encode)
    at B=1 and at B=`AUTO_BATCH`, against the configurations measured
    here: at B=`AUTO_BATCH` the selection's timings (winner, runner-up)
    and phase 4's; at B=1 the same three packs, timed now (`time_kernel`,
    as `select` times). A choice among none of them is not measured."""
    x1 = torch.as_tensor(np.random.default_rng(SEED + 8).standard_normal(
        D_MODEL), dtype=torch.float32, device="cuda")
    phase4 = "dtans[w=128,shared]"
    measured = {1: {}, AUTO_BATCH: {cfg: t for cfg, _, _, t in
                                    d.leaderboard if t is not None}}
    measured[AUTO_BATCH].setdefault(phase4, float(t_phase4))
    for name, (spec, packed) in packs.items():
        cfg = phase4 if name.startswith("phase 4") else name
        measured[1][cfg] = float(measure.time_kernel(
            spec.runner(packed, x1, device="cuda"), device="cuda"))
    out = {}
    for B, times in measured.items():
        pick = choose_dtans_config(pruned, budget=0, batch=B,
                                   cache=DecisionCache(path=None))
        best = min(times, key=times.get)
        t = times.get(pick.config_name)
        regret = None if t is None else t / times[best] - 1.0
        out[B] = {"choice": pick.config_name, "measured": times,
                  "fastest": best, "regret": regret}
        log(f"[auto] budget=0 at B={B}: {pick.config_name} "
            + ("(not among the measured)" if t is None else
               f"{t * 1e3:.4f} ms") + f"; fastest measured {best} "
            f"{times[best] * 1e3:.4f} ms"
            + ("" if regret is None else f" ({regret:+.2%})")
            + f" | {card()}")
    return out


# ---------------------------------------------------------------------------
# 4f. the registry and calibration on the card
# ---------------------------------------------------------------------------

REGISTRY_MATRICES = ("nn", "skew")   # of `measure._calibration_suite`
REGISTRY_BATCHES = (1, 8)


def _plain_rows(spec, packed, X: torch.Tensor) -> torch.Tensor:
    """The plain torch version, on the card, of the kernel a registry
    runner of ``spec`` launches on ``packed``: (m, B) rows of A X."""
    d = spec.upload(packed, "cuda")
    B = X.shape[1]
    if spec.decodes:
        shared = bool(packed.shared_cols)
        rows = (K.dtans_spmv_plain(d, X[:, 0], shared_cols=shared)
                if B == 1 else
                K.dtans_spmm_plain(d, X, None, shared_cols=shared))
    else:
        mod = MODULES[spec.name]
        rows = (getattr(mod, f"{spec.name}_spmv_plain")(d, X[:, 0])
                if B == 1 else
                getattr(mod, f"{spec.name}_spmm_plain")(d, X, None))
    return rows.reshape(-1, B)[:d.shape[0]]


def phase_registry() -> None:
    """Every registered format's ``FormatSpec.spmv`` / ``spmm`` runners
    (B = 1, 8) on two calibration matrices on the card: the kernel-backed
    ones bitwise their plain versions, csr / coo / dense within `RTOL` of
    the dense product; then ``measure.calibrate(base=H100, small=True)``
    times the calibration configurations' runners on its five matrices
    (CUDA graphs between CUDA events) and the `H100` model prices each
    pass within `MODEL_BAND` of its time."""
    mats = measure._calibration_suite(small=True)
    rng = np.random.default_rng(SEED + 6)
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    checked = 0
    for mname in REGISTRY_MATRICES:
        a = mats[mname]
        dense = torch.as_tensor(a.to_dense(), device="cuda")
        arts: dict = {}
        for fmt in registry.format_names():
            spec = registry.get_format(fmt)
            packed = spec.pack(a, artifacts=arts)
            for B in REGISTRY_BATCHES:
                X = torch.as_tensor(rng.standard_normal((a.shape[1], B)),
                                    dtype=torch.float32, device="cuda")
                y = (spec.runner(packed, X[:, 0], device="cuda")()[:, None]
                     if B == 1 else
                     spec.spmm_runner(packed, X, device="cuda")())
                assert y.shape == (a.shape[0], B) and y.device == X.device, \
                    (fmt, B)
                if spec.spmv_fn is not None:
                    assert torch.equal(y, _plain_rows(spec, packed, X)), \
                        f"{mname} {fmt} B={B}: kernel != plain"
                else:
                    e, ok = _err(y, dense @ X, torch.float32)
                    assert ok, f"{mname} {fmt} B={B}: |y-dense| {e}"
                checked += 1
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    counts = {k: v for k, v in _all_launches().items() if v}
    log(f"[reg] {checked} registry passes ({len(registry.format_names())} "
        f"formats x {REGISTRY_MATRICES} x B {REGISTRY_BATCHES}) in "
        f"{reg_s:.1f} s: kernels bitwise plain, csr / coo / dense within "
        f"rtol of the dense product; launches {counts}")
    want = {k for k in _all_launches() if k != "dtans_decode"}
    assert want <= set(counts), sorted(want - set(counts))

    _reset_all()
    t0 = time.perf_counter()
    res = measure.calibrate(base=H100, small=True, device="cuda")
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    cal_counts = {k: v for k, v in _all_launches().items() if v}
    # The adopted `H100` (C5) against the runners' timings: each pass's
    # price under it (`modeled_before`) over its measured time.
    band = [(p.matrix, p.config_name, p.batch, p.modeled_before / p.measured)
            for p in res.points]
    log(f"[cal] the H100 model against {len(res.points)} runner timings "
        f"(`calibrate(base=H100, small=True)`, {cal_s:.1f} s): modeled / "
        f"measured {min(q for *_, q in band):.3f} .. "
        f"{max(q for *_, q in band):.3f}, mean |error| "
        f"{res.err_before:.3f}; launches {cal_counts} | {card()}")
    for mname, cfg, B, q in band:
        log(f"[cal]   {mname:7s} {cfg:26s} B={B:<2d} {q:.3f}")
    assert all(p.measured > 0 for p in res.points)
    assert cal_counts, "calibration launched no kernel"
    off = [row for row in band if not MODEL_BAND[0] <= row[3] <= MODEL_BAND[1]]
    assert not off, f"the H100 model is off its 2x band: {off}"
    RESULTS["registry"] = {"passes": checked, "seconds": reg_s,
                           "launches": counts}
    RESULTS["calibration"] = {**res.to_dict(), "seconds": cal_s,
                              "launches": cal_counts,
                              "model": H100.to_dict()}


# ---------------------------------------------------------------------------
# 4g. the serving engine at full width
# ---------------------------------------------------------------------------

ENGINE_PROMPTS = (1, 3, 7, 12, 5, 2, 9, 16)   # prompt lengths
ENGINE_MAX_NEW, ENGINE_SLOTS, ENGINE_MAX_SEQ = 8, 4, 64
STEP_REPS = 50     # pooled steps timed by CUDA events, per head


def _smollm(w: np.ndarray):
    """SmolLM-135M at full width in float32, layer weights from a
    generator seeded `SEED`, the tied embedding set to phase 4's ``w.T``
    (std 0.02, `embedding_init`'s scale), so that phase 4's layer is this
    model's compressed head with no new encode."""
    cfg = configs.get("smollm-135m").with_(dtype="float32")
    assert (cfg.d_model, cfg.vocab, cfg.tie_embeddings) == \
        (D_MODEL, VOCAB, True)
    model = api.build_model(
        cfg, generator=torch.Generator().manual_seed(SEED), device="cuda")
    with torch.no_grad():
        model.embed.tok.copy_(torch.as_tensor(w.T, device="cuda"))
    return model


def _serve_engine(model, head, slots: int, prompts: list, max_seq: int,
                  record=None) -> tuple:
    """(engine, requests, seconds) of serving ``prompts`` to the end;
    ``record`` sees each step's (hidden, logits) of a compressed head."""
    eng = Engine(model, slots=slots, max_seq=max_seq,
                 sparse_head=head, metrics=obs.MetricsRegistry(),
                 device="cuda")
    if record is not None:
        def head_fn(hidden, run=eng._head):
            y = run(hidden)
            record.append((hidden.clone(), y.clone()))
            return y
        eng._head = head_fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, ENGINE_MAX_NEW) for p in prompts]
    eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def _engine_stats(eng, reqs, secs: float) -> dict:
    h = eng.metrics.histogram
    toks = sum(len(r.out) for r in reqs)
    return {"seconds": secs, "tokens": toks, "tokens_per_s": toks / secs,
            "steps": eng.metrics.counter("engine.steps_total").value,
            "decode_ms_p50": h("engine.decode_s").quantile(0.5) * 1e3,
            "step_ms_p50": h("engine.step_s").quantile(0.5) * 1e3,
            "ttft_ms_p50": h("engine.ttft_s").quantile(0.5) * 1e3,
            "prefill_ms_p50": h("engine.prefill_s").quantile(0.5) * 1e3}


def _spread(ms: list) -> dict:
    q = np.percentile(ms, [10, 50, 90])
    return {"p10": float(q[0]), "p50": float(q[1]), "p90": float(q[2])}


def _graph_nodes(fn) -> dict | None:
    """The nodes of a CUDA graph of one call of ``fn``, by type: the
    launches that call makes (counted by the driver's `cuGraphGetNodes`
    and `cuGraphNodeGetType`); None where capture or the count fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            fn()
        cu = ctypes.CDLL("libcuda.so.1")
        graph = ctypes.c_void_p(g.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
            raise RuntimeError("cuGraphGetNodes failed")
        kinds: dict = {}
        for node in nodes:
            t = ctypes.c_int(-1)
            cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
            kind = {0: "kernel", 1: "memcpy", 2: "memset"}.get(t.value,
                                                                "other")
            kinds[kind] = kinds.get(kind, 0) + 1
    except (RuntimeError, OSError, TypeError, AttributeError) as exc:
        log(f"[engine] graph nodes not counted "
            f"({str(exc).splitlines()[0][:100]})")
        return None
    return {"total": n.value, **kinds}


def _step_split(model, heads: dict, prompts: list, max_seq: int) -> dict:
    """Pooled steps of ``ENGINE_SLOTS`` live requests, the heads of
    ``heads`` taking turns step by step, each step split by CUDA events
    around `decode_hidden` and around the head and ending in the engine's
    one host copy of the logits (`STEP_REPS` steps a head after 2 rounds
    of warm-up; the 10th, 50th and 90th percentiles of each part). Beside
    them each part's device time alone (a CUDA graph of it, `_graph_runs`;
    None where capture fails) and its launches (`_graph_nodes`)."""
    eng = Engine(model, slots=ENGINE_SLOTS, max_seq=max_seq,
                 metrics=obs.MetricsRegistry(), device="cuda")
    for p in prompts[:ENGINE_SLOTS]:
        eng.submit(p, ENGINE_MAX_NEW)
    runs = {name: {"model_ms": [], "head_ms": [], "wall_ms": []}
            for name in heads}
    with torch.inference_mode():
        eng._fill_slots()
        toks = torch.as_tensor([[int(r.prompt[-1])] for r in eng.active],
                               device="cuda")
        pos = torch.as_tensor(eng.pos, device="cuda")
        for rep in range(STEP_REPS + 2):
            for name, head_fn in heads.items():
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                t0 = time.perf_counter()
                ev[0].record()
                hidden, _ = model.decode_hidden(eng.cache, toks, pos)
                ev[1].record()
                logits = head_fn(hidden)
                ev[2].record()
                logits.cpu()
                if rep >= 2:
                    r = runs[name]
                    r["wall_ms"].append((time.perf_counter() - t0) * 1e3)
                    r["model_ms"].append(ev[0].elapsed_time(ev[1]))
                    r["head_ms"].append(ev[1].elapsed_time(ev[2]))

        def step():
            return model.decode_hidden(eng.cache, toks, pos)
        graph_model = _graph_runs(step)
        out = {"model_graph_ms": (statistics.median(graph_model)
                                  if graph_model else None),
               "model_nodes": _graph_nodes(step), "heads": {}}
        for name, head_fn in heads.items():
            graph_head = _graph_runs(lambda: head_fn(hidden))
            out["heads"][name] = {
                **{k: _spread(v) for k, v in runs[name].items()},
                "head_graph_ms": (statistics.median(graph_head)
                                  if graph_head else None),
                "head_nodes": _graph_nodes(lambda: head_fn(hidden))}
    return out


def _serve_and_check(tag: str, model, head: SparseLinear, prompts: list,
                     max_seq: int = ENGINE_MAX_SEQ) -> dict:
    """Serve ``prompts`` through ``model`` with the compressed ``head``:
    pooled (``slots=4``, the head's SpMM kernel) and sequential
    (``slots=1``, its SpMV kernel), token for token the same, each
    engine's launches counted from 0 and each a decode step's one head
    launch; one pooled step's logits against the decoded head and,
    bitwise, the plain path; then a dense-head engine on the same
    requests (no kernel launched), and both engines' step times split
    between the model and the head. Every engine has ``max_seq``. Logs
    under ``tag``; returns the numbers."""
    d, vocab = model.cfg.d_model, model.cfg.vocab
    _serve_engine(model, head, ENGINE_SLOTS, prompts[:2], max_seq)  # warm-up

    seen: list = []
    _reset_all()
    pooled, preqs, psecs = _serve_engine(model, head, ENGINE_SLOTS, prompts,
                                         max_seq, record=seen)
    pooled_counts = {k: v for k, v in _all_launches().items() if v}
    _reset_all()
    seq, sreqs, ssecs = _serve_engine(model, head, 1, prompts, max_seq)
    seq_counts = {k: v for k, v in _all_launches().items() if v}
    _reset_all()
    dense, dreqs, dsecs = _serve_engine(model, None, ENGINE_SLOTS, prompts,
                                        max_seq)
    dense_counts = {k: v for k, v in _all_launches().items() if v}
    stats = {"compressed": _engine_stats(pooled, preqs, psecs),
             "sequential": _engine_stats(seq, sreqs, ssecs),
             "dense": _engine_stats(dense, dreqs, dsecs)}
    log(f"[{tag}] launches: pooled {pooled_counts}, sequential "
        f"{seq_counts}, dense head {dense_counts}")
    assert all(r.done and len(r.out) == ENGINE_MAX_NEW
               for r in preqs + sreqs + dreqs)
    assert pooled_counts == {"dtans_spmm": stats["compressed"]["steps"]}, \
        pooled_counts
    assert seq_counts == {"dtans_spmv": stats["sequential"]["steps"]}, \
        seq_counts
    assert dense_counts == {}, dense_counts
    for p, s in zip(preqs, sreqs):
        assert p.out == s.out, (f"prompt of {len(p.prompt)}: pooled "
                                f"{p.out} != sequential {s.out}")
    agree = sum(p.out == d.out for p, d in zip(preqs, dreqs))
    log(f"[{tag}] {len(preqs)} requests x {ENGINE_MAX_NEW} tokens: pooled "
        f"== sequential token for token; the dense head's streams agree on "
        f"{agree} of {len(preqs)} requests (the compressed head is pruned)")

    hidden, logits = seen[0]
    assert hidden.shape == (ENGINE_SLOTS, 1, d)
    assert logits.shape == (ENGINE_SLOTS, 1, vocab)
    assert torch.isfinite(logits).all()
    ref = head.apply_dense_reference(hidden)
    dm = to_device(head.packed, "cuda")
    plain = K.dtans_spmm_plain(dm, hidden.reshape(-1, d).T.contiguous(),
                               None).reshape(-1, ENGINE_SLOTS)[:vocab]
    plain = plain.T.reshape(logits.shape)
    torch.cuda.synchronize()
    e_ref = (logits - ref).abs().max().item()
    assert torch.allclose(logits, ref, rtol=1e-4, atol=1e-5), e_ref
    assert torch.equal(logits, plain), "pooled logits != plain path"
    log(f"[{tag}] first pooled step: |logits - decoded head| = {e_ref:.3e} "
        f"(rtol 1e-4, atol 1e-5), bitwise the plain path")

    split = _step_split(model, {
        "compressed": head.apply,
        "dense": lambda h: layers.lm_head(model.embed, h)}, prompts,
        max_seq)
    for name in ("compressed", "dense", "sequential"):
        s = stats[name]
        log(f"[{tag}] {name:10s} one run of {len(prompts)} requests "
            f"(smoke reading): {s['tokens']} tokens in "
            f"{s['seconds']:.3f} s = {s['tokens_per_s']:.1f} tok/s, "
            f"{s['steps']} steps; median decode {s['decode_ms_p50']:.3f} ms, "
            f"step {s['step_ms_p50']:.3f} ms, TTFT {s['ttft_ms_p50']:.3f} ms, "
            f"prefill {s['prefill_ms_p50']:.3f} ms | {card()}")

    def pct(d):
        return f"{d['p50']:.4f} [{d['p10']:.4f}, {d['p90']:.4f}]"
    g = split["model_graph_ms"]
    log(f"[{tag}] model's pooled step alone (CUDA graph): "
        f"{'not measured' if g is None else f'{g:.4f} ms'}, graph nodes "
        f"{split['model_nodes'] or 'not counted'} | {card()}")
    for name, s in split["heads"].items():
        gh = s["head_graph_ms"]
        log(f"[{tag}] {name:10s} {STEP_REPS} pooled steps, heads taking "
            f"turns, ms p50 [p10, p90] (events): model {pct(s['model_ms'])}"
            f" + head {pct(s['head_ms'])}, head "
            f"{s['head_ms']['p50'] / (s['model_ms']['p50'] + s['head_ms']['p50']):.1%}"
            f"; wall {pct(s['wall_ms'])}; head alone (graph): "
            f"{'not measured' if gh is None else f'{gh:.4f} ms'}, nodes "
            f"{s['head_nodes'] or 'not counted'} | {card()}")
    return {"stats": stats, "split": split, "dense_agree": agree,
            "logits_max_abs_err": e_ref,
            "launches": {"pooled": pooled_counts, "sequential": seq_counts},
            "streams": [[int(t) for t in r.out] for r in preqs]}


def _engine_launches(run: dict) -> dict:
    """Every kernel's launches in a phase's pooled and sequential runs."""
    c = run["launches"]
    return {k: c["pooled"].get(k, 0) + c["sequential"].get(k, 0)
            for k in _all_launches()}


def phase_engine(sl: SparseLinear) -> tuple:
    """SmolLM-135M at full width serves `ENGINE_PROMPTS` through the
    port's `Engine` with phase 4's layer as its compressed head
    (`_serve_and_check`). Returns the model, the prompts and the pooled
    engine's token streams, for phase 4i."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    t0 = time.perf_counter()
    model = _smollm(w)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[engine] SmolLM-135M full width ({model.cfg.n_layers} layers, "
        f"d_model {D_MODEL}, {model.cfg.n_heads}/{model.cfg.n_kv_heads} "
        f"heads, d_ff {model.cfg.d_ff}, vocab {VOCAB}, tied), "
        f"{api.param_count(model):,} parameters, built in {build_s:.1f} s; "
        f"dtype float32 in place of the config's bfloat16 (the head is "
        f"f32, and the token-identity check needs f32 without TF32)")
    prng = np.random.default_rng(SEED + 7)
    prompts = [prng.integers(0, VOCAB, size=n) for n in ENGINE_PROMPTS]
    run = _serve_and_check("engine", model, sl, prompts)
    RESULTS["engine"] = {"build_s": build_s, **run}
    RESULTS["launches_engine"] = _engine_launches(run)
    return model, prompts, run["streams"]


# ---------------------------------------------------------------------------
# 4h. the ssm family at full width
# ---------------------------------------------------------------------------

# 4g's prompts with the last one 301 tokens long: its 300-token prefill is
# two chunks of 256, the second padded, so the scan carries a state across
# chunks at the real widths
SSM_PROMPTS = ENGINE_PROMPTS[:-1] + (301,)
SSM_MAX_SEQ = 320
SSM_LONG_REL = 1e-3   # chunked vs token-by-token, of the largest |logit|


def _mamba2(device="cuda"):
    """mamba2-130m at full width in float32 (nothing cut), weights from a
    generator seeded `SEED` (drawn on the host, so the same on any
    device)."""
    cfg = configs.get("mamba2-130m").with_(dtype="float32")
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width, cfg.ssm_chunk,
            cfg.vocab, cfg.tie_embeddings, cfg.attn_every) == \
        (24, 768, 1536, 24, 64, 128, 4, 256, 50280, True, 0), cfg
    return api.build_model(
        cfg, generator=torch.Generator().manual_seed(SEED), device=device)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def ssm_head_host() -> dict:
    """4h's host work, from `SEED` alone: mamba2-130m built on the host
    (`_mamba2`) and its tied head compressed by `Engine.compress_lm_head`
    there, with a digest of the head's weights. `main` runs it in a process
    of its own beside phases 2-4c; `phase_engine_ssm` checks the digest
    against the card's model and moves the layer there
    (`SparseLinear.to`)."""
    model = _mamba2("cpu")
    t0 = time.perf_counter()
    head = Engine.compress_lm_head(model, device="cpu")
    return {"head": head, "encode_s": time.perf_counter() - t0,
            "digest": _digest(model.embed.head_weight())}


def _long_prefill(model, prompt: np.ndarray) -> dict:
    """The chunked prefill of ``prompt`` (several chunks, the last padded)
    against the single-token recurrence over the same tokens: the last
    position's logits must agree to within `SSM_LONG_REL` of their largest
    |logit|, with the same argmax. Also times the prefill (CUDA events,
    median of 5 after a warm-up)."""
    S = len(prompt)
    toks = torch.as_tensor(prompt[None], device="cuda")
    with torch.inference_mode():
        want, _, _ = model.prefill({"inputs": toks})
        _, cache, _ = model.prefill({"inputs": toks[:, :1]})
        for t in range(1, S):
            got, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        top = want.abs().max().item()
        err = (got - want).abs().max().item()
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        ms = []
        for rep in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            model.prefill({"inputs": toks})
            ev[1].record()
            torch.cuda.synchronize()
            if rep:
                ms.append(ev[0].elapsed_time(ev[1]))
    chunk = min(model.cfg.ssm_chunk, S)
    assert err <= SSM_LONG_REL * top and same, (err, top, same)
    log(f"[ssm] prefill of {S} tokens ({-(-S // chunk)} chunks of {chunk}, "
        f"{(-S) % chunk} padded) against {S - 1} single-token steps: "
        f"|logits diff| {err:.3e} = {err / top:.2e} of max |logit| "
        f"{top:.3f} (limit {SSM_LONG_REL:g}), argmax equal; prefill "
        f"{statistics.median(ms):.3f} ms (median of 5, events) | {card()}")
    return {"tokens": S, "max_abs_err": err, "max_abs_logit": top,
            "prefill_ms": statistics.median(ms), "prefill_runs_ms": ms}


def phase_engine_ssm(host: dict) -> None:
    """mamba2-130m at full width (attention-free) serves `SSM_PROMPTS`
    through the port's `Engine` with its tied head compressed by
    `Engine.compress_lm_head` at `from_dense`'s defaults (``host``: the
    head `ssm_head_host` compressed on the host, moved to the card by
    `SparseLinear.to`; `_serve_and_check`); its longest prompt's chunked
    prefill is held against the recurrence (`_long_prefill`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = _mamba2()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    log(f"[ssm] mamba2-130m full width ({cfg.n_layers} SSM layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
        f"{cfg.ssm_headdim}, state {cfg.ssm_state}, conv {cfg.conv_width}, "
        f"chunk {cfg.ssm_chunk}, vocab {cfg.vocab}, tied), "
        f"{api.param_count(model):,} parameters, built in {build_s:.1f} s; "
        f"dtype float32 in place of the config's bfloat16")
    assert host["digest"] == _digest(model.embed.head_weight()), \
        "the host's mamba2-130m head differs from the card's"
    head = host["head"].to("cuda")
    encode_s = host["encode_s"]
    dense_mb = cfg.vocab * cfg.d_model * 4 / 1e6
    log(f"[ssm] head W^T {cfg.vocab}x{cfg.d_model} f32 "
        f"({dense_mb:.1f} MB dense, {_l2_note(cfg.vocab * cfg.d_model * 4)})"
        f" -> nnz {head.mat.nnz:,}, {head.compressed_bytes:,} B "
        f"({head.compression_vs_dense:.2f}x vs dense, "
        f"{_l2_note(head.compressed_bytes)}); compress_lm_head "
        f"{encode_s:.1f} s on the host (beside phases 2-4c)")
    prng = np.random.default_rng(SEED + 7)
    prompts = [prng.integers(0, cfg.vocab, size=n) for n in SSM_PROMPTS]
    run = _serve_and_check("ssm", model, head, prompts, SSM_MAX_SEQ)
    long = _long_prefill(model, prompts[-1][:-1])
    RESULTS["engine_ssm"] = {"build_s": build_s, "encode_s": encode_s,
                             "long_prefill": long,
                             "nnz": head.mat.nnz,
                             "compressed_bytes": head.compressed_bytes,
                             **run}
    RESULTS["launches_engine_ssm"] = _engine_launches(run)


# ---------------------------------------------------------------------------
# 4i. the row-sharded head
# ---------------------------------------------------------------------------

HEAD_SHARDS = 4
SHARD_BATCHES = (1, 4, 64, 512)
SHARD_RANK_BATCHES = (1, 64)      # the head's collective passes
SHARD_MATRIX = "random-f32-escapes-2tab"   # of phase 3's `CASES`
SHARD_REPS = 5                    # timed collective passes a rank


def _format_jobs(k: int, rng) -> list:
    """(name, host plan, x, single-device y) of every registered format's
    ``k``-shard plan of the phase-3 matrix `SHARD_MATRIX` at its default
    knobs, B = 8; y from the format's own runner on the card."""
    a = dict((c[0], c[1]) for c in CASES)[SHARD_MATRIX]()
    jobs = []
    for fmt in registry.format_names():
        spec = registry.get_format(fmt)
        x = rng.standard_normal((a.shape[1], 8)).astype(np.float32)
        want = spec.spmm_runner(spec.pack(a), x, device="cuda")()
        jobs.append((fmt, shard_ops.host_plan(spec.shard(a, k)), x,
                     want.cpu().numpy()))
    return jobs


def _check_ranks(tag: str, ranks: list, jobs: list) -> dict:
    """Every rank's result of every job against the job's truth: bitwise
    for the formats with a shard adapter (each rank uploading its own shard
    and no other); csr / coo / dense, which run the loop on every rank,
    within `RTOL` (their CUDA stand-ins add in no fixed order). Returns the
    formats whose results were bitwise."""
    bitwise = {}
    for i, (fmt, plan, _, want) in enumerate(jobs):
        adapter = shard_ops.supports_shard_map(plan)
        same = True
        for r, res in enumerate(ranks):
            got = res[i]
            same &= bool(np.array_equal(got["y"], want))
            if adapter:
                assert got["uploaded"] == [j == r and rows > 0 for j, rows
                                           in enumerate(plan.shard_rows)], \
                    (tag, fmt, r, got["uploaded"])
                assert np.array_equal(got["y"], want), (tag, fmt, r)
            else:
                assert not any(got["uploaded"]), (tag, fmt, r)
                e, ok = _err(torch.as_tensor(got["y"]),
                             torch.as_tensor(want), torch.float32)
                assert ok, (tag, fmt, r, e)
        bitwise[fmt] = same
    return bitwise


def shard_host() -> dict:
    """4i's host work, from `SEED` alone: phase 4's weights built into a
    `HEAD_SHARDS`-shard layer by ``SparseLinear.from_dense`` on the host
    (its shards encoded, uploaded to the host), timed. `main` runs it
    beside phases 2-4c; `phase_shard` moves the layer to the card
    (`SparseLinear.to`)."""
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    t0 = time.perf_counter()
    sh = SparseLinear.from_dense(w, sparsity=0.8, value_bits=8,
                                 lane_width=128, shared_table=True,
                                 n_shards=HEAD_SHARDS, device="cpu")
    return {"sh": sh, "encode_s": time.perf_counter() - t0}


def phase_shard(sl: SparseLinear, model, prompts: list, streams: list,
                host: dict) -> None:
    """Phase 4's head built by ``SparseLinear.from_dense(n_shards=4)``: the
    per-shard loop serves the phase-4 batch sizes bitwise phase 4's layer
    (one launch a shard a pass) and phase 4g's requests through the pooled
    engine (4g's token streams; the step captured in a CUDA graph); then
    the same plan on 4 gloo ranks on this one card, each uploading its own
    shard, bitwise the loop path; then every registered format's plan of a
    phase-3 matrix on 2 and 4 ranks against its single-device runner.
    ``host``: the layer `shard_host` built on the host beside the earlier
    phases, moved to the card by `SparseLinear.to`."""
    sh = host["sh"].to("cuda")
    enc_s = host["encode_s"]
    plan = sh.plan
    slices = [p.n_slices for p in plan.shards]
    assert sh.mat is None, "the sharded layer encoded the whole head"
    assert sum(int(p.nnz.sum()) for p in plan.shards) == sl.mat.nnz
    assert sum(slices) == sl.packed.n_slices
    log(f"[shard] head W^T {VOCAB}x{D_MODEL} f32 in {HEAD_SHARDS} row "
        f"shards of {plan.shard_rows} rows ({slices} slices of 128), "
        f"{plan.shard_nbytes} B ({plan.total_nbytes} B in all, "
        f"{sl.compressed_bytes} B unsharded); from_dense {enc_s:.1f} s on "
        f"the host (the shards encoded, not the whole head; beside phases "
        f"2-4c)")

    # the main path of this slice: the loop, through the layer and the
    # engine, counts from 0
    xrng = np.random.default_rng(SEED + 9)
    xs = {B: torch.as_tensor(xrng.standard_normal((B, D_MODEL)),
                             dtype=torch.float32, device="cuda")
          for B in SHARD_BATCHES}
    torch.cuda.synchronize()
    _reset_all()
    ys = {B: sh.apply(x) for B, x in xs.items()}
    torch.cuda.synchronize()
    apply_counts = {k: v for k, v in _all_launches().items() if v}
    _reset_all()
    eng, reqs, secs = _serve_engine(model, sh, ENGINE_SLOTS, prompts,
                                    ENGINE_MAX_SEQ)
    engine_counts = {k: v for k, v in _all_launches().items() if v}
    steps = eng.metrics.counter("engine.steps_total").value
    log(f"[shard] launches: apply at B {SHARD_BATCHES} {apply_counts}; "
        f"pooled engine, {steps} steps, {engine_counts}")
    assert apply_counts == {"dtans_spmv": HEAD_SHARDS,
                            "dtans_spmm": HEAD_SHARDS * 3}, apply_counts
    assert engine_counts == {"dtans_spmm": HEAD_SHARDS * steps}, \
        engine_counts
    got_streams = [[int(t) for t in r.out] for r in reqs]
    assert got_streams == streams, "sharded head's streams != phase 4g's"
    for B, x in xs.items():
        assert torch.equal(ys[B], sl.apply(x)), f"B={B}: sharded != phase 4"
    log(f"[shard] loop path bitwise phase 4's layer at B {SHARD_BATCHES}; "
        f"{len(reqs)} requests through the pooled engine give phase 4g's "
        f"token streams ({secs:.2f} s)")

    # the step captured whole: nothing on the path reads back to the host
    graphs = _step_graphs(model, {"sharded": sh, "single": sl}, prompts)
    log(f"[shard] pooled step (B={ENGINE_SLOTS}) as one CUDA graph, "
        f"decode_hidden + sharded head: {graphs['step_ms']:.4f} ms; head "
        f"alone (graph): " + ", ".join(
            f"{name} {g['head_ms']:.4f} ms, nodes {g['nodes']}"
            for name, g in graphs["heads"].items()) + f" | {card()}")

    # times: the sharded head beside phase 4's, on the same inputs; CUDA
    # graphs at every B (the loop's host work is not the card's), the
    # events of a Python loop beside them at B > 1, as phase 5 times B2
    times = {}
    for B in SHARD_BATCHES:
        X = xs[B].T.contiguous()
        calls = {"sharded": lambda: shard_ops.shard_spmm(plan, X,
                                                         device="cuda"),
                 "single": lambda: ops.spmm(sl.packed, X, device="cuda")}
        t = {}
        for name, fn in calls.items():
            g = device_ms(fn)
            t[f"{name}_ms"], t[f"{name}_by"] = g["ms"], g["by"]
            if B > 1:
                t[f"{name}_events_ms"] = time_ms(fn, 20)
        times[B] = t
        ev = (f"; events {t['sharded_events_ms']:.4f} vs "
              f"{t['single_events_ms']:.4f} ms" if B > 1 else "")
        log(f"[shard] B={B:3d} {HEAD_SHARDS} launches over {slices[0]} "
            f"slices each: {t['sharded_ms']:.4f} ms; phase 4's one launch "
            f"over {sl.packed.n_slices} slices: {t['single_ms']:.4f} ms; "
            f"ratio {t['sharded_ms'] / t['single_ms']:.2f} ({t['sharded_by']}"
            f"){ev} | {card()}")

    # the collective path: 4 gloo ranks on this card (NCCL refuses two
    # ranks on one GPU), each uploading only its own shard
    frng = np.random.default_rng(SEED + 10)
    head_jobs = []
    for B in SHARD_RANK_BATCHES:
        X = xs[B].T.contiguous()
        head_jobs.append((f"head B={B}", shard_ops.host_plan(plan),
                          X.cpu().numpy(),
                          shard_ops.shard_spmm(plan, X, device="cuda").cpu().numpy()))
    fmt4 = _format_jobs(4, frng)
    fmt2 = _format_jobs(2, frng)
    t0 = time.perf_counter()
    ranks = spawn(4, rank_spmm,
                  [(p, x) for _, p, x, _ in head_jobs + fmt4], "cuda",
                  SHARD_REPS, device_type="cuda")
    spawn4_s = time.perf_counter() - t0
    _check_ranks("head", [r[:len(head_jobs)] for r in ranks], head_jobs)
    bit4 = _check_ranks("4 ranks", [r[len(head_jobs):] for r in ranks],
                        fmt4)
    t0 = time.perf_counter()
    ranks2 = spawn(2, rank_spmm, [(p, x) for _, p, x, _ in fmt2],
                   "cuda", 0, device_type="cuda")
    spawn2_s = time.perf_counter() - t0
    bit2 = _check_ranks("2 ranks", ranks2, fmt2)
    coll = {}
    for i, (name, *_rest) in enumerate(head_jobs):
        ms = [r[i]["ms_p50"] for r in ranks]
        coll[name] = {"rank_ms_p50": ms, "ms": ms[0]}
        log(f"[shard] collective {name}: 4 gloo ranks on one card, each "
            f"its own shard (bitwise the loop path on every rank); wall "
            f"{ms[0]:.3f} ms a pass on rank 0 (median of {SHARD_REPS}; "
            f"ranks {', '.join(f'{v:.3f}' for v in ms)}), broadcast of x "
            f"and all-reduce of the {VOCAB}-row result staged through the "
            f"host by gloo | {card()}")
    log(f"[shard] {len(fmt4)} formats' plans of {SHARD_MATRIX} on 4 and 2 "
        f"ranks: adapter families bitwise their single-device runners, "
        f"each rank its own shard; csr / coo / dense (the loop on every "
        f"rank) within rtol, bitwise at 4 / 2 ranks: "
        f"{ {f: (bit4[f], bit2[f]) for f in bit4} }; spawns {spawn4_s:.1f} "
        f"s (4 ranks) and {spawn2_s:.1f} s (2 ranks)")
    RESULTS["shard"] = {
        "encode_s": enc_s, "shard_rows": plan.shard_rows,
        "shard_slices": slices, "shard_nbytes": plan.shard_nbytes,
        "launches_apply": apply_counts, "launches_engine": engine_counts,
        "engine_steps": steps, "engine_s": secs, "times": times,
        "graphs": graphs, "collective": coll,
        "bitwise_formats": {"4": bit4, "2": bit2},
        "spawn_s": {"4": spawn4_s, "2": spawn2_s}}
    RESULTS["launches_shard"] = {
        k: apply_counts.get(k, 0) + engine_counts.get(k, 0)
        for k in _all_launches()}


def _step_graphs(model, heads: dict, prompts: list) -> dict:
    """A pooled step of ``ENGINE_SLOTS`` live requests as CUDA graphs: the
    first head of ``heads`` with `decode_hidden` in one graph
    (``step_ms``), and each head alone on that step's hidden states
    (``head_ms``, the graph's ``nodes``); medians of `_graph_runs`. A
    capture that fails raises: nothing on these paths may read back to the
    host."""
    eng = Engine(model, slots=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
                 metrics=obs.MetricsRegistry(), device="cuda")
    for p in prompts[:ENGINE_SLOTS]:
        eng.submit(p, ENGINE_MAX_NEW)
    first = next(iter(heads.values()))
    with torch.inference_mode():
        eng._fill_slots()
        toks = torch.as_tensor([[int(r.prompt[-1])] for r in eng.active],
                               device="cuda")
        pos = torch.as_tensor(eng.pos, device="cuda")
        step = _graph_runs(lambda: first.apply(
            model.decode_hidden(eng.cache, toks, pos)[0]))
        assert step is not None, "decode_hidden + head not captured"
        hidden, _ = model.decode_hidden(eng.cache, toks, pos)
        out = {"step_ms": statistics.median(step), "heads": {}}
        for name, head in heads.items():
            runs = _graph_runs(lambda: head.apply(hidden))
            assert runs is not None, f"{name} head not captured"
            out["heads"][name] = {
                "head_ms": statistics.median(runs),
                "nodes": _graph_nodes(lambda: head.apply(hidden))}
    return out


# ---------------------------------------------------------------------------
# 4j. training at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 16, 512      # examples/train_lm.py's full run
TRAIN_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 30, 25, 10
TRAIN_LR = 3e-4
TRAIN_RESUME_TOL = 1e-4    # the reference's crash/resume limit
TRAIN_HEAD_SPARSITY = 0.8  # `from_dense`'s default, phase 4's
TILE_ROWS = 64             # the pool's rows applied alone (tiling contract)
SMOKE_TRAIN_STEPS = 3
SMOKE_TRAIN_EXTRA = (("smollm-135m", "--optimizer", "adafactor"),
                     ("mamba2-130m", "--microbatches", "2", "--grad-compress"))


def _train_cfg():
    """SmolLM-135M at full width in its own bfloat16, without remat, as
    `examples/train_lm.py`'s full run."""
    cfg = configs.get("smollm-135m").with_(remat=False)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.tie_embeddings, cfg.dtype) == \
        (30, D_MODEL, 9, 3, 1536, VOCAB, True, "bfloat16"), cfg
    return cfg


def _trainer(cfg, pipe, ckpt_dir: str = "") -> Trainer:
    """AdamW at lr 3e-4, 2 microbatches, weights from a generator seeded
    `SEED` on the card; a checkpoint every `TRAIN_CKPT_EVERY` steps into
    ``ckpt_dir`` where one is given."""
    tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, microbatches=2,
                       ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ckpt_dir)
    return Trainer(cfg, tcfg, pipe, device="cuda",
                   generator=torch.Generator().manual_seed(SEED))


def _train_runs(cfg, pipe, ckpt_dir: str) -> tuple:
    """Two trainers from one set of initial weights: ``a`` runs
    `TRAIN_STEPS` steps uninterrupted, one `run` call a step between CUDA
    events; ``b`` checkpoints, crashes at `TRAIN_FAIL_AT`, restores the
    last checkpoint (bitwise the state it saved) and resumes. Returns
    (a, b, measurements)."""
    t0 = time.perf_counter()
    a = _trainer(cfg, pipe)
    init = checkpoint.host_copy(dict(a.model.named_parameters()))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in a.params)
    log(f"[train] SmolLM-135M full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, tied), {n_params:,} parameters in "
        f"{cfg.dtype} with float32 masters, built in {build_s:.1f} s; "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, 2 microbatches, AdamW lr "
        f"{TRAIN_LR}, TF32 off (the float32 head)")
    torch.cuda.reset_peak_memory_stats()
    ms = []
    t0 = time.perf_counter()
    for step in range(TRAIN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        a.run(step + 1, log_every=0)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    a_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    b = _trainer(cfg, pipe, ckpt_dir)
    mine = dict(b.model.named_parameters())
    assert all(torch.equal(mine[k].cpu(), v) for k, v in init.items()), \
        "the two trainers start from other weights"
    t0 = time.perf_counter()
    b.run(2 * TRAIN_CKPT_EVERY, log_every=0)
    saved = checkpoint.host_copy(b.state())
    try:
        b.run(TRAIN_STEPS, log_every=0, fail_at=TRAIN_FAIL_AT)
    except RuntimeError as exc:
        assert f"step {TRAIN_FAIL_AT}" in str(exc), exc
    else:
        raise AssertionError("no failure was injected")
    t1 = time.perf_counter()
    assert b.try_restore(), "no checkpoint to restore"
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    assert b.step == 2 * TRAIN_CKPT_EVERY, b.step
    live = checkpoint.flatten(b.state())
    assert list(live) == list(saved)
    differ = [k for k, v in saved.items() if not torch.equal(live[k].cpu(), v)]
    assert not differ, f"restored state differs from the saved: {differ[:5]}"
    b.run(TRAIN_STEPS, log_every=0)
    b_s = time.perf_counter() - t0
    return a, b, {"build_s": build_s, "params": n_params, "step_ms": ms,
                  "a_s": a_s, "b_s": b_s, "peak_bytes": peak,
                  "restore_s": restore_s, "restored_leaves": len(saved)}


def _score_head(model, cfg, batch) -> dict:
    """`examples/train_lm_torch.py::sparse_head_eval` of the trained model
    on one batch: the tied head pruned at `TRAIN_HEAD_SPARSITY` and
    encoded, then all B * S hidden rows through one ``apply`` (the counted
    run). Held against the decoded head (rtol 1e-4, atol 1e-5); its first
    `TILE_ROWS` rows applied alone and through the plain path bitwise the
    pool's. Times the B = 8192 pass beside dense ``torch.matmul`` and
    cuSPARSE CSR (timed only)."""
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    dense, sparse, head, hidden, logits = sparse_head_eval(
        model, cfg, batch, sparsity=TRAIN_HEAD_SPARSITY)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = _all_launches()
    B = TRAIN_BATCH * TRAIN_SEQ
    assert counts["dtans_spmm"] == 1 and sum(counts.values()) == 1, counts
    assert logits.shape == (TRAIN_BATCH, TRAIN_SEQ, VOCAB)
    assert bool(torch.isfinite(logits).all())
    log(f"[train] head eval: pruned at {TRAIN_HEAD_SPARSITY}, nnz "
        f"{head.mat.nnz:,}, {head.compressed_bytes:,} B "
        f"({head.compression_vs_dense:.2f}x vs dense); the whole pool of "
        f"B={B} rows in one apply, {eval_s:.1f} s with the encode; "
        f"launches {({k: v for k, v in counts.items() if v})}")
    ref = head.apply_dense_reference(hidden)
    e_ref = (logits - ref).abs().max().item()
    assert torch.allclose(logits, ref, rtol=1e-4, atol=1e-5), e_ref
    del ref
    x = hidden.reshape(B, D_MODEL)
    y = logits.reshape(B, VOCAB)
    part = head.apply(x[:TILE_ROWS])
    dm = to_device(head.packed, "cuda")
    plain = K.dtans_spmm_plain(dm, x[:TILE_ROWS].T.contiguous()).reshape(
        -1, TILE_ROWS)[:VOCAB].T
    assert torch.equal(part, y[:TILE_ROWS]), "B=64 is not the pool's rows"
    assert torch.equal(part, plain), "the kernel is not its plain path"
    log(f"[train] logits {tuple(logits.shape)} |y - decoded dense| "
        f"{e_ref:.3e}"
        f" (rtol 1e-4, atol 1e-5); rows 0..{TILE_ROWS - 1} alone and "
        f"through the plain path bitwise the pool's; eval loss dense-head "
        f"{dense:.4f} sparse-head {sparse:.4f}")
    X = x.T.contiguous()
    w = head.dense_weight
    a_csr = w.to_sparse_csr()
    t = {"kernel_ms": time_ms(lambda: ops.spmm(head.packed, X,
                                               device="cuda"), 5),
         "dense_ms": time_ms(lambda: x @ w.T, 5),
         "library_ms": time_ms(lambda: a_csr @ X, 5)}
    b_ms, b_by, nbytes, flops = bound(head, B)
    log(f"[train] B={B} pass: dtans_spmm {t['kernel_ms']:.3f} ms | "
        f"cuSPARSE CSR {t['library_ms']:.3f} ms | dense matmul "
        f"{t['dense_ms']:.3f} ms | bound {b_ms:.3f} ms ({b_by}) | "
        f"{card()}")
    return {"dense_loss": dense, "sparse_loss": sparse, "eval_s": eval_s,
            "nnz": head.mat.nnz, "compressed_bytes": head.compressed_bytes,
            "max_abs_err": e_ref, "B": B, "launches": counts, **t,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops}


def _train_smoke_configs() -> list:
    """Every `configs.ARCH_IDS` smoke config through
    ``repro_torch.launch.train.main`` on the card (3 AdamW steps; one with
    Adafactor, one at 2 microbatches with gradient compression): the
    losses finite, then one more backward with every parameter's gradient
    finite and not all zero."""
    runs = [(arch,) for arch in configs.ARCH_IDS] + list(SMOKE_TRAIN_EXTRA)
    out = []
    for arch, *extra in runs:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            t = launch_train.main(["--arch", arch, "--smoke", "--steps",
                                   str(SMOKE_TRAIN_STEPS), *extra])
        assert len(t.history) == SMOKE_TRAIN_STEPS and all(
            np.isfinite(t.history)), (arch, t.history)
        loss, _ = api.loss_fn(t.model, t.cfg, t.pipeline.batch(t.step))
        loss.backward()
        bad = [n for n, p in t.model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool((p.grad != 0).any())]
        assert not bad, (arch, bad)
        secs = time.perf_counter() - t0
        log(f"[train] smoke {arch} {' '.join(extra) or '(adamw)'}: losses "
            f"{[round(v, 4) for v in t.history]}, every gradient of "
            f"{len(t.params)} tensors finite and nonzero, {secs:.1f} s")
        out.append({"arch": arch, "args": extra, "losses": t.history,
                    "seconds": secs})
    return out


def phase_train() -> None:
    """SmolLM-135M trains at full width (`_train_runs`) and its trained
    head is scored compressed over the whole batch (`_score_head`); then
    every smoke config trains on the card (`_train_smoke_configs`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_cfg()
    pipe = SyntheticTokens(PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH,
                                          seed=SEED))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        a, b, run = _train_runs(cfg, pipe, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ha, hb = a.history, b.history
    resume_diff = abs(ha[-1] - hb[-1])
    first, last = statistics.mean(ha[:5]), statistics.mean(ha[-5:])
    same = max(abs(x - y) for x, y in zip(ha, hb[:TRAIN_FAIL_AT]))
    ms = run["step_ms"]
    spread = _spread(ms[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (spread["p50"] / 1e3)
    saves = b.ckpt.saves
    log(f"[train] uninterrupted: loss {ha[0]:.4f} -> {ha[-1]:.4f} (first 5 "
        f"mean {first:.4f}, last 5 {last:.4f}); step (CUDA events, steps "
        f"1-{TRAIN_STEPS - 1}) p10 {spread['p10']:.2f} / p50 "
        f"{spread['p50']:.2f} / p90 {spread['p90']:.2f} ms, step 0 "
        f"{ms[0]:.1f} ms; {tok_s:,.0f} tokens/s; peak "
        f"{run['peak_bytes'] / 2**30:.2f} GiB allocated | {card()}")
    log(f"[train] crash at {TRAIN_FAIL_AT}, restore at step "
        f"{2 * TRAIN_CKPT_EVERY} ({run['restored_leaves']} leaves bitwise "
        f"the saved state, {run['restore_s']:.2f} s), resumed to "
        f"{TRAIN_STEPS}: final loss {hb[-1]:.6f} vs {ha[-1]:.6f}, diff "
        f"{resume_diff:.2e} (limit {TRAIN_RESUME_TOL:g}); the first "
        f"{TRAIN_FAIL_AT} losses differ by at most {same:.2e}; checkpoints "
        + ", ".join(f"step {r['step']}: {r['bytes'] / 1e9:.3f} GB, snapshot "
                    f"{r['snapshot_s']:.2f} s, write {r['write_s']:.2f} s"
                    for r in saves)
        + f"; wall {run['a_s']:.1f} s uninterrupted, {run['b_s']:.1f} s "
        f"with checkpoints, crash and restore")
    assert resume_diff <= TRAIN_RESUME_TOL, (ha[-1], hb[-1])
    assert last < first, "the loss did not fall"
    head = _score_head(b.model, cfg, pipe.batch(b.step))
    del a, b
    torch.cuda.empty_cache()
    smoke = _train_smoke_configs()
    RESULTS["train"] = {**run, "losses": ha, "losses_resumed": hb,
                        "resume_diff": resume_diff, "first5": first,
                        "last5": last, "step_spread_ms": spread,
                        "tokens_per_s": tok_s, "checkpoints": saves,
                        "head": head, "smoke": smoke}
    RESULTS["launches_train"] = head["launches"]


# ---------------------------------------------------------------------------
# 4k. data parallelism and elasticity at full width
# ---------------------------------------------------------------------------

DP_RANKS, DP_STEPS, DP_SHRUNK_STEPS = 2, 6, 3
# Each step's loss against the one-rank `Trainer` on the concatenated
# shard batches. Two ranks add their two f32 gradient sums in the one
# order a sum of two has, so the runs may well be bitwise; the limit
# allows a bf16 weight whose f32 master differs in its last bit after
# another sum order to round the other way (2^-8 of that weight), which
# moves a loss far less than 1e-3 in 9 steps.
DP_LOSS_RTOL = 1e-3


def _events():
    return [torch.cuda.Event(enable_timing=True) for _ in range(2)]


def _timed_run(t, step: int) -> float:
    """`t.run` to ``step + 1`` between CUDA events; ms."""
    ev = _events()
    ev[0].record()
    t.run(step + 1, log_every=0)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def dp_rank(mesh, cfg) -> dict:
    """One rank of phase 4k (at module level: the ranks import this script
    by name). One step of a `grad_compress` trainer counted by `op_cost`;
    then `DP_STEPS` steps of the plain trainer, the first `DP_STEPS` - 1
    between CUDA events with events around its all-reduces, the last
    counted by `op_cost`; then every rank builds a one-rank mesh, `resize`
    moves the state onto it, and its one rank trains `DP_SHRUNK_STEPS`
    more steps on the whole global batch in 2 microbatches."""
    pipe = SyntheticTokens(PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH,
                                          seed=SEED))

    def trainer(**kw):
        return DataParallelTrainer(
            cfg, TrainConfig(optimizer="adamw", lr=TRAIN_LR,
                             microbatches=1, **kw), pipe, mesh,
            generator=torch.Generator().manual_seed(SEED), device="cuda")

    out = {"rank": mesh.get_coordinate()[0]}
    t = trainer(grad_compress=True)
    _, c = op_cost.analyze(t.train_step, t.batch(0))
    out["compress"] = {"raw": c.coll_raw["all-reduce"],
                       "count": c.coll_counts["all-reduce"],
                       "grad_bytes": sum(2 * p.numel() for p in t.params)}
    del t, c
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = trainer()
    reduce, pending = t._all_reduce, []

    def timed(flat):
        ev = _events()
        ev[0].record()
        reduce(flat)
        ev[1].record()
        pending.append(ev)
    t._all_reduce = timed
    step_ms, ar_ms = [], []
    for step in range(DP_STEPS - 1):
        pending.clear()
        step_ms.append(_timed_run(t, step))
        ar_ms.append(sum(e0.elapsed_time(e1) for e0, e1 in pending))
    t._all_reduce = reduce
    m, c = op_cost.analyze(t.train_step, t.batch(t.step))
    t.history.append(float(m["loss"]))
    t.step += 1
    out["plain"] = {"raw": c.coll_raw["all-reduce"],
                    "count": c.coll_counts["all-reduce"],
                    "grad_bytes": sum(4 * p.numel() for p in t.params)}
    out.update(step_ms=step_ms, all_reduce_ms=ar_ms,
               peak_bytes=torch.cuda.max_memory_allocated())
    one = make_debug_mesh((1,), ("data",), "cuda")
    t0 = time.perf_counter()
    t.resize(one)
    torch.cuda.synchronize()
    out["resize_s"] = time.perf_counter() - t0
    probe = reshard(torch.ones((4, 3), device="cuda"), one, ("data", None))
    out["probe_local"] = tuple(probe.to_local().shape)
    out["active_after"] = t.active
    out["microbatches_after"] = t.tcfg.microbatches if t.active else None
    out["shrunk_ms"] = [_timed_run(t, step) for step in
                        range(DP_STEPS, DP_STEPS + DP_SHRUNK_STEPS)
                        if t.active]
    out["history"] = t.history
    return out


def phase_dp() -> None:
    """Phase 4k: SmolLM-135M as 4j trains data-parallel on `DP_RANKS`
    gloo ranks on this one card (NCCL refuses two ranks on one GPU), 8 x
    512 each, then shrinks to one rank that keeps the global batch of 16
    in 2 microbatches; every step's loss is held against a one-rank
    `Trainer` on the concatenated shard batches (`DP_LOSS_RTOL`), and the
    all-reduce bytes `op_cost` counts against the gradients' bytes."""
    cfg = _train_cfg()
    t0 = time.perf_counter()
    ranks = spawn(DP_RANKS, dp_rank, cfg, device_type="cuda",
                  backend="gloo", axes=("data",), timeout_s=900.0)
    ranks_s = time.perf_counter() - t0
    pipe = SyntheticTokens(PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH,
                                          seed=SEED))
    ref = Trainer(cfg, TrainConfig(optimizer="adamw", lr=TRAIN_LR,
                                   microbatches=DP_RANKS), pipe,
                  device="cuda", generator=torch.Generator().manual_seed(SEED))
    want = []
    for step in range(DP_STEPS + DP_SHRUNK_STEPS):
        parts = [pipe.batch(step, shard=j, num_shards=DP_RANKS)
                 for j in range(DP_RANKS)]
        want.append(float(ref.train_step(
            {k: np.concatenate([q[k] for q in parts]) for k in parts[0]}
        )["loss"]))
    del ref
    torch.cuda.empty_cache()
    got = ranks[0]["history"]
    assert len(got) == DP_STEPS + DP_SHRUNK_STEPS, len(got)
    assert ranks[1]["history"] == got[:DP_STEPS]
    assert [r["active_after"] for r in ranks] == [True, False]
    # the rank outside the one-rank mesh holds an empty shard
    assert [r["probe_local"] for r in ranks] == [(4, 3), (0,)], ranks
    assert ranks[0]["microbatches_after"] == DP_RANKS
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    for r in ranks:
        assert r["plain"]["count"] == 2 and r["compress"]["count"] == 2
        assert r["plain"]["raw"] == r["plain"]["grad_bytes"] + 4
        assert r["compress"]["raw"] == r["compress"]["grad_bytes"] + 4
        assert 2 * r["compress"]["grad_bytes"] == r["plain"]["grad_bytes"]
    ms, ar = ranks[0]["step_ms"][1:], ranks[0]["all_reduce_ms"][1:]
    spread, share = _spread(ms), sum(ar) / sum(ms)
    log(f"[dp] SmolLM-135M as 4j on {DP_RANKS} gloo ranks of this card, "
        f"{TRAIN_BATCH // DP_RANKS} x {TRAIN_SEQ} each: step (CUDA events, "
        f"rank 0, steps 1-{DP_STEPS - 2}) p10 {spread['p10']:.1f} / p50 "
        f"{spread['p50']:.1f} / p90 {spread['p90']:.1f} ms, the all-reduces "
        f"{sum(ar) / len(ar):.1f} ms a step ({share:.1%} of it); peak "
        f"{ranks[0]['peak_bytes'] / 2**30:.2f} GiB a rank | {card()}")
    log(f"[dp] all-reduce a step counted by op_cost: "
        f"{ranks[0]['plain']['raw']:,} B in 2 calls = the f32 gradients' "
        f"{ranks[0]['plain']['grad_bytes']:,} B + the 4-byte loss; with "
        f"grad_compress {ranks[0]['compress']['raw']:,} B (bf16: half)")
    log(f"[dp] shrink to 1 rank (resize {ranks[0]['resize_s']:.2f} s), "
        f"global batch {TRAIN_BATCH} kept in {DP_RANKS} microbatches: step "
        f"{statistics.median(ranks[0]['shrunk_ms']):.1f} ms (median of "
        f"{DP_SHRUNK_STEPS}); the idle rank's shard of a resharded (4, 3) "
        f"tensor {ranks[1]['probe_local']}; losses "
        f"{[round(v, 4) for v in got]}; against "
        f"the one-rank Trainer on the concatenated shards max rel diff "
        f"{max(rel):.2e} (limit {DP_LOSS_RTOL:g}); {ranks_s:.1f} s for the "
        f"ranks")
    assert max(rel) <= DP_LOSS_RTOL, (got, want)
    RESULTS["dp"] = {"ranks": ranks, "want": want, "rel": rel,
                     "step_spread_ms": spread, "all_reduce_share": share,
                     "ranks_s": ranks_s}


# ---------------------------------------------------------------------------
# 4n. tensor parallelism at full width
# ---------------------------------------------------------------------------

TP_RANKS = 3          # a (1 data, 3 model) mesh: 9 / 3 heads, d_ff 1536 and
                      # vocab 49152 divide 3, so every TP site shards and
                      # the KV cache is sharded by its heads
TP_DECODE_STEPS = 16
TP_F32_BATCH, TP_F32_STEPS = 8, 3
TP_BF16_STEPS = 5     # 4j's configuration: 16 x 512, 2 microbatches, bf16
TP_LOSS_RTOL = 1e-4   # f32 TP against the one-rank Trainer
# placed optimizer state (ZeRO-1 on a (3, 1) mesh, its checkpoint restored
# on (1, 3), FSDP forced): f32, a global batch of 6 x 512 (2 rows a data
# rank); the one-rank Trainer runs ZERO1 + RESTORE steps uninterrupted.
# A timed run's first step is cold (DTensor's first dispatch) and its last
# is timed with its collectives: 3 steps leave one warm untimed step as
# the collectives' share's denominator
TP_ZERO1_BATCH = 6
TP_ZERO1_STEPS, TP_RESTORE_STEPS, TP_FSDP_STEPS = 3, 2, 3


def _tp_train_runs() -> tuple:
    """(name, config, global batch, microbatches, steps) of 4n's training:
    f32 8 x 512, then 4j's bf16 configuration."""
    return (("f32", _f32_train_cfg(), TP_F32_BATCH, 1, TP_F32_STEPS),
            ("bf16", _train_cfg(), TRAIN_BATCH, 2, TP_BF16_STEPS))
TP_RTOL, TP_ATOL = 1e-4, 1e-5   # logits; atol of the largest |logit|


class _CollectiveTimer(TorchDispatchMode):
    """CUDA events around every collective the ranks dispatch (DTensor's
    functional ones and their waits, `torch.distributed`'s own): the time
    the card's stream spends in them, and the number of collectives issued
    (`op_cost.collective_kind`; waits not counted), DTensor's own inside
    its dispatch of an op too (`op_cost.has_dtensor`: the op is left to
    DTensor, whose local ops and collectives come back here). A dispatch
    mode runs Python for every op of the step, so the step it times runs
    slower than an untimed one: the collectives' share is taken against
    untimed steps (`_collective_share`)."""

    def __init__(self):
        super().__init__()
        self.pairs: list = []
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if op_cost.has_dtensor(args, kwargs):
            return NotImplemented
        if func.namespace not in ("_c10d_functional",
                                  "_c10d_functional_autograd", "c10d"):
            return func(*args, **kwargs)
        self.count += op_cost.collective_kind(func) is not None
        ev = _events()
        ev[0].record()
        out = func(*args, **kwargs)
        ev[1].record()
        self.pairs.append(ev)
        return out

    def result(self, ms: float) -> dict:
        """The timed step (``ms`` long by its own events): its collectives'
        count and ms."""
        torch.cuda.synchronize()
        return {"ms": ms, "collectives": self.count,
                "collective_ms": sum(a.elapsed_time(b)
                                     for a, b in self.pairs)}


def _collective_share(timed: dict, untimed_ms: list) -> float:
    """The timed step's collective ms over the p50 of the untimed steps
    of the same work."""
    return timed["collective_ms"] / statistics.median(untimed_ms)


def _tp_serve(model, head, prompts: list, feed: list | None = None) -> dict:
    """4g's requests on ``model`` (tensor-parallel, or a plain one-device
    model) as one pool of ``len(prompts)`` slots: each ``prompt[:-1]``
    prefilled alone and inserted into its slot (as the engine admits),
    then `TP_DECODE_STEPS` greedy steps, each `decode_hidden` and the
    compressed ``head`` on its hidden states (``head`` None: the dense
    head picks the tokens); the dense head's logits beside (not timed).
    ``feed``: each step's tokens given in place of the model's own picks.
    Times by CUDA events on this rank (the first prefill and the first
    steps are DTensor's first calls of their shapes: no warm-up run)."""
    ctx = (functools.partial(tp_context, model.logical)
           if hasattr(model, "logical") else contextlib.nullcontext)
    n = len(prompts)
    cache = model.make_decode_cache(n, ENGINE_MAX_SEQ)
    pos = np.zeros(n, dtype=np.int32)
    prefill_ms = []
    for s, p in enumerate(prompts):
        if len(p) > 1:
            ev = _events()
            ev[0].record()
            _, c, _ = model.prefill({"inputs": torch.as_tensor(
                p[None, :-1], device="cuda")}, max_seq=ENGINE_MAX_SEQ)
            model.cache_insert_slot(cache, c, s)
            ev[1].record()
            prefill_ms.append(ev)
        pos[s] = len(p) - 1
    tok = np.array([[int(p[-1])] for p in prompts], dtype=np.int32)
    out = {"tokens": [], "hidden": [], "head": [], "dense": [],
           "step_ms": []}
    for step in range(TP_DECODE_STEPS):
        tt = torch.as_tensor(tok, device="cuda")
        pt = torch.as_tensor(pos, device="cuda")
        ev = _events() + _events()[:1]
        ev[0].record()
        hidden, cache = model.decode_hidden(cache, tt, pt)
        ev[2].record()
        h = full(hidden)                     # replicated: the whole rows
        y = head.apply(h) if head is not None else None
        ev[1].record()
        with ctx():
            dense = full(layers.lm_head(model.embed, hidden))
        tok = (y if y is not None else dense).argmax(-1).to(
            torch.int32).cpu().numpy()
        out["step_ms"].append(ev)
        for key, t in (("tokens", tok), ("hidden", h), ("head", y),
                       ("dense", dense)):
            out[key].append(t if key == "tokens" or t is None
                            else t.cpu().numpy())
        if feed is not None:
            tok = feed[step].astype(np.int32)
        pos = pos + 1
    torch.cuda.synchronize()
    out["prefill_ms"] = [a.elapsed_time(b) for a, b in prefill_ms]
    out["model_ms"] = [a.elapsed_time(m) for a, _, m in out["step_ms"]]
    out["step_ms"] = [a.elapsed_time(b) for a, b, _ in out["step_ms"]]
    out["cache"], out["pos"], out["tok"] = cache, pos, tok
    return out


def _head_weight() -> np.ndarray:
    """Phase 4's head weight W (d_model, vocab), drawn from `SEED`."""
    rng = np.random.default_rng(SEED)
    return (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)


def tp_head_shard(k: int):
    """Shard ``k`` of phase 4's head in `TP_RANKS` row shards, encoded
    alone (`FormatSpec.shard(only=k)`; `SparseLinear.from_dense`'s prune,
    quantization and knobs): a host plan holding that shard only. Rank k
    of 4n runs this in a process of its own while it trains, so the ranks'
    three host encodes run at once and beside their training."""
    pruned = codebook_quantize(magnitude_prune(_head_weight().T, 0.8),
                               bits=8)
    return registry.get_format("dtans").shard(
        pruned, TP_RANKS, only=k, lane_width=128, shared_table=True)


def _tp_steps(t, first: int, n: int, timed: bool = True) -> dict:
    """``n`` steps of trainer ``t`` from step ``first``: losses, step ms by
    CUDA events, the last step's collectives timed (``timed``)."""
    losses, step_ms, coll = [], [], None
    for step in range(first, first + n):
        timer = (_CollectiveTimer() if timed and step == first + n - 1
                 else None)
        ev = _events()
        with timer or contextlib.nullcontext():
            ev[0].record()
            m = t.train_step(t.batch(step))
            ev[1].record()
        losses.append(float(m["loss"]))
        step_ms.append(_elapsed(ev))
        if timer is not None:
            coll = timer.result(step_ms[-1])
    t.step = first + n
    return {"loss": losses, "step_ms": step_ms, "timed_step": coll}


def _tp_train(mesh) -> dict:
    """`TensorParallelTrainer` steps in f32 (8 x 512) and in 4j's bf16
    configuration on ``mesh``: losses, step ms by CUDA events, the last
    step's collectives timed, peak memory."""
    out = {}
    for name, cfg, batch, micro, steps in _tp_train_runs():
        pipe = SyntheticTokens(PipelineConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=batch,
            seed=SEED))
        t = TensorParallelTrainer(
            cfg, TrainConfig(optimizer="adamw", lr=TRAIN_LR,
                             microbatches=micro), pipe, mesh,
            generator=torch.Generator().manual_seed(SEED), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        out[name] = {**_tp_steps(t, 0, steps),
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        del t
        torch.cuda.empty_cache()
    return out


def _f32_train_cfg():
    """4n's f32 runs: `_train_cfg` in float32 (4g's weights' dtype)."""
    return _train_cfg().with_(dtype="float32")


def _tp_zero1(ckpt_dir: str) -> dict:
    """4n's placed optimizer state, f32 SmolLM-135M at a global batch of
    `TP_ZERO1_BATCH` x 512, AdamW, from `SEED`: on a (3 data, 1 model)
    mesh of the ranks, `TP_ZERO1_STEPS` ZeRO-1 steps (the default) and a
    checkpoint into ``ckpt_dir`` after them, then as many steps with
    ``zero1=False`` (every weight compared bitwise); that checkpoint
    restored on the (1, 3) mesh and `TP_RESTORE_STEPS` more steps; then
    `TP_FSDP_STEPS` steps with FSDP forced on the (3, 1) mesh. Losses,
    step ms (CUDA events, each run's last step with its collectives
    timed), this rank's parameter and optimizer-state bytes, checkpoint
    seconds."""
    cfg = _f32_train_cfg()
    data = make_debug_mesh((TP_RANKS, 1), ("data", "model"), "cuda")
    wide = make_debug_mesh((1, TP_RANKS), ("data", "model"), "cuda")
    # drawn once from the seed (on the host); each run takes a copy
    drawn = api.build_model(cfg, generator=torch.Generator().manual_seed(
        SEED), device="cuda")

    def trainer(mesh, **kw):
        pipe = SyntheticTokens(PipelineConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ,
            global_batch=TP_ZERO1_BATCH, seed=SEED))
        return TensorParallelTrainer(
            cfg, TrainConfig(optimizer="adamw", lr=TRAIN_LR,
                             ckpt_dir=ckpt_dir), pipe, mesh,
            model=copy.deepcopy(drawn), **kw)

    def bytes_of(t) -> dict:
        return {"param_bytes": t.rules.check_distributed(t.model),
                "opt_bytes": t.state_bytes()}

    out = {}
    t0 = time.perf_counter()
    t = trainer(data)
    out["zero1"] = {**_tp_steps(t, 0, TP_ZERO1_STEPS), **bytes_of(t)}
    t1 = time.perf_counter()
    t.checkpoint()
    t.ckpt.wait()
    out["zero1"]["checkpoint_s"] = time.perf_counter() - t1
    weights = {n: full(p).detach() for n, p in t.model.named_parameters()}
    del t
    out["zero1"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t = trainer(data, zero1=False)
    out["unplaced"] = {**_tp_steps(t, 0, TP_ZERO1_STEPS), **bytes_of(t)}
    out["bitwise"] = sum(not torch.equal(full(p), weights[n])
                         for n, p in t.model.named_parameters())
    del t, weights
    torch.cuda.empty_cache()
    out["unplaced"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t = trainer(wide)
    t1 = time.perf_counter()
    assert t.try_restore() and t.step == TP_ZERO1_STEPS, t.step
    out["restore"] = {"restore_s": time.perf_counter() - t1,
                      **_tp_steps(t, t.step, TP_RESTORE_STEPS, timed=False),
                      **bytes_of(t)}
    del t
    torch.cuda.empty_cache()
    out["restore"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    t = trainer(data, fsdp=True)
    out["fsdp"] = {**_tp_steps(t, 0, TP_FSDP_STEPS), **bytes_of(t)}
    del t
    torch.cuda.empty_cache()
    out["fsdp"]["wall_s"] = time.perf_counter() - t0
    del drawn
    torch.cuda.empty_cache()
    return out


def tp_rank(mesh, prompts, ckpt_dir: str) -> dict:
    """One rank of phase 4n (at module level: the ranks import this script
    by name). Its own shard of phase 4's head is encoded by a helper
    process (`tp_head_shard`) while the rank trains (`_tp_train`, then
    the placed-state runs `_tp_zero1`, its checkpoint in ``ckpt_dir``);
    then
    4g's model placed on the (1, 3) mesh serves 4g's requests through the
    sharded head (`_tp_serve`), the kernels' launches counted from 0; one
    more decode step is counted by `op_cost` and one timed with its
    collectives."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = mesh.get_local_rank("model")
    out = {"coord": tuple(mesh.get_coordinate())}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as helper:
        t0 = time.perf_counter()
        shard = helper.submit(tp_head_shard, k)
        out["train"] = _tp_train(mesh)
        out["zero1"] = _tp_zero1(ckpt_dir)
        t1 = time.perf_counter()
        plan = shard.result()
        out["encode_s"] = time.perf_counter() - t0
        out["encode_wait_s"] = time.perf_counter() - t1
    out["plan"] = plan
    w = _head_weight()
    head = SparseLinear(mat=None, packed=None, d_in=D_MODEL, d_out=VOCAB,
                        dense_bytes=w.nbytes, baseline_bytes=0,
                        device=torch.device("cuda"), mesh=mesh,
                        plan=shard_ops.host_plan(plan))
    shard_ops.upload(head.plan, "cuda", mesh=mesh)
    model = _smollm(w)
    whole = sum(p.nbytes for p in model.parameters())
    api.distribute(model, model.cfg, mesh)
    rules = model.tp_rules
    out["param_bytes"] = rules.check_distributed(model)   # raises if off
    out["param_bytes_specs"] = sum(
        math.prod(local_shape(rules.tensor_spec(n, tuple(p.shape)),
                              tuple(p.shape), mesh)) * 4
        for n, p in model.named_parameters())
    out["param_bytes_whole"] = whole
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_all()
        run = _tp_serve(model, head, prompts)
        out["launches"] = {n: v for n, v in _all_launches().items() if v}
        cache, pos, tok = run.pop("cache"), run.pop("pos"), run.pop("tok")
        if k:
            run = {key: v for key, v in run.items()
                   if key not in ("hidden", "head", "dense")}
        out["serve"] = run

        def dense_step():
            logits, _ = model.decode_step(cache, torch.as_tensor(
                tok, device="cuda"), torch.as_tensor(pos, device="cuda"))
            return full(logits).argmax(-1)
        _, costs = op_cost.analyze(dense_step)
        out["collectives"] = {"counts": dict(costs.coll_counts),
                              "raw": dict(costs.coll_raw),
                              "sites": costs.sites}
        timer = _CollectiveTimer()
        ev = _events()
        with timer:
            ev[0].record()
            hidden, _ = model.decode_hidden(cache, torch.as_tensor(
                tok, device="cuda"), torch.as_tensor(pos + 1, device="cuda"))
            head.apply(hidden.to_local())
            ev[1].record()
        out["timed_step"] = timer.result(_elapsed(ev))
    return out


def _elapsed(ev) -> float:
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def _tp_reference_losses() -> dict:
    """The one-rank `Trainer` on the batches `tp_rank` trains on: f32 (8 x
    512, one microbatch) and 4j's bf16 configuration, from the same seed."""
    out = {}
    for name, cfg, batch, micro, steps in _tp_train_runs():
        pipe = SyntheticTokens(PipelineConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=batch,
            seed=SEED))
        t = Trainer(cfg, TrainConfig(optimizer="adamw", lr=TRAIN_LR,
                                     microbatches=micro), pipe,
                    device="cuda", generator=torch.Generator().manual_seed(
                        SEED))
        out[name] = [float(t.train_step(t.batch(s))["loss"])
                     for s in range(steps)]
        del t
        torch.cuda.empty_cache()
    return out


def _zero1_reference_losses() -> list:
    """The one-rank `Trainer` on `_tp_zero1`'s batches, uninterrupted:
    `TP_ZERO1_STEPS` + `TP_RESTORE_STEPS` steps."""
    cfg = _f32_train_cfg()
    pipe = SyntheticTokens(PipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TP_ZERO1_BATCH,
        seed=SEED))
    t = Trainer(cfg, TrainConfig(optimizer="adamw", lr=TRAIN_LR), pipe,
                device="cuda", generator=torch.Generator().manual_seed(SEED))
    out = [float(t.train_step(t.batch(s))["loss"])
           for s in range(TP_ZERO1_STEPS + TP_RESTORE_STEPS)]
    del t
    torch.cuda.empty_cache()
    return out


def _zero1_reckoning() -> dict:
    """The dry-run's reckoning (`dryrun._memory`, the specs) of a device's
    parameter and optimizer bytes in `_tp_zero1`'s ZeRO-1 and FSDP runs
    (a (3, 1) `MeshShape`)."""
    shape = ShapeConfig("tp_zero1", TRAIN_SEQ, TP_ZERO1_BATCH, "train")
    out = {}
    for name, fsdp in (("zero1", False), ("fsdp", True)):
        cell = build_cell("smollm-135m", shape.name,
                          MeshShape(("data", "model"), (TP_RANKS, 1)),
                          cfg=_f32_train_cfg(), shape=shape, dp_only=False,
                          fsdp=fsdp)
        mem = dryrun._memory(cell)
        out[name] = {"param_bytes": mem["param_bytes"],
                     "opt_bytes": mem["opt_bytes"]}
    return out


def _gap(row: np.ndarray) -> float:
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def phase_tp(streams: list | None = None, backend: str = "gloo") -> None:
    """Phase 4n: full-width SmolLM-135M (4g's f32 weights, TF32 off) on a
    (1, 3) mesh of `TP_RANKS` gloo ranks of this one card (NCCL refuses
    two ranks on one GPU), its parameters DTensors placed by the sharding
    rules (each rank's bytes the specs' reckoning, exactly); 4g's 8
    prompts prefilled, then `TP_DECODE_STEPS` greedy steps on the
    head-sharded cache with phase 4's weight as a 3-shard compressed head
    (each rank encodes and serves its own shard; `dtans_spmm` launches
    counted on each rank), the streams equal to 4g's (``streams``, where
    given) and to the one-device model's, the logits within `TP_RTOL` /
    `TP_ATOL` of the one-device model's on the same tokens, the head
    bitwise the one-device loop over the three shards; `op_cost`'s
    collectives of one decode step equal to the Megatron count; then
    `TensorParallelTrainer` losses against the one-rank `Trainer`, and
    the placed-state runs (`_tp_zero1`, held by `_check_zero1`).
    ``backend="nccl"`` runs the ranks on cards of their own instead
    (`experiments/tensor_parallel/time_tp_step.py`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    prng = np.random.default_rng(SEED + 7)
    prompts = [prng.integers(0, VOCAB, size=n) for n in ENGINE_PROMPTS]
    t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    # the ranks start (imports, their shards' host encodes) while this
    # process trains the one-rank references on the card
    try:
        with ThreadPoolExecutor(1) as pool:
            group = pool.submit(spawn, TP_RANKS, tp_rank, prompts, ckpt_dir,
                                device_type="cuda", backend=backend,
                                axes=("data", "model"), shape=(1, TP_RANKS),
                                timeout_s=900.0)
            want = _tp_reference_losses()
            want_zero1 = _zero1_reference_losses()
            ref_s = time.perf_counter() - t0
            ranks = group.result()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]
    cfg = configs.get("smollm-135m")

    # parameters: each rank's bytes the specs' reckoning
    for r in ranks:
        assert r["param_bytes"] == r["param_bytes_specs"], r["coord"]
    enc = ", ".join(f"{r['encode_s']:.1f}" for r in ranks)
    wait = ", ".join(f"{r['encode_wait_s']:.1f}" for r in ranks)
    where = ("gloo ranks on this card" if backend == "gloo"
             else f"{backend} ranks, a card each")
    log(f"[tp] SmolLM-135M full width (f32) on a (1, {TP_RANKS}) mesh of "
        f"{where}: {r0['param_bytes']:,} B of parameters a "
        f"rank = the specs' reckoning (local_shape) exactly, of "
        f"{r0['param_bytes_whole']:,} B whole; head shards encoded at "
        f"once, each beside its rank's training, in {enc} s (the ranks "
        f"waited {wait} s for them)")

    # the head: the ranks' shards as one plan, its loop on this device
    plan = dataclasses.replace(
        r0["plan"], shards=tuple(r["plan"].shards[i]
                                 for i, r in enumerate(ranks)),
        shard_nbytes=tuple(r["plan"].shard_nbytes[i]
                           for i, r in enumerate(ranks)))
    shard_ops.upload(plan, "cuda")
    for r in ranks:
        assert r["launches"] == {"dtans_spmm": TP_DECODE_STEPS}, \
            (r["coord"], r["launches"])
    serve = r0["serve"]
    n = len(prompts)
    # the one-device model on the TP run's tokens, through the same head
    # run as the one-device loop over the shards
    loop_head = SparseLinear(mat=None, packed=None, d_in=D_MODEL,
                             d_out=VOCAB, dense_bytes=0, baseline_bytes=0,
                             device=torch.device("cuda"), plan=plan)
    model = _smollm(_head_weight())
    with torch.no_grad():
        one = _tp_serve(model, loop_head, prompts, feed=serve["tokens"])
    del model, one["cache"]
    torch.cuda.empty_cache()
    e_logit, flips = 0.0, []
    with torch.no_grad():
        for step in range(TP_DECODE_STEPS):
            dense, got = one["dense"][step], serve["dense"][step]
            bound = TP_RTOL * np.abs(dense) + TP_ATOL * np.abs(dense).max()
            e_logit = max(e_logit, float(np.abs(got - dense).max()))
            assert (np.abs(got - dense) <= bound).all(), step
            # the head on the TP hidden states: bitwise the loop
            h_tp = torch.as_tensor(serve["hidden"][step], device="cuda")
            loop = loop_head.apply(h_tp)
            assert np.array_equal(loop.cpu().numpy(), serve["head"][step]), \
                step
            # the one-device model's greedy token through the same head
            mine = one["head"][step].reshape(n, VOCAB)
            tp_tok = serve["tokens"][step][:, 0]
            for s in range(n):
                if int(mine[s].argmax()) != int(tp_tok[s]):
                    gap = _gap(mine[s])
                    flips.append((step, s, gap))
                    limit = TP_RTOL * float(np.abs(mine[s]).max()) + \
                        TP_ATOL * float(np.abs(mine[s]).max())
                    log(f"[tp] step {step} slot {s}: TP token "
                        f"{int(tp_tok[s])} != one device "
                        f"{int(mine[s].argmax())}; top-2 gap {gap:.3e} "
                        f"(limit {limit:.3e})")
                    assert gap <= limit, (step, s, gap)
    tp_streams = [[int(serve["tokens"][t][s, 0]) for t in
                   range(TP_DECODE_STEPS)] for s in range(n)]
    agree_4g = None
    if streams is not None:
        agree_4g = sum(a[:ENGINE_MAX_NEW] == b for a, b in
                       zip(tp_streams, streams))
        bad = [i for i, (a, b) in enumerate(zip(tp_streams, streams))
               if a[:ENGINE_MAX_NEW] != b]
        assert not bad or all(
            any(f[1] == i for f in flips) for i in bad), \
            ("TP streams != 4g's", bad)
    log(f"[tp] {n} requests, {TP_DECODE_STEPS} greedy decode steps through "
        f"the 3-shard compressed head: {TP_DECODE_STEPS} dtans_spmm "
        f"launches on each rank ({[r['launches'] for r in ranks]}); the "
        f"head's output bitwise the one-device loop over the shards at "
        f"every step; dense TP logits within rtol {TP_RTOL:g} / atol "
        f"{TP_ATOL:g} x max|logit| of the one-device model's (max |diff| "
        f"{e_logit:.3e}); tokens equal the one-device model's "
        f"({len(flips)} differ, each inside the top-2 gap limit); first "
        f"{ENGINE_MAX_NEW} equal 4g's streams on "
        f"{'(4g not run)' if agree_4g is None else agree_4g} of {n}")

    # collectives of one TP decode step (dense head + the argmax's gather)
    c = r0["collectives"]
    megatron = {"all-reduce": 2 * cfg.n_layers + 1, "all-gather": 1}
    counts = {k: v for k, v in c["counts"].items() if v}
    extra = [site for site in c["sites"]
             if site[0] not in megatron]
    log(f"[tp] one decode step's collectives (op_cost, rank 0): {counts}; "
        f"Megatron's count {megatron} (2 all-reduces of B x 1 x d a layer, "
        f"the vocab-parallel embedding's, the logits' gather for the "
        f"argmax); {c['raw']['all-reduce']:,.0f} B all-reduced, "
        f"{c['raw']['all-gather']:,.0f} B gathered"
        + (f"; extra: {extra}" if extra else ""))
    assert counts == megatron, (counts, c["sites"])

    # training
    tr = r0["train"]
    rel32 = [abs(g - w) / abs(w) for g, w in zip(tr["f32"]["loss"],
                                                 want["f32"])]
    rel16 = [abs(g - w) / abs(w) for g, w in zip(tr["bf16"]["loss"],
                                                 want["bf16"])]
    for r in ranks:
        assert r["train"]["f32"]["loss"] == tr["f32"]["loss"]
    assert max(rel32) <= TP_LOSS_RTOL, (tr["f32"]["loss"], want["f32"])
    assert max(rel16) <= DP_LOSS_RTOL, (tr["bf16"]["loss"], want["bf16"])

    ts = r0["timed_step"]
    pf = _spread(serve["prefill_ms"][1:])
    st = _spread(serve["step_ms"][2:])
    mo = _spread(serve["model_ms"][2:])
    b16 = tr["bf16"]
    # the collectives' shares: each timed step's collective ms over the
    # p50 of the untimed steps of its kind (after the first, DTensor's
    # first dispatch of each shape)
    shares = {"decode": _collective_share(ts, serve["step_ms"][2:]),
              **{name: _collective_share(tr[name]["timed_step"],
                                         tr[name]["step_ms"][1:-1])
                 for name in ("f32", "bf16")}}
    log(f"[tp] times on rank 0 (CUDA events): prefill of one prompt p50 "
        f"{pf['p50']:.1f} ms [{pf['p10']:.1f}, {pf['p90']:.1f}] (the first "
        f"{serve['prefill_ms'][0]:.1f}); decode step (decode_hidden + "
        f"sharded head, B={n}, steps 3-{TP_DECODE_STEPS}) p50 "
        f"{st['p50']:.1f} ms [{st['p10']:.1f}, {st['p90']:.1f}] (the first "
        f"{serve['step_ms'][0]:.1f}; decode_hidden alone p50 "
        f"{mo['p50']:.1f}); one more step with its {ts['collectives']} "
        f"collectives timed in a dispatch mode ({ts['ms']:.1f} ms): "
        f"{ts['collective_ms']:.1f} ms in them, {shares['decode']:.1%} of "
        f"the untimed p50; train step f32 {TP_F32_BATCH} x {TRAIN_SEQ} "
        f"{tr['f32']['step_ms'][1]:.1f} ms (the second; the timed third "
        f"{tr['f32']['timed_step']['collective_ms']:.1f} ms in "
        f"{tr['f32']['timed_step']['collectives']} collectives, "
        f"{shares['f32']:.1%} of the second), bf16 {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in 2 microbatches p50 of steps 2-{TP_BF16_STEPS - 1} "
        f"{statistics.median(b16['step_ms'][1:-1]):.1f} ms (the timed "
        f"last: {b16['timed_step']['collective_ms']:.1f} ms in "
        f"{b16['timed_step']['collectives']} collectives, "
        f"{shares['bf16']:.1%} of that p50); peak "
        f"{b16['peak_bytes'] / 2**30:.2f} GiB a rank | {card()}")
    log(f"[tp] losses f32 {[round(v, 5) for v in tr['f32']['loss']]} vs "
        f"one rank: max rel {max(rel32):.2e} (limit {TP_LOSS_RTOL:g}); bf16 "
        f"{[round(v, 4) for v in b16['loss']]}: max rel {max(rel16):.2e} "
        f"(limit {DP_LOSS_RTOL:g}); references {ref_s:.1f} s, ranks "
        f"{ranks_s:.1f} s")
    zero1 = _check_zero1(ranks, want_zero1)
    RESULTS["tp"] = {
        "ranks_s": ranks_s, "reference_s": ref_s, "zero1": zero1,
        "param_bytes": r0["param_bytes"],
        "param_bytes_whole": r0["param_bytes_whole"],
        "encode_s": [r["encode_s"] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "logit_max_abs_err": e_logit, "flips": flips,
        "agree_4g": agree_4g, "streams": tp_streams,
        "collectives": {"counts": counts, "raw": c["raw"],
                        "sites": c["sites"]},
        "backend": backend, "prefill_ms": serve["prefill_ms"],
        "step_ms": serve["step_ms"], "model_ms": serve["model_ms"],
        "timed_step": ts, "collective_share": shares, "train": tr,
        "want": want,
        "rel": {"f32": rel32, "bf16": rel16}}
    RESULTS["launches_tp"] = {
        name: sum(r["launches"].get(name, 0) for r in ranks)
        for name in _all_launches()}


# ---------------------------------------------------------------------------
# 4l. the CG solve through B1 in float64
# ---------------------------------------------------------------------------

CG_SIDE, CG_TOL, CG_MAXITER = 512, 1e-10, 20000


def cg_host() -> dict:
    """4l's host work, from nothing but `CG_SIDE`: the system encoded as
    CSR-dtANS (lane width 128), timed. `main` runs it beside phases
    2-4c."""
    t0 = time.perf_counter()
    mat = encode_matrix(stencil_2d(CG_SIDE), lane_width=128)
    return {"mat": mat, "encode_s": time.perf_counter() - t0}


def phase_cg(host: dict) -> None:
    """Phase 4l: CG on ``stencil_2d(CG_SIDE)`` in float64 (262,144
    unknowns) to a relative residual of `CG_TOL`, its SpMV B1 (one launch
    an iteration and one for the first residual), then the same CG with
    cuSPARSE CSR (``torch.mv`` of a sparse CSR tensor). Each solution's
    error against ``x_true`` is held under kappa x tol (a residual r
    allows an error up to kappa r), their iteration counts within 2% of
    each other; B1 bitwise its plain version on the system; B1 and
    cuSPARSE CSR timed as phase 5 times a B=1 pass, with the bound.
    ``host``: the system `cg_host` encoded beside the earlier phases."""
    a = stencil_2d(CG_SIDE)
    n = a.shape[0]
    mat = host["mat"]
    assert (mat.nnz, mat.shape) == (a.nnz, a.shape)
    pm = pack_matrix(mat)
    enc_s = host["encode_s"]
    rng = np.random.default_rng(SEED)
    x_true = rng.standard_normal(n)
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    b_np = np.bincount(rows, weights=a.values * x_true[a.indices],
                       minlength=n)
    b = torch.as_tensor(b_np, device="cuda")
    tol = CG_TOL * float(np.linalg.norm(b_np))
    # stencil_2d is 4 on the diagonal and -1 to each neighbour: its
    # eigenvalues are 4 - 2 cos(pi i / (s + 1)) - 2 cos(pi j / (s + 1))
    c = math.cos(math.pi / (CG_SIDE + 1))
    kappa = (1 + c) / (1 - c)
    limit = kappa * CG_TOL
    a_csr = torch.sparse_csr_tensor(
        torch.as_tensor(a.indptr, device="cuda"),
        torch.as_tensor(a.indices, device="cuda"),
        torch.as_tensor(a.values, device="cuda"), size=a.shape,
        check_invariants=False)
    dm = to_device(pm, "cuda")
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    x1, it1 = cg_torch(lambda v: ops.spmv(pm, v, device="cuda"), b, tol,
                       CG_MAXITER)
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t0
    counts = _all_launches()
    t0 = time.perf_counter()
    x2, it2 = cg_torch(lambda v: torch.mv(a_csr, v), b, tol, CG_MAXITER)
    torch.cuda.synchronize()
    s2 = time.perf_counter() - t0
    xt = torch.as_tensor(x_true, device="cuda")
    nrm = float(torch.linalg.norm(xt))
    err1 = float(torch.linalg.norm(x1 - xt)) / nrm
    err2 = float(torch.linalg.norm(x2 - xt)) / nrm
    agree = float(torch.linalg.norm(x1 - x2)) / nrm
    v = torch.as_tensor(rng.standard_normal(n), device="cuda")
    y, y_plain = K.dtans_spmv(dm, v), K.dtans_spmv_plain(dm, v)
    bitwise = torch.equal(y, y_plain)
    t_b1 = device_ms(lambda: K.dtans_spmv(dm, v))
    t_csr = device_ms(lambda: torch.mv(a_csr, v), library=True)
    plain_ms = time_ms(lambda: K.dtans_spmv_plain(dm, v), 3, 1)
    b_ms, b_by, nbytes, flops = dtans_bound(mat, pm, n, n, 1)
    log(f"[cg] stencil_2d({CG_SIDE}): {n:,} unknowns, {a.nnz:,} nonzeros, "
        f"float64; CSR-dtANS {mat.nbytes:,} B (CSR {a.nnz * 12 + (n + 1) * 4:,} "
        f"B), encoded in {enc_s:.1f} s; kappa {kappa:.4g}, tol {CG_TOL:g} "
        f"relative, error limit kappa x tol = {limit:.3g} (the reference's "
        f"1e-6 at side 48)")
    log(f"[cg] B1: {it1} iterations, {s1 * 1e3 / it1:.3f} ms an iteration "
        f"({s1:.2f} s), rel. error {err1:.3e}; launches "
        f"{({k: v for k, v in counts.items() if v})} (iterations + 1 = "
        f"{it1 + 1}) | cuSPARSE CSR: {it2} iterations, "
        f"{s2 * 1e3 / it2:.3f} ms an iteration, rel. error {err2:.3e}; the "
        f"two solutions {agree:.3e} apart | {card()}")
    log(f"[cg] one SpMV (median of {RUNS}): B1 f64 {t_b1['ms']:.4f} ms "
        f"({t_b1['by']}) | cuSPARSE CSR {t_csr['ms']:.4f} ms "
        f"({t_csr['by']}) | plain {plain_ms:.2f} ms | bound {b_ms:.5f} ms "
        f"({b_by}); B1 bitwise its plain version: {bitwise} | {card()}")
    assert counts["dtans_spmv"] == it1 + 1 and sum(counts.values()) == \
        it1 + 1, counts
    assert it1 < CG_MAXITER and abs(it1 - it2) <= 0.02 * it2, (it1, it2)
    assert err1 < limit and err2 < limit and agree < limit, \
        (err1, err2, agree)
    assert bitwise, "B1 is not its plain version on the CG system"
    RESULTS["cg"] = {"n": n, "nnz": a.nnz, "bytes": mat.nbytes,
                     "encode_s": enc_s, "kappa": kappa, "limit": limit,
                     "iterations": it1, "iterations_csr": it2,
                     "ms_per_iteration": s1 * 1e3 / it1,
                     "ms_per_iteration_csr": s2 * 1e3 / it2,
                     "rel_error": err1, "rel_error_csr": err2,
                     "agree": agree, "b1": t_b1, "csr": t_csr,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_bytes": nbytes,
                     "flops": flops}
    RESULTS["launches_cg"] = counts


# ---------------------------------------------------------------------------
# 4m. the quickstart on the card
# ---------------------------------------------------------------------------

def phase_quickstart() -> None:
    """Phase 4m: `examples/quickstart_torch.py` on the card; its SpMV
    (B1) and its `SparseLinear(auto=True)` batch must launch kernels."""
    _reset_all()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = quickstart_torch.main(device="cuda")
    secs = time.perf_counter() - t0
    counts = _all_launches()
    for line in buf.getvalue().splitlines():
        log(f"[quickstart] {line}")
    log(f"[quickstart] {secs:.1f} s; launches "
        f"{({k: v for k, v in counts.items() if v})}; layer "
        f"{out['layer'].decision.config_name} | {card()}")
    assert counts["dtans_spmv"] >= 1, counts
    assert sum(counts.values()) > counts["dtans_spmv"], counts
    RESULTS["quickstart"] = {"seconds": secs, "picks": {
        f"{g}|{r}": v for (g, r), v in out["picks"].items()},
        "layer": out["layer"].decision.config_name}
    RESULTS["launches_quickstart"] = counts


# ---------------------------------------------------------------------------
# the roofline check
# ---------------------------------------------------------------------------

def phase_roofline() -> None:
    """`dryrun.run_cell` on phase 4j's cell (SmolLM-135M, bf16, 16 x 512,
    2 microbatches, one card): its bound must lie below 4j's measured step
    p50, and the roofline's memory figure within 5% of the card's."""
    cfg = _train_cfg()
    rec = dryrun.run_cell(
        "smollm-135m", "train_4k", "single", None, verbose=False, cfg=cfg,
        shape=ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"),
        mesh=MeshShape(("data", "model"), (1, 1)), microbatches=2)
    assert rec["status"] == "ok", rec.get("traceback")
    # counted on a fake process group of the cell's (1, 1) mesh
    assert "sharded_error" not in rec, rec.get("sharded_traceback")
    assert rec["collectives"]["reckoned"] is False
    r = rec["roofline"]
    bound_ms = r["bound_s"] * 1e3
    p50 = RESULTS["train"]["step_spread_ms"]["p50"]
    total = torch.cuda.get_device_properties(0).total_memory
    mem_off = abs(total - roofline.HBM_PER_CHIP) / roofline.HBM_PER_CHIP
    log(f"[roofline] 4j's cell: {rec['flops_per_device'] / 1e12:.3f} TFLOP, "
        f"{rec['hbm_bytes_per_device'] / 1e9:.1f} GB moved (eager, counted "
        f"by op_cost on a fake process group): compute {r['compute_s'] * 1e3:.2f} ms, memory "
        f"{r['memory_s'] * 1e3:.2f} ms -> bound {bound_ms:.2f} ms "
        f"({r['dominant']}); 4j's step p50 {p50:.1f} ms = "
        f"{p50 / bound_ms:.2f}x the bound; model FLOPs "
        f"{rec['model_flops_global'] / 1e12:.3f} T (useful ratio "
        f"{rec['useful_flops_ratio']:.3f}); reckoned peak "
        f"{rec['memory']['peak_live_bytes'] / 2**30:.2f} GiB; the card's "
        f"memory {total:,} B, the roofline's {roofline.HBM_PER_CHIP:,} "
        f"({mem_off:.1%} apart) | {card()}")
    assert bound_ms < p50, (bound_ms, p50)
    assert mem_off <= 0.05, (total, roofline.HBM_PER_CHIP)
    RESULTS["roofline"] = {"record": rec, "bound_ms": bound_ms,
                           "step_p50_ms": p50, "ratio": p50 / bound_ms,
                           "total_memory": total}


def _check_zero1(ranks: list, want: list) -> dict:
    """4n's placed-state runs (`_tp_zero1`) held: each rank's parameter
    and optimizer bytes the dry-run's reckoning exactly (FSDP's AdamW state
    3x its parameters), the ZeRO-1 weights bitwise the ``zero1=False``
    run's, every loss within `TP_LOSS_RTOL` of the one-rank `Trainer`
    (``want``, uninterrupted: the restored run against its later steps);
    logged with step ms p50 and the collectives' share on rank 0."""
    reck = _zero1_reckoning()
    for r in ranks:
        z = r["zero1"]
        assert z["bitwise"] == 0, (r["coord"], z["bitwise"])
        for name in ("zero1", "fsdp"):
            got = {k: z[name][k] for k in ("param_bytes", "opt_bytes")}
            assert got == reck[name], (r["coord"], name, got, reck[name])
        assert z["fsdp"]["opt_bytes"] == 3 * z["fsdp"]["param_bytes"]
        assert z["zero1"]["loss"] == ranks[0]["zero1"]["zero1"]["loss"]
    z = ranks[0]["zero1"]
    rel = {}
    for name, first in (("zero1", 0), ("unplaced", 0),
                        ("restore", TP_ZERO1_STEPS), ("fsdp", 0)):
        ref = want[first:first + len(z[name]["loss"])]
        rel[name] = max(abs(g - w) / abs(w)
                        for g, w in zip(z[name]["loss"], ref))
        assert rel[name] <= TP_LOSS_RTOL, (name, z[name]["loss"], ref)
    shares = {name: _collective_share(z[name]["timed_step"],
                                      z[name]["step_ms"][1:-1])
              for name in ("zero1", "unplaced", "fsdp")}
    ms = {name: z[name]["step_ms"] for name in
          ("zero1", "unplaced", "restore", "fsdp")}
    log(f"[tp] ZeRO-1: f32 SmolLM-135M, {TP_ZERO1_BATCH} x {TRAIN_SEQ}, "
        f"AdamW on a ({TP_RANKS}, 1) mesh: {z['zero1']['opt_bytes']:,} B of "
        f"optimizer state a rank (zero1=False: "
        f"{z['unplaced']['opt_bytes']:,}) = the dry-run's reckoning exactly; "
        f"after {TP_ZERO1_STEPS} steps every weight bitwise the zero1=False "
        f"run's; checkpoint of whole tensors in "
        f"{z['zero1']['checkpoint_s']:.1f} s, restored on the (1, "
        f"{TP_RANKS}) mesh in {z['restore']['restore_s']:.1f} s; FSDP: "
        f"{z['fsdp']['param_bytes']:,} B of parameters a rank, "
        f"{z['fsdp']['opt_bytes']:,} B of AdamW state (3x) = the reckoning; "
        f"losses max rel vs the one-rank Trainer: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" (limit {TP_LOSS_RTOL:g})")
    log(f"[tp] ZeRO-1 step ms on rank 0 (CUDA events): "
        + "; ".join(f"{k} {[round(v, 1) for v in m]} (the run "
                    f"{z[k]['wall_s']:.1f} s)" for k, m in ms.items())
        + "; the last step's collectives: "
        + ", ".join(f"{k} {z[k]['timed_step']['collectives']} in "
                    f"{z[k]['timed_step']['collective_ms']:.1f} ms "
                    f"({shares[k]:.1%} of the warm untimed step)"
                    for k in shares) + f" | {card()}")
    return {"reckoning": reck, "rank0": z, "rel": rel, "shares": shares,
            "want": want}


# ---------------------------------------------------------------------------
# 4o. parameter sets
# ---------------------------------------------------------------------------

#: The parameter sets of the tests (`tests/param_sets.py`), as
#: `DtansParams`: PAPER, the reference's TOY, and eight that move the
#: dtANS kernels' constants (K = 2^8 and 2^16, the latter's tables in
#: global memory; 16- and 8-bit words; M = 2^4 and 2^16, a 16-byte slot;
#: l = 48; o = 1 and 2; L66's 2-slot tables, 22-bit words and 66
#: positions a segment).
PARAM_SETS = {name: DtansParams(*t) for name, t in SET_TUPLES.items()}
#: The set farthest from PAPER: the head is encoded at it in 4o(b).
HEAD_SET = "K16"
#: 4o(a)'s banded matrix: 10,000 rows of 11 entries, 109,970 nonzeros.
SET_BANDED_N, SET_BANDED_BW = 10000, 5


def _banded_csr(n: int, bw: int, dtype, seed: int) -> CSR:
    """An n x n band of half-width ``bw``, seeded normal values, built as
    CSR directly."""
    rows = np.repeat(np.arange(n), 2 * bw + 1)
    cols = rows + np.tile(np.arange(-bw, bw + 1), n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = np.random.default_rng(seed).standard_normal(cols.size).astype(
        dtype)
    indptr = np.r_[0, np.cumsum(np.bincount(rows, minlength=n))]
    return CSR(indptr.astype(np.int64), cols.astype(np.int64), vals, (n, n))


def _set_matrices(name: str) -> list:
    """4o(a)'s matrices at set ``name``: (label, CSR, lane width, shared
    table). tests/test_torch_params.py's (60 x 50, 30% dense, seed 7 +
    len(name); f32 on one table, f64 on two) and the band, f32 and f64."""
    out = []
    for dtype, tag in ((np.float32, "f32"), (np.float64, "f64")):
        rng = np.random.default_rng(7 + len(name))
        d = rng.standard_normal((60, 50)).astype(dtype)
        d[rng.random((60, 50)) >= 0.3] = 0
        out.append((f"test-{tag}", CSR.from_dense(d), 16, tag == "f32"))
    for dtype, tag in ((np.float32, "f32"), (np.float64, "f64")):
        out.append((f"banded-{tag}", _banded_csr(
            SET_BANDED_N, SET_BANDED_BW, dtype, SEED + 5), 128,
            tag == "f32"))
    return out


def params_host() -> dict:
    """4o's host work, from `SEED` alone: every set's encode of 4o(a)'s
    matrices, and the phase-4 head (the same weights, pruned and quantized
    as ``from_dense`` does) encoded at `HEAD_SET`. `main` runs it in a
    process of its own from the start, beside phases 2-4b."""
    t0 = time.perf_counter()
    mats = {(name, label): (a, lw, encode_matrix(
        a, params=p, lane_width=lw, shared_table=sh))
        for name, p in PARAM_SETS.items()
        for label, a, lw, sh in _set_matrices(name)}
    sets_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    w = (rng.standard_normal((D_MODEL, VOCAB)) * 0.02).astype(np.float32)
    pruned = codebook_quantize(magnitude_prune(w.T, 0.8), bits=8)
    head = encode_matrix(pruned, params=PARAM_SETS[HEAD_SET],
                         lane_width=128, shared_table=True)
    return {"mats": mats, "sets_encode_s": sets_s, "head": head,
            "head_csr": pruned,
            "head_encode_s": time.perf_counter() - t0}


def _csr_product(a: CSR, X: np.ndarray) -> torch.Tensor:
    """A X in float64 on the host (X (n,) or (n, B)), on the card."""
    X2 = X.reshape(X.shape[0], -1).astype(np.float64)
    prod = a.values.astype(np.float64)[:, None] * X2[a.indices]
    out = np.zeros((a.shape[0], X2.shape[1]))
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    np.add.at(out, rows, prod)
    return torch.as_tensor(out.reshape((a.shape[0],) + X.shape[1:]),
                           device="cuda")


def _drive_set(name: str, items: list, rng) -> dict:
    """Set ``name``'s matrices through ``ops.spmv`` (B1), ``ops.spmm`` at
    B = 4 and 64 (B2) and ``ops.decode`` (B3) on the card, each bitwise
    its plain version and within `RTOL` of the float64 product; the
    launch counters set to 0 before and read after."""
    torch.cuda.synchronize()
    K.reset_launches()
    DD.reset_launches()
    worst, outs = 0.0, []
    for label, a, lw, mat in items:
        pm = ops.get_packed(mat)
        n = a.shape[1]
        tdt = torch.float64 if a.values.dtype == np.float64 else \
            torch.float32
        xs = [rng.standard_normal(n)] + [rng.standard_normal((n, B))
                                         for B in (4, 64)]
        ys = [ops.spmv(mat, torch.as_tensor(xs[0], dtype=tdt,
                                            device="cuda"))]
        ys += [ops.spmm(mat, torch.as_tensor(x, dtype=tdt, device="cuda"))
               for x in xs[1:]]
        outs.append((label, a, pm, xs, ys, ops.decode(mat)))
    torch.cuda.synchronize()
    counts = {**K.launches, **DD.launches}
    for label, a, pm, xs, ys, (cols, vals) in outs:
        dm = to_device(pm, "cuda")
        m = a.shape[0]
        for x, y in zip(xs, ys):
            xt = torch.as_tensor(x, dtype=dm.dtype, device="cuda")
            plain = (K.dtans_spmv_plain(dm, xt) if x.ndim == 1 else
                     K.dtans_spmm_plain(dm, xt)).reshape((-1,) + x.shape[1:])
            plain = plain[:m]
            assert torch.equal(_bits(y.contiguous()),
                               _bits(plain.contiguous())), \
                f"[sets] {name} {label} B={x.shape[1:]}: kernel != plain"
            worst = max(worst, (y - plain).abs().max().item())
            err, ok = _err(y.double(), _csr_product(a, x), dm.dtype)
            assert ok, f"[sets] {name} {label}: |y - A x| = {err}"
        want_c, want_v = DD.dtans_decode_plain(dm)
        assert torch.equal(cols, want_c) and torch.equal(
            _bits(vals), _bits(want_v)), f"[sets] {name} {label}: decode"
    assert counts["dtans_spmv"] >= len(items) and counts["dtans_decode"] \
        >= len(items) and counts["dtans_spmm"] >= 2 * len(items), counts
    return {"launches": counts, "max_abs_err": worst}


def phase_params(host: dict) -> None:
    """4o(a): every set of `PARAM_SETS` through B1, B2 and B3 on the card
    (`_drive_set`), the band's kernels timed beside their plain versions,
    cuSPARSE CSR and the bound; `params_host` encoded them."""
    rng = np.random.default_rng(SEED + 6)
    rows = {}
    for name, p in PARAM_SETS.items():
        items = [(label, a, lw, mat) for (n_, label), (a, lw, mat)
                 in host["mats"].items() if n_ == name]
        run = _drive_set(name, items, rng)
        label, a, lw, mat = next(i for i in items if i[0] == "banded-f32")
        pm = ops.get_packed(mat)
        dm = to_device(pm, "cuda")
        n = a.shape[1]
        _, lib = library_call(a)
        x1 = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                             device="cuda")
        X = torch.as_tensor(rng.standard_normal((n, 64)),
                            dtype=torch.float32, device="cuda")
        t1 = device_ms(lambda: K.dtans_spmv(dm, x1))
        t3 = device_ms(lambda: DD.dtans_decode(dm))
        timed = {
            "dtans_spmv": (t1["ms"], time_ms(
                lambda: K.dtans_spmv_plain(dm, x1), 2, 1), device_ms(
                    lambda: lib(x1[:, None]), library=True)["ms"],
                dtans_bound(mat, pm, n, a.shape[0], 1)),
            "dtans_spmm": (time_ms(lambda: K.dtans_spmm(dm, X), 20), time_ms(
                lambda: K.dtans_spmm_plain(dm, X), 2, 1),
                time_ms(lambda: lib(X), 20),
                dtans_bound(mat, pm, n, a.shape[0], 64)),
            "dtans_decode": (t3["ms"], time_ms(
                lambda: DD.dtans_decode_plain(dm), 2, 1), None,
                set_decode_bound(mat, pm))}
        rows[name] = {"params": dataclasses.asdict(p),
                      "tables_in_smem": tiling.tables_in_smem(p),
                      "slot_bytes": tiling.slot_bytes(p),
                      "banded": {"nnz": int(a.nnz), "bytes": mat.nbytes,
                                 "device_bytes": dm.nbytes,
                                 "max_nseg": pm.max_nseg},
                      "launches": run["launches"],
                      "max_abs_err": run["max_abs_err"],
                      "times": {k: {"ms": v[0], "plain_ms": v[1],
                                    "library_ms": v[2], "bound_ms": v[3][0],
                                    "bound_by": v[3][1], "bytes": v[3][2]}
                                for k, v in timed.items()}}
        tl = " | ".join(f"{k} {v[0]:.4f} ms (plain {v[1]:.1f}, library "
                        f"{'-' if v[2] is None else f'{v[2]:.4f}'}, bound "
                        f"{v[3][0]:.5f} {v[3][1]})" for k, v in timed.items())
        log(f"[sets] {name} {tuple(dataclasses.astuple(p))}: tables "
            f"{'shared' if tiling.tables_in_smem(p) else 'global'} memory, "
            f"{tiling.slot_bytes(p)} B a slot; {len(items)} matrices "
            f"bitwise plain and within rtol of A x; launches "
            f"{ {k: v for k, v in run['launches'].items() if v} }; banded "
            f"f32 ({a.nnz} nnz, {mat.nbytes} B): {tl} | {card()}")
    RESULTS["param_sets"] = rows
    log(f"[sets] host encodes {host['sets_encode_s']:.1f} s (beside phases "
        f"2-4b)")


def set_decode_bound(mat, pm) -> tuple[float, str, int, int]:
    """`decode_bound` of any encoded matrix."""
    _, _, read, _ = dtans_bound(mat, pm, 0, 0, 0)
    written = pm.n_slices * pm.lane_width * pm.max_nseg * (pm.params.l // 2) \
        * (4 + pm.dtype.itemsize)
    return (*_roofline(read + written, 0, pm.dtype.itemsize),
            read + written, 0)


HEAD_SET_BATCHES = (1, 4, 64)


def phase_params_head(sl: SparseLinear, csr: CSR, host: dict) -> None:
    """4o(b): phase 4's head encoded at `HEAD_SET` (`params_host`), through
    B1, B2 at B = 4 and 64 and B3 on the card, bitwise its plain versions
    and within rtol of the float64 product; then each kernel timed beside
    phase 4's PAPER head in turns (PAPER, K16, K16, PAPER), with its plain
    version, cuSPARSE CSR and the bound."""
    mat = host["head"]
    assert mat.nnz == sl.mat.nnz and np.array_equal(
        host["head_csr"].indices, csr.indices)
    pm = ops.get_packed(mat)
    dm = to_device(pm, "cuda")
    dm0 = to_device(sl.packed, "cuda")
    rng = np.random.default_rng(SEED + 7)
    xs = {B: torch.as_tensor(rng.standard_normal((D_MODEL, B)),
                             dtype=torch.float32, device="cuda")
          for B in HEAD_SET_BATCHES}
    torch.cuda.synchronize()
    K.reset_launches()
    DD.reset_launches()
    ys = {B: (ops.spmv(mat, x[:, 0].contiguous()) if B == 1 else
              ops.spmm(mat, x)) for B, x in xs.items()}
    cols, vals = ops.decode(mat)
    torch.cuda.synchronize()
    counts = {**K.launches, **DD.launches}
    assert counts["dtans_spmv"] >= 1 and counts["dtans_spmm"] >= 2 and \
        counts["dtans_decode"] >= 1, counts
    worst = 0.0
    for B, y in ys.items():
        x = xs[B]
        plain = (K.dtans_spmv_plain(dm, x[:, 0].contiguous()) if B == 1 else
                 K.dtans_spmm_plain(dm, x)).reshape(-1, B)[:VOCAB]
        y = y.reshape(VOCAB, B)
        assert torch.equal(_bits(y.contiguous()), _bits(plain.contiguous())), \
            f"[head-set] B={B}: kernel != plain"
        worst = max(worst, (y - plain).abs().max().item())
        err, ok = _err(y.double(), _csr_product(csr, x.cpu().numpy()),
                       torch.float32)
        assert ok, f"[head-set] B={B}: |y - A x| = {err}"
    want_c, want_v = DD.dtans_decode_plain(dm)
    assert torch.equal(cols, want_c) and torch.equal(_bits(vals),
                                                     _bits(want_v))
    _, lib = library_call(csr)
    res = {"set": HEAD_SET, "params": dataclasses.asdict(pm.params),
           "compressed_bytes": mat.nbytes,
           "paper_compressed_bytes": sl.mat.nbytes,
           "device_bytes": dm.nbytes, "paper_device_bytes": dm0.nbytes,
           "table_bytes": int(dm.tables.nbytes),
           "paper_table_bytes": int(dm0.tables.nbytes),
           "max_nseg": pm.max_nseg, "paper_max_nseg": sl.packed.max_nseg,
           "stream_words": int(mat.stream.size),
           "escapes": int(mat.esc_count_by_domain.sum()),
           "max_table_base": int(pm.tab_base.max()),
           "encode_s": host["head_encode_s"], "launches": counts,
           "max_abs_err": worst, "rows": []}
    log(f"[head-set] the head at {HEAD_SET} {dataclasses.astuple(pm.params)}"
        f": {mat.nbytes} B compressed (PAPER {sl.mat.nbytes} B, "
        f"{mat.nbytes / sl.mat.nbytes:.3f}x), {dm.nbytes} B on the card "
        f"(PAPER {dm0.nbytes}), tables {dm.tables.nbytes} B in global "
        f"memory (PAPER {dm0.tables.nbytes} B staged), max_nseg "
        f"{pm.max_nseg} (PAPER {sl.packed.max_nseg}); host encode "
        f"{host['head_encode_s']:.1f} s beside phases 2-4b; bitwise plain, "
        f"within rtol of A x; launches {counts}")
    for kern, B in (("dtans_spmv", 1), ("dtans_spmm", 4),
                    ("dtans_spmm", 64), ("dtans_decode", 0)):
        x = xs.get(B)
        x1 = None if x is None else x[:, 0].contiguous()

        def run(d, kern=kern, x=x, x1=x1):
            if kern == "dtans_spmv":
                return lambda: K.dtans_spmv(d, x1)
            if kern == "dtans_spmm":
                return lambda: K.dtans_spmm(d, x)
            return lambda: DD.dtans_decode(d)

        def timed(d):
            if kern == "dtans_spmm":
                return time_ms(run(d), 20)
            return device_ms(run(d))["ms"]
        t0a, t1a, t1b, t0b = (timed(dm0), timed(dm), timed(dm), timed(dm0))
        if kern == "dtans_spmv":
            plain = time_ms(lambda: K.dtans_spmv_plain(dm, x1), 2, 1)
            lib_ms = device_ms(lambda: lib(x[:, :1]), library=True)["ms"]
            b = dtans_bound(mat, pm, D_MODEL, VOCAB, 1)
        elif kern == "dtans_spmm":
            plain = time_ms(lambda: K.dtans_spmm_plain(dm, x), 2, 1)
            lib_ms = time_ms(lambda: lib(x), 20)
            b = dtans_bound(mat, pm, D_MODEL, VOCAB, B)
        else:
            plain = time_ms(lambda: DD.dtans_decode_plain(dm), 2, 1)
            lib_ms, b = None, set_decode_bound(mat, pm)
        row = {"kernel": kern, "B": B, "ms": (t1a + t1b) / 2,
               "runs": [t1a, t1b], "paper_ms": (t0a + t0b) / 2,
               "paper_runs": [t0a, t0b], "plain_ms": plain,
               "library_ms": lib_ms, "library": None if lib_ms is None
               else "cuSPARSE CSR", "bound_ms": b[0], "bound_by": b[1],
               "bytes": b[2], "flops": b[3]}
        res["rows"].append(row)
        log(f"[head-set] {kern:12s} B={B:2d}: {HEAD_SET} {row['ms']:.4f} ms "
            f"({t1a:.4f}, {t1b:.4f}) | PAPER {row['paper_ms']:.4f} ms "
            f"({t0a:.4f}, {t0b:.4f}) | plain {plain:.1f} ms | cuSPARSE CSR "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'} | bound "
            f"{b[0]:.5f} ms ({b[1]}, {b[2]} B) | {card()}")
    RESULTS["param_head"] = res


# ---------------------------------------------------------------------------
# 5. times
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


RUNS = 5   # runs of a B=1 pass timed without the Python loop


def _graph_runs(fn, calls: int = 20) -> list | None:
    """ms a call of ``fn`` in each of `RUNS` replays of one CUDA graph of
    ``calls`` calls (no host work between the launches); None where the
    capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        log(f"[times] CUDA graph capture failed "
            f"({str(exc).splitlines()[0][:100]})")
        return None
    g.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / calls)
    return runs


def _c_entry_runs(fn, iters: int = 50) -> list:
    """ms a call in each of `RUNS` event-timed loops of ``iters`` calls of
    the C entry that ``fn``'s wrapper launches, with that launch's
    arguments: the ctypes call alone, without the wrapper around it."""
    seen, saved = [], []

    def recorder(f):
        def call(*args):
            seen.append((f, args))
            return f(*args)
        return call
    for lib in list(_build._loaded.values()):
        for name, f in list(vars(lib).items()):
            if name.endswith("_launch"):
                saved.append((lib, name, f))
                setattr(lib, name, recorder(f))
    try:
        out = fn()                  # keeps the output the entry writes
    finally:
        for lib, name, f in saved:
            setattr(lib, name, f)
    f, args = seen[-1]
    runs = [time_ms(lambda: f(*args), iters) for _ in range(RUNS)]
    del out
    return runs


def device_ms(fn, library: bool = False) -> dict:
    """One call's device time without the Python loop of `time_ms`: the
    median of `RUNS` runs (`_graph_runs`; where capture fails, a loop of
    the C entry alone, or of a library call itself)."""
    runs, by = _graph_runs(fn), "graph"
    if runs is None:
        by = "loop" if library else "C entry"
        runs = ([time_ms(fn, 50) for _ in range(RUNS)] if library
                else _c_entry_runs(fn))
    return {"ms": statistics.median(runs), "runs": runs, "by": by}


def _roofline(nbytes: int, flops: int, itemsize: int) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over the
    card's rate for the type, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP64_FLOP_PER_S if itemsize == 8
                     else FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dtans_bound(mat, pm, n_in: int, n_out: int,
                B: int) -> tuple[float, str, int, int]:
    """Least time for one dtANS pass of ``mat`` (packed as ``pm``) at
    batch B: the larger of the bytes the function must move (compressed
    stream and escape words actually present, one per-lane count array,
    coding tables at the set's bytes a slot (12 at PAPER), x, y; each
    once) over the HBM rate,
    and its multiply-adds (2 nnz B) over the rate of its float type. The
    kernels also read ``ns``, but it is ``2 * nnz`` and not needed."""
    item = pm.dtype.itemsize
    nbytes = (int(mat.stream.size) * 4
              + sum(int(e.size) for e in mat.esc_streams) * 8
              + pm.nnz.nbytes
              + pm.tab_symbol.size * tiling.slot_bytes(pm.params)
              + n_in * B * item + n_out * B * item)
    flops = 2 * mat.nnz * B
    return (*_roofline(nbytes, flops, item), nbytes, flops)


def bound(sl: SparseLinear, B: int) -> tuple[float, str, int, int]:
    """`dtans_bound` of a layer's matrix."""
    return dtans_bound(sl.mat, sl.packed, sl.d_in, sl.d_out, B)


def comparator_bound(csr: CSR, fmt: str, rows, pk,
                     B: int) -> tuple[float, str, int, int]:
    """Least time for one SELL / RGCSR / BCSR pass at batch B: the bytes of
    `_work` (no padding; SELL's stops, RGCSR's counts, BCSR's stored blocks
    with their fill-in and its stops), x and y once each, against 2
    multiply-adds per stored cell and column."""
    item = csr.values.dtype.itemsize
    nbytes, cells = _work(csr, fmt, rows, pk)
    nbytes += D_MODEL * B * item + VOCAB * B * item
    flops = 2 * cells * B
    return (*_roofline(nbytes, flops, item), nbytes, flops)


def decode_bound(sl: SparseLinear) -> tuple[float, str, int, int]:
    """Least time for one decode: the compressed bytes `bound` counts
    without x and y, plus the (S, L, max_nnz) columns and values written
    once; no arithmetic is counted."""
    return set_decode_bound(sl.mat, sl.packed)


def library_call(csr: CSR, block_shape=None):
    """One PyTorch call for the same product on the card, for timing only:
    BSR (``torch.sparse_bsr_tensor @ x``) at ``block_shape`` where it runs
    on this card, else cuSPARSE CSR. Returns (name, fn of x)."""
    a_csr = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, device="cuda"),
        torch.as_tensor(csr.indices, device="cuda"),
        torch.as_tensor(csr.values, device="cuda"),
        size=csr.shape, check_invariants=False)
    if block_shape is not None:
        b = BCSR.from_csr(csr, block_shape)
        a_bsr = torch.sparse_bsr_tensor(
            torch.as_tensor(b.block_ptr, device="cuda"),
            torch.as_tensor(b.block_cols, device="cuda"),
            torch.as_tensor(b.values, device="cuda"),
            size=csr.shape, check_invariants=False)
        x = torch.ones((csr.shape[1], 2), dtype=a_bsr.dtype, device="cuda")
        try:
            want = a_csr @ x
            ok = torch.allclose(a_bsr @ x, want, rtol=1e-4, atol=1e-4)
        except (RuntimeError, NotImplementedError) as exc:
            log(f"[times] torch BSR {block_shape} @ x does not run here "
                f"({str(exc).splitlines()[0][:100]}); cuSPARSE CSR instead")
        else:
            if ok:
                return (f"torch BSR {block_shape[0]}x{block_shape[1]}",
                        lambda v: a_bsr @ v)
            log(f"[times] torch BSR {block_shape} @ x disagrees with CSR; "
                f"cuSPARSE CSR instead")
    return "cuSPARSE CSR", lambda v: a_csr @ v


def phase_times(sl: SparseLinear, csr: CSR, packs: dict, blk: dict) -> list:
    dm = to_device(sl.packed, "cuda")
    bsl = blk["sl"]
    bdm = to_device(bsl.packed, "cuda")
    libs = {"csr": library_call(csr), "bcsr 2x2": library_call(csr, (2, 2)),
            "blocked": library_call(blk["q"], BLOCK),
            "blocked csr": library_call(blk["q"])}
    w_dense = sl.dense_weight
    wb_dense = bsl.dense_weight
    rng = np.random.default_rng(SEED + 2)
    log(f"[times] compressed head {RESULTS['head']['compressed_bytes']} B, "
        f"CSR {sl.mat.nnz * 8 + (sl.d_out + 1) * 4} B, dense "
        f"{sl.dense_bytes} B, the 50 MB L2 holds all but dense, so repeated "
        f"dtANS launches run with the matrix warm in L2 (the comparator "
        f"packs: see [cmp] and [blk]); library calls: "
        f"{ {k: v[0] for k, v in libs.items()} }")
    rows = []

    def add(kern, label, B, bn, k, p_ms, lib, dense_ms, b, csr=None):
        """One row; ``k`` is `pair`'s kernel timing. Its ``library`` is the
        faster of the PyTorch calls timed for the same product on the same
        matrix (``libs[lib]`` and, where given, ``libs[csr]``, cuSPARSE
        CSR)."""
        b_ms, b_by, nbytes, flops = b
        keys = {libs[key][0]: key for key in (lib, csr) if key is not None}
        calls = {name: lib_ms[key] for name, key in keys.items()}
        best = min(calls, key=calls.get) if calls else None
        rows.append({"kernel": kern, "pack": label, "B": B, "bn": bn,
                     **k, "plain_ms": p_ms, "library": best,
                     "library_ms": calls.get(best), "library_calls": calls,
                     "dense_ms": dense_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "flops": flops})
        if best is not None and B == 1:
            rows[-1]["library_loop_ms"] = lib_loop[keys[best]]
        lib_s = " | ".join(f"{k} {v:.4f} ms" for k, v in calls.items()) \
            or "library -"
        dense_s = "-" if dense_ms is None else f"{dense_ms:.4f} ms"
        loop_s = (f" (median of {RUNS}, {k['timed_by']}; Python loop "
                  f"{k['loop_ms']:.4f} ms)" if "loop_ms" in k else "")
        log(f"[times] {kern:17s} {label:14s} B={B:3d} bn={bn} kernel "
            f"{k['ms']:.4f} ms{loop_s} | plain {p_ms:.2f} ms | {lib_s} | "
            f"dense {dense_s} | bound {b_ms:.5f} ms ({b_by}) | {card()}")

    def pair(one, many, x1, x, bn):
        """(kernel timing, plain ms) of a SpMV (B == 1) or SpMM pass. At
        B == 1 the kernel's ``ms`` is `device_ms`'s, the median of `RUNS`
        runs without the Python loop, and ``loop_ms`` the loop's of
        earlier PRs; else ``ms`` is the loop's."""
        if x.shape[1] == 1:
            t = device_ms(lambda: one[0](x1))
            return {"ms": t["ms"], "runs": t["runs"], "timed_by": t["by"],
                    "loop_ms": time_ms(lambda: one[0](x1), 50)}, \
                time_ms(lambda: one[1](x1), 3, 1)
        return {"ms": time_ms(lambda: many[0](x, bn), 20)}, \
            time_ms(lambda: many[1](x, bn), 3, 1)

    lib_loop = {}    # B == 1: the library calls' Python-loop times
    for B, bn in ((1, None), (4, None), (8, None), (64, None), (512, 64)):
        x = torch.as_tensor(rng.standard_normal((D_MODEL, B)),
                            dtype=torch.float32, device="cuda")
        x1 = x[:, 0].contiguous()
        if B == 1:
            lib_ms = {k: device_ms(lambda: fn(x), library=True)["ms"]
                      for k, (_, fn) in libs.items()}
            lib_loop = {k: time_ms(lambda: fn(x), 50)
                        for k, (_, fn) in libs.items()}
        else:
            lib_ms = {k: time_ms(lambda: fn(x), 50) for k, (_, fn) in
                      libs.items()}
        dense_ms = time_ms(lambda: w_dense @ x, 50)
        dense_b_ms = time_ms(lambda: wb_dense @ x, 50)
        kind = "spmv" if B == 1 else "spmm"
        kt, p_ms = pair(
            (lambda v: K.dtans_spmv(dm, v), lambda v: K.dtans_spmv_plain(dm, v)),
            (lambda v, b: K.dtans_spmm(dm, v, bn=b),
             lambda v, b: K.dtans_spmm_plain(dm, v, b)), x1, x, bn)
        add(f"dtans_{kind}", "dtans L=128", B, bn, kt, p_ms, "csr",
            dense_ms, bound(sl, B))
        for label, (fmt, prows, pk, cm) in packs.items():
            spmv, spmm, spmv_plain, spmm_plain, *_ = WRAPPERS[fmt]
            kt, p_ms = pair(
                (lambda v: spmv(cm, v), lambda v: spmv_plain(cm, v)),
                (lambda v, b: spmm(cm, v, bn=b),
                 lambda v, b: spmm_plain(cm, v, b)), x1, x, bn)
            add(f"{fmt}_{kind}", label, B, bn, kt, p_ms,
                "bcsr 2x2" if fmt == "bcsr" else "csr", dense_ms,
                comparator_bound(csr, fmt, prows, pk, B),
                "csr" if fmt == "bcsr" else None)
        # the blocked matrix of phase 4c: fused, generic and BCSR 4x4
        for shared in (True, False):
            kt, p_ms = pair(
                (lambda v: K.dtans_spmv(bdm, v, shared_cols=shared),
                 lambda v: K.dtans_spmv_plain(bdm, v, shared_cols=shared)),
                (lambda v, b: K.dtans_spmm(bdm, v, bn=b, shared_cols=shared),
                 lambda v, b: K.dtans_spmm_plain(bdm, v, b,
                                                 shared_cols=shared)),
                x1, x, bn)
            add(f"dtans_{kind}" + ("_shared" if shared else ""),
                "bcsr-dtans 4x4", B, bn, kt, p_ms, "blocked", dense_b_ms,
                bound(bsl, B), "blocked csr")
        db = blk["db"]
        kt, p_ms = pair(
            (lambda v: BC.bcsr_spmv(db, v), lambda v: BC.bcsr_spmv_plain(db, v)),
            (lambda v, b: BC.bcsr_spmm(db, v, bn=b),
             lambda v, b: BC.bcsr_spmm_plain(db, v, b)), x1, x, bn)
        add(f"bcsr_{kind}", "bcsr 4x4", B, bn, kt, p_ms, "blocked",
            dense_b_ms,
            comparator_bound(blk["q"], "bcsr", BLOCK, blk["pb"], B),
            "blocked csr")
    for r in rows:
        csr_ms = r["library_calls"].get("cuSPARSE CSR")
        if r["kernel"] in ("sell_spmm", "rgcsr_spmm", "bcsr_spmm") and \
                csr_ms:
            r["ratio_csr"] = r["ms"] / csr_ms
            log(f"[times] padded SpMM {r['pack']:10s} B={r['B']:3d} "
                f"bn={r['bn']}: {r['ms']:.4f} ms = {r['ratio_csr']:.2f}x "
                f"cuSPARSE CSR ({csr_ms:.4f} ms) | {card()}")
    for label, s in (("dtans L=128", sl), ("bcsr-dtans 4x4", bsl)):
        d = to_device(s.packed, "cuda")
        t = device_ms(lambda: DD.dtans_decode(d))
        add("dtans_decode", label, 0, None,
            {"ms": t["ms"], "runs": t["runs"], "timed_by": t["by"],
             "loop_ms": time_ms(lambda: DD.dtans_decode(d), 20)},
            time_ms(lambda: DD.dtans_decode_plain(d), 3, 1), None, None,
            decode_bound(s))
    RESULTS["times"] = rows
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        t = time.perf_counter() - t_start
        RESULTS.setdefault("phase_end_s", {})[phase] = t
        log(f"[time] phase {phase} done at {t:.1f} s")

    phase_device()          # raises without a card, before any process
    # 4c's host encode and decode, 4o's encodes, 4h's head, 4i's shards and
    # 4l's system, from the seed alone, run beside phases 2-4c in three
    # processes of their own, niced (stopped if a phase fails)
    host = multiprocessing.get_context("spawn").Pool(
        3, initializer=os.nice, initargs=(10,))   # the main phases first
    set_build = None        # the other sets' libraries, built beside 3-4n
    try:
        try:
            blocked = host.apply_async(blocked_host)
            sets_host = host.apply_async(params_host)
            ssm_host = host.apply_async(ssm_head_host)
            shards_host = host.apply_async(shard_host)
            cg_sys = host.apply_async(cg_host)
            set_build = phase_build()
            done("2")
            phase_kernels()
            done("3")
            sl = phase_main_path()
            done("4")
            csr, packs = phase_comparators(sl)
            done("4b")
            blk = phase_blocked(blocked.get())
            sets_host = sets_host.get()
            ssm_host = ssm_host.get()
            shards_host = shards_host.get()
            cg_sys = cg_sys.get()
        finally:
            host.terminate()
            host.join()
        done("4c")
        phase_decode(sl, csr, blk)
        done("4d")
        phase_autotuned(sl)
        done("4e")
        phase_registry()
        done("4f")
        model, prompts, streams = phase_engine(sl)
        done("4g")
        phase_engine_ssm(ssm_host)
        del ssm_host
        done("4h")
        phase_shard(sl, model, prompts, streams, shards_host)
        del shards_host
        done("4i")
        del model
        phase_train()
        done("4j")
        phase_dp()
        done("4k")
        phase_cg(cg_sys)
        done("4l")
        phase_quickstart()
        done("4m")
        phase_tp(streams)
        done("4n")
        phase_roofline()
        done("roofline")
        phase_set_build(set_build)
    finally:
        if set_build is not None:
            set_build.kill()   # none left after a wait; else stops them
    phase_params(sets_host)
    done("4o(a)")
    phase_params_head(sl, csr, sets_host)
    done("4o(b)")
    times = phase_times(sl, csr, packs, blk)
    done("5")
    # rows of the kernels line: SpMV at B=1, SpMM at B=64; the comparators
    # at the format registry's layouts, BCSR and the fused kernels on the
    # blocked matrix of phase 4c, decode on the head
    pick = {"dtans_spmv": ("dtans L=128", 1),
            "dtans_spmm": ("dtans L=128", 64),
            "sell_spmv": ("sell L=32", 1), "sell_spmm": ("sell L=32", 64),
            "rgcsr_spmv": ("rgcsr G=4", 1), "rgcsr_spmm": ("rgcsr G=4", 64),
            "bcsr_spmv": ("bcsr 4x4", 1), "bcsr_spmm": ("bcsr 4x4", 64),
            "dtans_spmv_shared": ("bcsr-dtans 4x4", 1),
            "dtans_spmm_shared": ("bcsr-dtans 4x4", 64),
            "dtans_decode": ("dtans L=128", 0)}
    kernels = []
    for name, (label, B) in pick.items():
        t = next(r for r in times if r["kernel"] == name
                 and r["pack"] == label and r["B"] == B)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": RESULTS["launches"][name],
            "max_abs_err": RESULTS["main_max_abs_err"][name],
            "max_rel_err": RESULTS["main_max_rel_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "B": B, **{k: t[k] for k in ("loop_ms", "library_loop_ms")
                       if k in t},
            "launches_selection":
                RESULTS["autotune"]["launches_selection"].get(name, 0),
            "launches_calibrate":
                RESULTS["calibration"]["launches"].get(name, 0),
            "launches_engine": RESULTS["launches_engine"][name],
            "launches_engine_ssm": RESULTS["launches_engine_ssm"][name],
            "launches_shard": RESULTS["launches_shard"][name],
            "launches_train": RESULTS["launches_train"][name],
            "launches_cg": RESULTS["launches_cg"][name],
            "launches_quickstart": RESULTS["launches_quickstart"][name],
            "launches_tp": RESULTS["launches_tp"][name]})
    # each set's instantiation: the head at HEAD_SET (4o(b)); the others
    # on 4o(a)'s band, f32
    head = RESULTS["param_head"]
    for name, row in RESULTS["param_sets"].items():
        if name == "PAPER":
            continue
        for kern, (B, t) in {
                "dtans_spmv": (1, row["times"]["dtans_spmv"]),
                "dtans_spmm": (64, row["times"]["dtans_spmm"]),
                "dtans_decode": (0, row["times"]["dtans_decode"])}.items():
            launches, err, pack = row["launches"], row["max_abs_err"], \
                f"banded {SET_BANDED_N} f32"
            if name == HEAD_SET:
                t = next(r for r in head["rows"] if r["kernel"] == kern
                         and r["B"] == B)
                launches, err, pack = head["launches"], head["max_abs_err"], \
                    "dtans L=128 head"
            kernels.append({
                "name": f"{kern}[{name}]", "route": "cuda",
                "source": SOURCE[kern], "replaces": REPLACES[kern],
                "params": row["params"], "launches": launches[kern],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                "library": None if t["library_ms"] is None
                else "cuSPARSE CSR", "B": B, "pack": pack})
    RESULTS["kernels"] = kernels
    RESULTS["total_s"] = time.perf_counter() - t_start
    log(f"[done] all phases in {RESULTS['total_s']:.1f} s")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(RESULTS, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(RESULTS["device"]["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
