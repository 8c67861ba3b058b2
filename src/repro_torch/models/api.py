"""Family dispatcher, as in the JAX package's `models/api.py`: the
reference picks a module by family over a bare parameter tree; here
`build_model` picks the model class, and the model's own methods
(`forward`, `forward_hidden`, `prefill`, `decode_step`, `decode_hidden`,
`make_decode_cache`, `cache_insert_slot`) are the entry points.

Ported so far: the dense, moe and vlm families (`transformer.py`). The
ssm, hybrid and encdec families raise `NotImplementedError` (ROADMAP.md
A5b, the next slice); the training loss waits for ROADMAP.md A7.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import Transformer


def build_model(cfg: ArchConfig, *, generator: torch.Generator,
                device="cuda") -> Transformer:
    """The model of ``cfg`` with weights drawn from ``generator``, on
    ``device``."""
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet "
            f"(ROADMAP.md A5b: models/ssm.py, hybrid.py, encdec.py)")
    return Transformer(cfg, generator=generator, device=device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
