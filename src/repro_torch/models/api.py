"""Family dispatcher, as in the JAX package's `models/api.py`: the
reference picks a module by family over a bare parameter tree; here
`build_model` picks the model class, and the model's own methods
(`forward`, `forward_hidden`, `prefill`, `decode_step`, `decode_hidden`,
`make_decode_cache`, `cache_insert_slot`) are the entry points.

The dense, moe and vlm families run `transformer.py`, the ssm and hybrid
families `hybrid.py`, the encdec family `encdec.py`; the training loss
waits for ROADMAP.md A7.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.transformer import Transformer

_FAMILIES = {"dense": Transformer, "moe": Transformer, "vlm": Transformer,
             "ssm": Hybrid, "hybrid": Hybrid, "encdec": EncDec}


def build_model(cfg: ArchConfig, *, generator: torch.Generator,
                device="cuda") -> nn.Module:
    """The model of ``cfg`` with weights drawn from ``generator``, on
    ``device``."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, generator=generator, device=device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
