"""Optimizers over `api.reference_leaves`'s tree: AdamW and Adafactor (the
reference's interface and defaults), and bf16 gradient compression with
error feedback."""

from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.grad_compress import with_error_feedback

__all__ = ["Optimizer", "adafactor", "adamw", "make_optimizer",
           "with_error_feedback"]


def make_optimizer(name: str, lr: float = 3e-4, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
