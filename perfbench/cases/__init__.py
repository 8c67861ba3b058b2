"""Cases: one module a kind of configuration, named by a configuration
file's ``"case"`` key.

``make(cfg, seed, device)`` makes the configuration's inputs from the seed
and returns a case: ``program()`` builds the port's object through its
public entry and returns a `Subject`; ``control()`` returns the plain
reference in the next lower precision in the program's place; and
``compare(produced)`` works the reference out again from the inputs and
returns each compared number by name, to be held against the
configuration's ``"limits"``.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Subject:
    """What the window drives: ``call`` is the entry (``x -> y`` of a
    layer, or ``v -> A v`` of an operator) in ``dtype``; ``info`` goes on
    the run's earlier lines."""
    call: object
    dtype: torch.dtype
    info: dict = dataclasses.field(default_factory=dict)


def worst(values) -> float:
    """The largest of ``values``; infinite where one is not finite or where
    there is none (an answer that never came is not a small gap)."""
    vals = [float(v) for v in values]
    if not vals or not all(math.isfinite(v) for v in vals):
        return math.inf
    return max(vals)
