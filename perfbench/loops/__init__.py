"""Loops: one module a way of driving a subject, named by a traffic mix's
``"loop"`` key (``traffic/<mix>.json`` holds the parameters, ``loops/<loop>.py``
the code that reads them).

A loop module has ``make(params, case, seed, device, mark)``, which returns
a loop: `prepare` allocates what the harness holds (its inputs and
buffers, and the BLAS workspace its own arithmetic takes) before the port's
object is built; `warmup(subject)` runs every shape the window will use;
`run(subject, seconds)` measures for ``seconds`` and returns the window's
record (``window_s``, ``attempted`` and what the loop's metrics read);
`merge(a, b)` makes two parts of one window one record; `produced` hands
the kept answers to the comparison. ``mark(name)`` is a context that names
a stretch of host time (a profiler range in a traced run).

A later mix that drives the subject some other way adds a loop module and
edits none.
"""

from __future__ import annotations

import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Seconds of each timed block: CUDA events on a card (the block
    starts on an idle stream, so the first event fires as it is entered),
    the host's clock elsewhere."""

    def __init__(self, device: torch.device):
        self.device, self.seconds = device, []
        if device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.stop = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        if self.device.type == "cuda":
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.stop.record()
            self.stop.synchronize()
            self.seconds.append(self.start.elapsed_time(self.stop) / 1e3)
        else:
            self.seconds.append(time.perf_counter() - self.t0)
