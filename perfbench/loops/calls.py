"""A closed loop with one caller, each call awaited.

Parameters: ``batches`` batches of ``batch`` rows (N(0, 1), drawn on the
device from the seed at set-up) are sent in turn, each call awaited before
the next. Before each call, outside its timed interval, a buffer of
``flush_mib`` MiB is written, which leaves the L2 cold as the rest of a
step's layers would. A call's latency runs from its start, on an idle
stream, to its result complete on the device (CUDA events; on the host's
clock where there is no card). For the comparison one answer of each batch
is kept, drawn from the seed uniformly over that batch's calls (reservoir
sampling); a window sends every batch at least once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.loops import Timer, sync
from perfbench.seeds import derive


class Calls:
    def __init__(self, params: dict, case, seed: int, device, mark):
        self.case, self.device, self.mark = case, device, mark
        self.batch, self.n_batches = params["batch"], params["batches"]
        self.flush_mib = params["flush_mib"]
        self.seed = seed

    def prepare(self) -> None:
        c, dev = self.case, self.device
        g = torch.Generator(device=dev).manual_seed(derive(self.seed, "x"))
        self.x = torch.randn(self.n_batches, self.batch, c.d_in, generator=g,
                             device=dev, dtype=c.dtype)
        self.flush = torch.empty(self.flush_mib << 18, dtype=torch.float32,
                                 device=dev)
        self.kept = torch.empty(self.n_batches, self.batch, c.d_out,
                                dtype=c.dtype, device=dev)
        self.seen = [0] * self.n_batches
        self.rng = np.random.default_rng(derive(self.seed, "sample"))

    def _step(self, call, i: int, timer):
        b = i % self.n_batches
        with self.mark("perfbench.flush"):
            self.flush.fill_(float(i & 1))
            sync(self.device)
        with self.mark("perfbench.call"):
            with timer:
                y = call(self.x[b])
        self.seen[b] += 1
        if self.rng.random() * self.seen[b] < 1.0:
            self.kept[b].copy_(y)

    def warmup(self, subject) -> None:
        timer = Timer(self.device)
        for i in range(self.n_batches):
            self._step(subject.call, i, timer)
        sync(self.device)
        self.seen = [0] * self.n_batches

    def run(self, subject, seconds: float) -> dict:
        timer = Timer(self.device)
        t0 = time.perf_counter()
        end, i = t0 + seconds, 0
        while True:
            self._step(subject.call, i, timer)
            i += 1
            if i >= self.n_batches and time.perf_counter() >= end:
                break
        sync(self.device)
        return {"window_s": time.perf_counter() - t0, "attempted": i,
                "latencies_s": timer.seconds, "batch": self.batch}

    @staticmethod
    def merge(a: dict, b: dict) -> dict:
        return dict(b, window_s=a["window_s"] + b["window_s"],
                    attempted=a["attempted"] + b["attempted"],
                    latencies_s=a["latencies_s"] + b["latencies_s"])

    def produced(self) -> dict:
        return {"x": self.x, "y": {b: self.kept[b]
                                   for b in range(self.n_batches)
                                   if self.seen[b]}}


make = Calls
