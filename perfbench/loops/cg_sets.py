"""Unpreconditioned CG in sets, with no read by the host inside a set.

Parameters: ``iterations``, the steps of a set. Each set starts from
x = 0; after it the residual norm is read back once and kept. The vector
arithmetic is the example CG's, in place. On the card the program's set is
captured once as a CUDA graph at set-up and replayed, so the device, not
the host's Python, paces the sets; the control, and any run without a
card, runs its sets eagerly.
"""

from __future__ import annotations

import time

import torch

from perfbench import work


class CGSets:
    def __init__(self, params: dict, case, seed: int, device, mark):
        self.case, self.device, self.mark = case, device, mark
        self.iterations = params["iterations"]

    def prepare(self, dtype: torch.dtype | None = None) -> None:
        dtype = dtype or self.case.dtype
        self.b = self.case.b.to(dtype)
        self.x, self.r, self.p = (torch.empty_like(self.b) for _ in range(3))
        self.rnorms: list[float] = []
        torch.dot(self.b, self.b)       # the BLAS workspace of the dots

    def _set(self, spmv) -> torch.Tensor:
        """One set, enqueued; returns the residual norm on the device."""
        x, r, p = self.x, self.r, self.p
        x.zero_()
        torch.sub(self.b, spmv(x), out=r)
        p.copy_(r)
        rs = torch.dot(r, r)
        for _ in range(self.iterations):
            ap = spmv(p)
            alpha = rs / torch.dot(p, ap)
            x.addcmul_(alpha, p)
            r.addcmul_(alpha, ap, value=-1)
            rs_new = torch.dot(r, r)
            p.mul_(rs_new / rs).add_(r)
            rs = rs_new
        return torch.sqrt(rs)

    def warmup(self, subject) -> None:
        """An eager set; on the card, the program's set is then captured
        once as a CUDA graph (after an eager set on a side stream, as
        capture asks), so that the window replays the same kernels with no
        host work between them."""
        if subject.dtype != self.b.dtype:
            self.prepare(subject.dtype)
        float(self._set(subject.call))
        self.replay = None
        if self.device.type != "cuda" or subject.info.get("control"):
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._set(subject.call)
        torch.cuda.current_stream(self.device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            rn = self._set(subject.call)
        self.replay = (g, rn)
        g.replay()
        float(rn)

    def _one(self, subject) -> float:
        if self.replay is None:
            return float(self._set(subject.call))
        g, rn = self.replay
        g.replay()
        return float(rn)                    # the set's one read by the host

    def run(self, subject, seconds: float) -> dict:
        t0 = time.perf_counter()
        n0 = len(self.rnorms)
        while True:
            with self.mark("perfbench.set"):
                self.rnorms.append(self._one(subject))
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        sets = len(self.rnorms) - n0
        c = self.case
        return {"window_s": window_s, "attempted": sets,
                "flops": sets * work.cg_set_flops(c.nnz, c.n, self.iterations),
                "batch": 1}

    @staticmethod
    def merge(a: dict, b: dict) -> dict:
        return dict(b, window_s=a["window_s"] + b["window_s"],
                    attempted=a["attempted"] + b["attempted"],
                    flops=a["flops"] + b["flops"])

    def produced(self) -> dict:
        return {"rnorms": self.rnorms, "x": self.x,
                "iterations": self.iterations}


make = CGSets
