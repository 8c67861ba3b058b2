"""What the profiler saw in the window: device time, idle time, and what
the host was doing while the device idled.

`collect` reads a finished ``torch.profiler.profile`` (CPU and CUDA
activities): every device operation (kernels, copies, sets) as
``(name, start_us, end_us)``, the host's ranges on the driving thread,
and the harness's marks (``perfbench.window``, ``perfbench.call``, ...).
The rest are plain functions of intervals, which the metric readers use.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

DEVICE = torch.autograd.DeviceType.CUDA


def collect(prof) -> dict:
    device, host, marks = [], [], defaultdict(list)
    window_thread = None
    events = prof.events()
    for e in events:
        t = e.time_range
        if e.device_type == DEVICE:
            if not _annotation(e):
                device.append((e.name, float(t.start), float(t.end)))
        elif e.name.startswith("perfbench."):
            marks[e.name].append((float(t.start), float(t.end)))
            if e.name == "perfbench.window":
                window_thread = e.thread
    for e in events:
        if e.device_type != DEVICE and e.thread == window_thread \
                and e.name != "perfbench.window":
            t = e.time_range
            host.append((e.name, float(t.start), float(t.end)))
    device.sort(key=lambda d: d[1])
    return {"device": device, "host": host,
            "marks": {k: sorted(v) for k, v in marks.items()}}


def _annotation(e) -> bool:
    """A ``record_function`` range: the profiler copies each onto the
    device's timeline too, where it is no operation and must not count as
    busy."""
    return bool(getattr(e, "is_user_annotation", False)) \
        or e.name.startswith("perfbench.")


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint cover of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(cover: list, ranges: list) -> float:
    """Length of the disjoint ``cover`` inside the disjoint sorted
    ``ranges``."""
    total, starts = 0.0, [c[0] for c in cover]
    for rs, re in ranges:
        i = max(bisect.bisect_right(starts, rs) - 1, 0)
        while i < len(cover) and cover[i][0] < re:
            total += max(0.0, min(cover[i][1], re) - max(cover[i][0], rs))
            i += 1
    return total


def busy(tl: dict) -> list[tuple[float, float]]:
    return union((s, e) for _, s, e in tl["device"])


def window(tl: dict) -> tuple[float, float]:
    (w,) = tl["marks"]["perfbench.window"]
    return w


def device_ops(tl: dict, top: int = 10) -> list:
    """The device operations that took most time in the window, as
    ``[name, seconds]``."""
    ws, we = window(tl)
    by = defaultdict(float)
    for name, s, e in tl["device"]:
        if s >= ws and e <= we:
            by[name[:160]] += (e - s) / 1e6
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _innermost(host: list) -> list[tuple[float, float, str]]:
    """The host's time cut into segments, each named by the innermost
    range open in it."""
    segs, stack, cur = [], [], float("-inf")
    for name, s, e in sorted(host, key=lambda h: (h[1], -h[2])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            if end > cur:
                segs.append((cur, end, nm))
                cur = end
        if stack and s > cur:
            segs.append((cur, s, stack[-1][1]))
        cur = max(cur, s)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        end, nm = stack.pop()
        if end > cur:
            segs.append((cur, end, nm))
            cur = end
    return segs


def idle_gaps(tl: dict, top: int = 10) -> list:
    """The window's idle device time, by what the host was doing then, as
    ``[host activity, seconds]``: the innermost host range open (an aten
    op, a runtime call, a harness mark), or ``python`` outside them."""
    ws, we = window(tl)
    gaps, cur = [], ws
    for s, e in busy(tl):
        if e <= ws or s >= we:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < we:
        gaps.append((cur, we))
    segs = _innermost(tl["host"])
    starts = [s[0] for s in segs]
    by = defaultdict(float)
    for gs, ge in gaps:
        i = max(bisect.bisect_right(starts, gs) - 1, 0)
        named = 0.0
        while i < len(segs) and segs[i][0] < ge:
            ov = min(segs[i][1], ge) - max(segs[i][0], gs)
            if ov > 0:
                by[segs[i][2][:160]] += ov / 1e6
                named += ov
            i += 1
        by["python"] += (ge - gs - named) / 1e6
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]
            if t > 0]
