"""A kernel's share of its roofline, from the window's trace and the
port's counters.

The kernel's time a pass is the mean time of its launches in the window
(``torch.profiler``; the dtANS SpMV and SpMM run a pass in one launch).
A pass must move the matrix bytes the port records for it
(``kernels.matrix_bytes`` over ``kernels.spmm_calls``, read at run time so
that they never go stale), x once and y once, and do 2 nnz B operations,
nnz counted on the plain matrix the benchmark made (`work`, `peaks`).
"""

from __future__ import annotations

from perfbench import peaks, timeline, work


def kernel_share(run: dict, kernel: str):
    """Percent of the roofline, or None where the window ran no such
    kernel."""
    tl, c = run.get("timeline"), run.get("counters", {})
    if not tl or not c.get("kernels.spmm_calls") or not run.get("nnz"):
        return None
    ws, we = timeline.window(tl)
    times = [e - s for name, s, e in tl["device"]
             if kernel in name and s >= ws and e <= we]
    if not times:
        return None
    itemsize = 8 if run["dtype"] == "float64" else 4
    nbytes = work.pass_bytes(
        c["kernels.matrix_bytes"] / c["kernels.spmm_calls"], run["rows"],
        run["cols"], run["batch"], itemsize)
    least = peaks.least_time(work.multiply_flops(run["nnz"], run["batch"]),
                             nbytes, run["dtype"])
    return 100.0 * least / (sum(times) / len(times) / 1e6)


def idle_pct(run: dict, mark: str):
    """Percent of the time inside the harness's ``mark`` ranges in which
    no operation ran on the device."""
    tl = run.get("timeline")
    if not tl or not tl["device"] or not tl["marks"].get(mark):
        return None
    ranges = tl["marks"][mark]
    total = sum(e - s for s, e in ranges)
    return 100.0 * (1.0 - timeline.covered(timeline.busy(tl), ranges) / total)
