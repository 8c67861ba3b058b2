"""step_mfu.apply: the whole call's share of the card's peak rate: the
multiply's 2 nnz B operations over its mean latency, against the peak in
the layer's dtype, in %."""

from perfbench import peaks, work


def read(run):
    lat = run.get("latencies_s")
    if not lat or not run.get("nnz"):
        return None
    flops = work.multiply_flops(run["nnz"], run["batch"]) * len(lat)
    return 100.0 * flops / sum(lat) / peaks.PEAK_FLOPS[run["dtype"]]
