"""step_mfu.gflops: the CG's whole rate (`gflops`) as a share of the
card's peak rate in the operator's dtype, in %."""

from perfbench import peaks


def read(run):
    if "flops" not in run:
        return None
    return 100.0 * run["flops"] / run["window_s"] / peaks.PEAK_FLOPS[run["dtype"]]
