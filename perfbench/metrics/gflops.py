"""gflops: the CG's operations over all the whole sets of the window
(HPCG's count, `perfbench.work.cg_set_flops`) over the window's time."""


def read(run):
    if "flops" not in run:
        return None
    return run["flops"] / run["window_s"] / 1e9
