"""device.idle_pct.gflops: the share of the whole window in which no
operation ran on the device, in %."""

from perfbench.roofline import idle_pct


def read(run):
    return idle_pct(run, "perfbench.window")
