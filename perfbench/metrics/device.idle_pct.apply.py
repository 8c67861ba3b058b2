"""device.idle_pct.apply: the share of the calls' timed intervals in which
no operation ran on the device, in %."""

from perfbench.roofline import idle_pct


def read(run):
    return idle_pct(run, "perfbench.call")
