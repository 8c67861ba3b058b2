"""dtans_spmm_roofline.apply: the fused dtANS SpMM kernel's share of its
roofline in the window's calls, in % (`perfbench.roofline`)."""

from perfbench.roofline import kernel_share


def read(run):
    return kernel_share(run, "dtans_spmm_kernel")
