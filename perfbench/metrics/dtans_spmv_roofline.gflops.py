"""dtans_spmv_roofline.gflops: the fused dtANS SpMV kernel's share of its
roofline in the window's CG sets, in % (`perfbench.roofline`)."""

from perfbench.roofline import kernel_share


def read(run):
    return kernel_share(run, "dtans_spmv_kernel")
