"""SWIS kernels: ``swis_matmul_kernel`` (the 2-D launch of q, k, v, o and
the MLP or shared experts) at its share of the roofline bound."""

from portbench.metrics._roofline import share


def read(run):
    return share(run, "swis_2d", "swis_matmul_kernel")
