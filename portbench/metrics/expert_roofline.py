"""SWIS kernels: ``xk::swis_experts_kernel`` (the expert stacks) at its
share of the roofline bound of the routed pairs' work."""

from portbench.metrics._roofline import share


def read(run):
    if run.work.moe is None:
        return None
    return share(run, "experts", "swis_experts_kernel")
