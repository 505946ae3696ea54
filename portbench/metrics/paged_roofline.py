"""Paged attention: ``paged_attention_kernel`` over the decode rows at its
share of the roofline bound."""

from portbench.metrics._roofline import share


def read(run):
    return share(run, "paged", "paged_attention_kernel")
