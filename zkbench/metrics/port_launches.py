"""port_launches: launches of the port's own kernels a proof, the sum of
kernels.KERNELS[*].launches over the window."""

from zkbench.stats import per_item


def read(record):
    return per_item(record["counters"]["port_launches"], len(record["proofs"]))
