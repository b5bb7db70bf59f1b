"""net_rounds: LocalNet rounds a proof over the window (LocalNet.rounds)."""

from zkbench.stats import per_item


def read(record):
    return per_item(record["counters"]["net_rounds"], len(record["proofs"]))
