"""gathered_melem: elements the king gathers a proof, in millions
(LocalNet.gathered_elems / 1e6 over the window's proofs)."""

from zkbench.stats import per_item


def read(record):
    return per_item(record["counters"]["gathered_elems"] / 1e6, len(record["proofs"]))
