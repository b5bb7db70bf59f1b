"""proof_s: the window's seconds over the proofs it completed (host clock;
each proof is deal, d_prove, unpack, synchronise)."""

from zkbench.stats import per_item


def read(record):
    return per_item(record["window_s"], len(record["proofs"]))
