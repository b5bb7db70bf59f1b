"""deal_s: the dealer's fresh r and s shares and ProveMasks a proof, mean
over the window (the benchmark's synchronised span around step 1)."""

from zkbench.stats import per_item


def read(record):
    return per_item(sum(p["deal_s"] for p in record["proofs"]), len(record["proofs"]))
