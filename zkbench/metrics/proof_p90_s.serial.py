"""proof_p90_s.serial: the 90th percentile of all the window's proof latencies
(host clock, statistics.quantiles)."""

from zkbench.stats import percentile


def read(record):
    return percentile([p["latency_s"] for p in record["proofs"]], 90)
