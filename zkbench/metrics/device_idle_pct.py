"""device_idle_pct: the share of a window's proof in which no device
operation runs: the device's busy seconds a proof (the union of the device
intervals in the trace with CUDA activity alone) over the window's seconds
a proof.  The traced proofs' own host seconds are not the divisor: even
CUDA activity tracing slows the launches of a host-bound proof."""


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0 or not record["proofs"] or record["window_s"] <= 0:
        return None
    per_proof = record["window_s"] / len(record["proofs"])
    return 100.0 * (1.0 - t["busy_s"] / t["proofs"] / per_proof)
