"""copy_s: device seconds a profiled proof in copies and fills (Memcpy,
Memset), from the trace with CUDA activity alone."""


def read(record):
    t = record["trace"]
    return t["copy_s"] / t["proofs"] if t and t["copy_s"] > 0 else None
