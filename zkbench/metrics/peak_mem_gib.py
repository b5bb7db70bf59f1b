"""peak_mem_gib: torch.cuda.max_memory_allocated over set-up and window,
in GiB."""


def read(record):
    peak = record["memory_peak_bytes"]
    return peak / 2**30 if peak else None
