"""port_kernel_s: device seconds a profiled proof in the port's own CUDA
kernels, by name, from the trace with CUDA activity alone."""


def read(record):
    t = record["trace"]
    return t["port_kernel_s"] / t["proofs"] if t and t["port_kernel_s"] > 0 else None
