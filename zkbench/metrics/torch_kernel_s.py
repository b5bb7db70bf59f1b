"""torch_kernel_s: device seconds a profiled proof in every kernel that is
not the port's own (PyTorch's), from the trace with CUDA activity alone;
copies and fills are copy_s's."""


def read(record):
    t = record["trace"]
    return t["torch_kernel_s"] / t["proofs"] if t and t["torch_kernel_s"] > 0 else None
