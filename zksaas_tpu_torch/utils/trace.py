"""Phase spans with device-synchronised wall-clock times.

Port of zksaas_tpu/utils/trace.py's span: `span(name, times)` adds the
seconds a phase took to the dict `times` (when given), synchronising the
CUDA device at both ends so the time covers the queued work.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str, times: dict | None = None):
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        if times is not None:
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
