"""The memory release that the port's test modules share.

A pytest-xdist worker that ran JAX work (the JAX package's tests, or the JAX
side of the port's comparisons) goes on holding it: JAX keeps every
compiled XLA:CPU executable in its caches, and glibc keeps the heap those
compiles freed.  That is gigabytes per worker, and the workers of one
machine together run it out of memory.  Every port test module imports the
autouse fixture `release_heap`, which releases both when the module starts
and when it ends in a process: it clears JAX's caches (a later JAX call
compiles again, or loads from the persistent compilation cache), collects
garbage, and hands the free heap back with malloc_trim(0).  No result
changes.
"""

import ctypes
import gc
import sys

import pytest

_LIBC = ctypes.CDLL(None)


def release() -> None:
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
    if hasattr(_LIBC, "malloc_trim"):
        _LIBC.malloc_trim(0)


@pytest.fixture(autouse=True, scope="module")
def release_heap():
    release()
    yield
    release()


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_release_hands_freed_heap_back():
    """64 MiB of small blocks, freed: the process keeps the pages until
    release() returns them."""
    if not hasattr(_LIBC, "malloc_trim"):
        pytest.skip("the C library has no malloc_trim")
    release()
    base = _rss_bytes()
    blocks = [bytearray(1000) for _ in range(1 << 16)]
    grown = _rss_bytes()
    del blocks[: len(blocks) - 1]  # keep the last block: the heap's top stays in use
    release()
    assert grown - base > 48 << 20
    assert _rss_bytes() - base < (grown - base) // 4
