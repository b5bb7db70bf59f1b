"""The port's spans and counters, on the CPU with no proof.

`utils/trace.py::span` synchronises the device only when the caller asks
for seconds (`times`), records only inside `tracing()`, and then keeps each
span's parent, request and host times and opens a profiler range of its
name.  `Field.rand` counts the bytes it draws on the host; `kernels.check`
counts the lanes of each launch.
"""

import time

import pytest
import torch

from zksaas_tpu_torch import kernels
from zksaas_tpu_torch.fields.field import field
from zksaas_tpu_torch.fields.spec import FIELDS
from zksaas_tpu_torch.utils import trace

from test_torch_heap import release_heap  # noqa: F401  (autouse)


@pytest.fixture
def syncs(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "_sync", lambda: calls.append(1))
    return calls


def test_span_off_neither_syncs_nor_records(syncs):
    with trace.tracing() as tr:
        pass
    with trace.span("zk.off"):
        with trace.request(0):
            with trace.span("zk.off.inner"):
                pass
    assert syncs == []
    assert tr.spans == [] and tr.requests == []
    assert trace._active is None


@trace.span("zk.decorated")
def _decorated(x):
    with trace.span("zk.inside"):
        return x + 1


def test_span_decorates_a_whole_function(syncs):
    assert _decorated(1) == 2  # off: nothing recorded
    with trace.tracing() as tr:
        assert _decorated(2) == 3 and _decorated(3) == 4
    assert [(s.name, s.parent) for s in tr.spans] == [
        ("zk.decorated", -1), ("zk.inside", 0), ("zk.decorated", -1), ("zk.inside", 2)]
    assert syncs == []


def test_span_with_times_sums_and_syncs(syncs):
    times = {"prove.A": 1.0}
    for _ in range(2):
        with trace.span("prove.A", times):
            time.sleep(0.002)
    assert len(syncs) == 4  # both ends of both spans
    assert 1.004 <= times["prove.A"] < 1.5


class _Ranges:
    """Stands in for torch.profiler.record_function: logs each range's
    name as it opens and closes."""

    log: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.log.append(("open", self.name))

    def __exit__(self, *exc):
        self.log.append(("close", self.name))


def test_nested_spans_record_parent_request_and_self_time(syncs, monkeypatch):
    times = {}
    monkeypatch.setattr(torch.profiler, "record_function", _Ranges)
    _Ranges.log = []
    with trace.tracing() as tr:
        with trace.request("proof-7"):
            with trace.span("zk.outer", times):
                time.sleep(0.004)
                with trace.span("zk.inner"):
                    time.sleep(0.004)
                with trace.span("zk.inner"):
                    pass
        with trace.span("zk.after"):
            pass
    assert len(syncs) == 2  # only the span that asked for seconds
    assert [(s.name, s.parent, s.request) for s in tr.spans] == [
        ("zk.outer", -1, "proof-7"), ("zk.inner", 0, "proof-7"), ("zk.inner", 0, "proof-7"),
        ("zk.after", -1, None)]
    outer, inner, inner2, after = tr.spans
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= inner2.start_ns
    assert inner2.end_ns <= outer.end_ns <= after.start_ns
    [req] = tr.requests
    assert req.id == "proof-7" and req.start_ns <= outer.start_ns and outer.end_ns <= req.end_ns
    own = tr.self_ns()
    children = (inner.end_ns - inner.start_ns) + (inner2.end_ns - inner2.start_ns)
    assert own[0] == outer.end_ns - outer.start_ns - children
    assert own[0] >= 3_000_000 and own[1] >= 3_000_000
    assert abs(tr.wall_offset_ns + time.perf_counter_ns() - time.time_ns()) < 50_000_000
    assert _Ranges.log == [("open", "zk.outer"), ("open", "zk.inner"), ("close", "zk.inner"),
                           ("open", "zk.inner"), ("close", "zk.inner"), ("close", "zk.outer"),
                           ("open", "zk.after"), ("close", "zk.after")]


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fr", "bls12_381_fq"])
def test_field_rand_counts_host_bytes(name):
    F = field(FIELDS[name])
    gen = torch.Generator().manual_seed(5)
    before = F.rand_bytes
    F.rand(gen, (3, 2), "cpu")
    F.rand(gen, (), "cpu")
    # 2 K int32 limbs an element
    assert F.rand_bytes - before == 7 * 2 * F.k * 4


def test_check_counts_launch_elements():
    k = kernels.Kernel("probe", "none", "none")
    kernels.check(k, 0, 4096, FIELDS["bn254_fq"])
    kernels.check(k, 0, 12)
    assert (k.launches, k.elements, k.by_field) == (2, 4108, {"bn254_fq": 1})
    with pytest.raises(RuntimeError):
        kernels.check(k, 3, 99)
    assert (k.launches, k.elements) == (2, 4108)
