"""Shared fixtures of the benchmark's tests.

Tests that need a CUDA card carry the `card` marker and take the
`cuda_card` fixture, which skips them where there is none; whether there
is a card is decided there, when the test runs, never at import.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = {"source": "examples/e2e_small.py", "circuit": {"kind": "square_chain",
               "squarings": 10}, "curve": "bn254", "reduction": "circom", "n": 8, "l": 2,
               "t": 2, "transport": "local", "crs_seed": 123, "constraints": 11, "domain": 16,
               "reduced": []}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")


def make_tree(dest: str) -> str:
    """A copy of zkbench's data folders with a tiny cell, `tiny.serial`
    (x -> x^(2^10) over BN254, n = 8, l = 2), that the CPU proves in
    seconds a proof."""
    src = os.path.join(ROOT, "zkbench")
    for folder in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(os.path.join(src, folder), os.path.join(dest, folder))
    with open(os.path.join(dest, "configs", "tiny.json"), "w") as f:
        json.dump(TINY_CONFIG, f)
    with open(os.path.join(dest, "workloads", "tiny.serial.json"), "w") as f:
        json.dump({"config": "tiny", "traffic": "serial", "chips": 1, "why": "tests"}, f)
    return dest


def tiny_bench() -> dict:
    """BENCHMARK.json with the tiny cell beside the real ones; it reports
    the metrics of the BN254 cell, the one it is a tiny copy of."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.serial", "config": "tiny", "traffic": "serial",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sha256-bn254.serial" in m.get("workloads", []):
            m["workloads"].append("tiny.serial")
    return bench


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    import torch

    torch.set_num_threads(1)
    return make_tree(str(tmp_path_factory.mktemp("zkbench")))
