"""`correct` catches what it must: a run of the tiny cell on the CPU, with
the look for a card skipped, comes out correct as the program stands and
not correct under each control and each fault of zkbench/faults.py."""

import pytest

from conftest import tiny_bench
from zkbench import faults, harness


@pytest.mark.parametrize("plant", ("none",) + faults.CONTROLS + faults.FAULTS)
def test_correct_only_without_a_plant(plant, tiny_tree, tmp_path):
    kw = dict(device="cpu", root=tiny_tree, cache=str(tmp_path), bench=tiny_bench())
    if plant == "none":
        res = harness.run_cell("tiny.serial", 2**36 + 11, 0, False, **kw)
    else:
        with faults.planted(plant):
            res = harness.run_cell("tiny.serial", 2**36 + 11, 0, False, **kw)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["attempted"] == 2 and "proof_s" in res["metrics"]
    assert res["correct"] == (plant == "none"), checks
    if plant in ("masks_reused", "fft_masks_reused", "degred_half_stale"):
        # the proofs are right; both share their masks, or a part of them
        assert checks == {"proofs_wrong": 0, "masks_reused": 2}
    elif plant != "none":
        assert checks["proofs_wrong"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("plant", faults.CONTROLS)
def test_controls_fail_on_the_card(plant, cuda_card, tmp_path):
    """The controls at the cells' own size on the card, three seeds each
    (zkbench/control.py makes the same runs and prints their readings)."""
    from zkbench import loader

    for cell in (w["name"] for w in loader.benchmark()["workloads"]):
        for seed in (2**33 + 1, 2**33 + 2, 2**33 + 3):
            with faults.planted(plant):
                res = harness.run_cell(cell, seed, 5, False, "cuda")
            assert not res["correct"]
