"""Every part of the benchmark is a file found by its name, and
BENCHMARK.json agrees with the files."""

import json
import os
import re

import pytest

from conftest import ROOT, make_tree
from zkbench import loader

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_new_cell_and_metric_files_are_found_by_name(tmp_path):
    root = make_tree(str(tmp_path))
    with open(os.path.join(root, "workloads", "new-cell.serial.json"), "w") as f:
        json.dump({"config": "sha256-bn254-n8l2", "traffic": "serial", "chips": 1,
                   "why": "added as a file"}, f)
    with open(os.path.join(root, "metrics", "twice_setup.s.py"), "w") as f:
        f.write("def read(record):\n    return 2 * record['setup_s']\n")
    cell = loader.cell("new-cell.serial", root)
    assert loader.config(cell["config"], root)["curve"] == "bn254"
    assert loader.traffic(cell["traffic"], root)["loop"] == "closed"
    assert loader.metric_reader("twice_setup.s", root)({"setup_s": 2.0}) == 4.0
    # a variant with no file of its own is read by its base's file
    assert loader.metric_reader("twice_setup.s.card", root)({"setup_s": 2.0}) == 4.0
    with pytest.raises(FileNotFoundError):
        loader.metric_reader("no_such_metric.card", root)
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["other"]}],
             "per_layer": [{"name": "c"}]}
    assert [m["name"] for m in loader.metrics_for(bench, "new-cell.serial", False)] == ["a"]
    assert [m["name"] for m in loader.metrics_for(bench, "new-cell.serial", True)] == ["c"]
    with pytest.raises(FileNotFoundError):
        loader.cell("no-such-cell", root)
    with pytest.raises(ValueError):
        loader.cell("../configs/tiny", root)


def test_benchmark_json_agrees_with_the_files():
    bench = loader.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for w in bench["workloads"]:
        cell = loader.cell(w["name"])
        assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == cell
        loader.traffic(w["traffic"])
        assert w["config"] in {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = loader.config(c["name"])
        assert c["file"] == f"zkbench/configs/{c['name']}.json"
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
        loader.circuit(cfg["circuit"]["kind"])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and callable(loader.metric_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        # every cell that reports the metric reports the end-to-end metric it moves
        for c in m.get("workloads", cells):
            assert c in cells
            assert m["moves"] in {e["name"] for e in loader.metrics_for(bench, c, False)}
    for c in cells:
        reported = {e["name"] for e in loader.metrics_for(bench, c, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert loader.metrics_for(bench, c, True)
    assert os.path.exists(os.path.join(ROOT, bench["command"][1]))
