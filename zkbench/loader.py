"""Find the benchmark's parts by name.

Everything that belongs to one configuration, cell, traffic mix, circuit or
metric is a file of its own under zkbench/, found by the name that
BENCHMARK.json or a cell gives it:

  configs/<config>.json     one configuration (a deployment)
  workloads/<cell>.json     one cell: its configuration, traffic and chips
  traffic/<traffic>.json    one traffic mix's parameters
  circuits/<kind>.py        one circuit generator
  metrics/<metric>.py       one metric's reader: read(record) -> float | None
                            (<metric>.<variant> falls back to <metric>.py)

So a later change adds a cell, a traffic mix, a circuit or a metric as a
file, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

ZKBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(ZKBENCH)
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not _NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def _json(root: str, folder: str, name: str) -> dict:
    path = os.path.join(root, folder, f"{_checked(name)}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder[:-1] if folder.endswith('s') else folder} "
                                f"named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: str = ZKBENCH) -> dict:
    return _json(root, "workloads", name)


def config(name: str, root: str = ZKBENCH) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: str = ZKBENCH) -> dict:
    return _json(root, "traffic", name)


def circuit(kind: str):
    """The generator module circuits/<kind>.py (draw_inputs, statement,
    synthesize)."""
    if not kind.isidentifier():
        raise ValueError(f"{kind!r} is not a circuit kind")
    return importlib.import_module(f"zkbench.circuits.{kind}")


def metric_reader(name: str, root: str = ZKBENCH):
    """read(record) of metrics/<name>.py.  A name `<base>.<variant>` with no
    file of its own is read by metrics/<base>.py: the same quantity, in
    cells where it moves another end-to-end metric."""
    path = os.path.join(root, "metrics", f"{_checked(name)}.py")
    base = os.path.join(root, "metrics", f"{name.rpartition('.')[0]}.py")
    if not os.path.exists(path) and "." in name and os.path.exists(base):
        path = base
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"zkbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with `workloads` only in those."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]
