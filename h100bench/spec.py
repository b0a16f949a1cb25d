"""The benchmark's data files, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``h100bench/configs/<config>.json``: the
model's sizes and how its weights are drawn) and a traffic mix
(``h100bench/traffic/<traffic>.json``: the training job, its batch shape and
its distinct batches). ``h100bench/limits/<cell>.json`` holds the limit of
each number the correctness check compares. Nothing here imports torch.
"""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT, cell: dict = None) -> dict:
    """{"cell", "config", "traffic", "limits", "per_layer"} of a cell of
    ``BENCHMARK.json``: the per-layer metrics are those whose ``workloads``
    list the cell, or that have none. ``cell`` stands in for the entry of
    a cell that ``BENCHMARK.json`` leaves out while its files stay."""
    bench = benchmark(root)
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell is None and name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[name] if cell is None else cell
    return {
        "cell": cell,
        "config": read_json(HERE / "configs" / f"{cell['config']}.json"),
        "traffic": read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": read_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])],
    }
