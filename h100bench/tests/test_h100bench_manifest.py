"""BENCHMARK.json against the rules it must keep, and every file it names
against the harness that reads it."""
import importlib
import json
import re
from pathlib import Path

import pytest

from h100bench.check import NUMBERS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {c["name"]: c for c in BENCH["workloads"]}
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                   r"_rank$|expan|d_model|d_ff|experts_per)")


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and (ROOT / p).is_dir()


def test_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", sorted(n for n in [m["name"] for m in METRICS]
                                        + list(CELLS) + list(CONFIGS)))
def test_names(name):
    assert NAME.match(name)


def test_names_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if metric in BENCH["end_to_end"] else {"layer",
                                                            "moves"}
    assert keys <= set(metric) <= keys | {"workloads"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                                "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric.get("workloads", list(CELLS)):
        assert reports(cell, moved)
    reader = importlib.import_module(f"h100bench.metrics.{metric['name']}")
    assert callable(reader.read)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell(cell):
    c = CELLS[cell]
    assert set(c) == {"name", "config", "traffic", "chips", "why"}
    assert c["chips"] in (1, 4) and 1 <= len(c["why"]) <= 200
    assert c["config"] in CONFIGS
    assert (ROOT / "h100bench" / "traffic" / f"{c['traffic']}.json").is_file()
    limits = json.loads(
        (ROOT / "h100bench" / "limits" / f"{cell}.json").read_text())
    assert set(limits) == set(NUMBERS)
    assert limits["clock_mismatch"] == 0
    e2e = [m for m in BENCH["end_to_end"] if reports(cell, m)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(reports(cell, m) for m in BENCH["per_layer"])


def test_four_chip_cells_within_share():
    four = sum(c["chips"] == 4 for c in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_config(config):
    c = CONFIGS[config]
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["source"].startswith("https://") and len(c["why"]) <= 200
    assert c["file"].startswith("h100bench/")
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["name"] == config and body["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in c["reduced"])
    assert any(w["config"] == config for w in BENCH["workloads"])
    files = [x["file"] for x in BENCH["configs"]]
    assert files.count(c["file"]) == 1
