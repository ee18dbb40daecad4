"""BENCHMARK.json against the benchmark's contract, and against the
files the harness finds by name."""

import json
import re
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert MAN["command"][1] == "perfbench/run.py" and len(MAN["command"]) <= 32
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _all_names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[section]:
            yield section, entry


@pytest.mark.parametrize("section,entry", list(_all_names()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_text(section, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry and section != "end_to_end" and section != "per_layer":
            assert TEXT.match(entry[key])
    if section == "per_layer":
        assert TEXT.match(entry["layer"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_unique_names():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_agree_with_the_manifest(cell):
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    spec = json.loads((PB / "workloads" / f"{cell}.json").read_text())
    for key in ("config", "traffic", "chips", "why"):
        assert spec[key] == entry[key]
    assert entry["chips"] in (1, 4)
    assert (PB / "configs" / f"{entry['config']}.json").exists()
    traffic = json.loads((PB / "traffic" / f"{entry['traffic']}.json").read_text())
    assert (PB / "traffic" / f"{traffic['driver']}.py").exists()
    assert spec["limits"], "every cell compares some number"
    e2e = [m["name"] for m in MAN["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in MAN["per_layer"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e


def test_every_metric_has_a_reader_and_every_config_its_file():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/")
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_layers_of_one_name_per_layer():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["moves"])
    assert all(len(v) == 1 for v in layers.values())
