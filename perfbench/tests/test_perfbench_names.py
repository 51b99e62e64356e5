"""BENCHMARK.json against the benchmark's contract: names, units, keys,
lengths, and a file for every configuration, cell, limit and reader."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E = {e["name"] for e in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = [c["name"] for c in BENCH["configs"]] + list(CELLS) + [m["name"] for m in
                                                                   BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E


def test_every_cell_has_its_files_and_metrics():
    pairs = set()
    for name, w in CELLS.items():
        pairs.add((w["config"], w["traffic"]))
        wl = json.loads((ROOT / "perfbench" / "workloads" / f"{name}.json").read_text())
        assert wl["config"] == w["config"] and wl.get("chips", 1) == w["chips"]
        assert (ROOT / "perfbench" / "limits" / f"{name}.json").exists()
        assert (ROOT / "perfbench" / "drivers" / f"{wl['driver']}.py").exists()
        e2e = [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"] if name in m.get("workloads", CELLS)]
        assert layer and all(m["moves"] in e2e for m in layer)
    assert len(pairs) == len(CELLS)
    assert sum(w["chips"] == 4 for w in CELLS.values()) <= max(1, len(CELLS) // 4)


def test_configs_files_and_readers():
    used = {w["config"] for w in CELLS.values()}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_limits_name_numbers_the_check_gives(name):
    lim = json.loads((ROOT / "perfbench" / "limits" / f"{name}.json").read_text())
    assert lim["limits"] and all(isinstance(v, (int, float)) and v >= 0 for v in lim["limits"].values())
