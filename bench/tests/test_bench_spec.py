"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it resolves to a file the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"][1].startswith("bench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    # a full check with 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [m["name"] for m in _metrics()] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in _metrics():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        has = [n for n, m in e2e.items()
               if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in has and len(has) >= 2
        layer = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert layer
        for m in layer:
            assert m["moves"] in has
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells


def test_files_resolve_by_name():
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in _metrics():
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    import sys
    sys.path.insert(0, str(ROOT / "bench"))
    from harness.spec import load_cell
    cell = load_cell(w["name"], ROOT)
    assert cell.config["name"] == w["config"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
