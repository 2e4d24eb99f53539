"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name under portbench/."""
import json
import pathlib
import re

import pytest

from portbench.harness import manifest

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.Benchmark.load(ROOT)


def test_manifest_keys_and_limits(bench):
    m = bench.manifest
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"][:1] == ["python3"] and len(m["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in m["command"])
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in m[k]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        ns = [e["name"] for e in m[key]]
        assert len(ns) == len(set(ns))
    metrics = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_full_check_fits_the_budget(bench):
    # 2 + 14 x cells runs at run_seconds + 60 s, 2 x 90 s a cell, 1200
    # spare, all within 43200 s at the full 24 cells
    rs = bench.manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_metrics_follow_the_contract(bench):
    m = bench.manifest
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    cells = {w["name"] for w in m["workloads"]}
    for e in m["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert e["source"] in SOURCES and UNIT.match(e["unit"])
        assert e["moves"] in e2e
        for w in e.get("workloads", []):
            assert w in cells
            reports = e2e[e["moves"]].get("workloads", list(cells))
            assert w in reports, (e["name"], w)
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"
    for w in m["workloads"]:
        cell = bench.cell(w["name"])
        got = {x["name"] for x in bench.end_to_end(cell)}
        assert "setup_s" in got and len(got) >= 2
        assert bench.per_layer(cell)
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_every_piece_is_found_by_name(bench):
    m = bench.manifest
    for c in m["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = bench.config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert (ROOT / "portbench" / "reference"
                / f"{cfg['reference']}.py").exists()
    for w in m["workloads"]:
        cell = bench.cell(w["name"])
        driver = bench.driver(cell.kind)
        for fn in ("setup", "window", "release", "readings", "control"):
            assert callable(getattr(driver, fn))
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        assert callable(cell.reference.run_fedasync) or cell.kind != \
            "fl_sweep"
    for e in m["per_layer"]:
        mod = bench.metric(e["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            e["layer"], e["unit"], e["moves"], e["source"])
        assert callable(mod.read)


def test_traffic_and_configs_are_data(bench):
    for w in bench.manifest["workloads"]:
        tr = json.loads((ROOT / "portbench" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        assert "kind" in tr
        assert (ROOT / "portbench" / "drivers" / f"{tr['kind']}.py").exists()
