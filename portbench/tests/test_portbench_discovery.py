"""Configurations, traffic mixes, cells and per-layer metrics added as
new files (and entries of BENCHMARK.json) are found by name: no existing
file of portbench/ changes.  That holds for a second family too, with a
driver kind, a plain reference and limits of its own."""
import hashlib
import json
import pathlib
import shutil

from portbench.harness import manifest
from portbench.tests import _tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return pb, _digests(pb), json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_files_are_found_with_no_other_edit(tmp_path):
    pb, before, m = _copy(tmp_path)
    cfg = json.loads((pb / "configs" / "ser-cnn.json").read_text())
    cfg["name"] = "ser-cnn-wide"
    (pb / "configs" / "ser-cnn-wide.json").write_text(json.dumps(cfg))
    old = bench_cell = m["workloads"][0]
    tr = json.loads((pb / "traffic" / f"{old['traffic']}.json").read_text())
    tr["num_clients"] = 120
    (pb / "traffic" / "sigma-sweep-pop120.json").write_text(json.dumps(tr))
    new = "ser-cnn-wide.sigma-sweep-pop120"
    (pb / "limits" / f"{new}.json").write_text(json.dumps(
        {"bookkeeping_mismatches": 0, "params_gap": 2e-3}))
    (pb / "metrics" / "evals_per_point.fl.py").write_text(
        'LAYER = "engine (engine/engine.py, engine/cohort.py)"\n'
        'UNIT = "evals"\nMOVES = "member_steps_per_s"\n'
        'SOURCE = "program_counter"\n\n\ndef read(run):\n    return 6\n')
    m["configs"].append({"name": "ser-cnn-wide", "source": "x",
                         "file": "portbench/configs/ser-cnn-wide.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": new, "config": "ser-cnn-wide",
                           "traffic": "sigma-sweep-pop120", "chips": 1,
                           "why": "x"})
    m["end_to_end"][0]["workloads"].append(new)
    m["per_layer"].append({"name": "evals_per_point.fl", "unit": "evals",
                           "better": "lower", "source": "program_counter",
                           "layer": "engine (engine/engine.py, "
                                    "engine/cohort.py)",
                           "moves": "member_steps_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    bench = manifest.Benchmark.load(tmp_path, pb)
    cell = bench.cell(new)
    assert cell.config["name"] == "ser-cnn-wide"
    assert cell.traffic["num_clients"] == 120
    assert cell.limits == {"bookkeeping_mismatches": 0.0, "params_gap": 2e-3}
    assert bench.driver(cell.kind).RATE == "member_steps_per_s"
    names = [x["name"] for x in bench.per_layer(cell)]
    assert "evals_per_point.fl" in names
    assert bench.metric("evals_per_point.fl").read(None) == 6
    # a metric with no workloads list reaches every cell reporting its
    # end-to-end metric, the old cell too
    old = bench.cell(bench_cell["name"])
    assert "evals_per_point.fl" in [x["name"] for x in bench.per_layer(old)]
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before


# a second family: least squares by full-batch gradient descent, with a
# driver kind, a plain reference and limits of its own
TOY_DRIVER = '''
import torch
from portbench.harness.runner import Work
RATE = "toy_steps_per_s"

def data(cell, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(cell.traffic["rows"], cell.config["width"], generator=g)
    return x.to(device), (x @ torch.linspace(-1, 1, x.shape[1])).to(device)

def setup(cell, seed, device):
    x, y = data(cell, seed, device)
    return {"x": x, "y": y, "w": torch.zeros(x.shape[1], device=device),
            "lr": cell.traffic["lr"], "steps": cell.traffic["steps"]}

def window(state, seconds, tracer):
    x, y, w = state["x"], state["y"], state["w"]
    for _ in range(state["steps"]):
        w -= state["lr"] * x.T @ (x @ w - y) / x.shape[0]
        tracer.tick()
    return Work(RATE, state["steps"], attempted=1, failed=0)

def release(state):
    return {"w": state["w"].cpu()}

def readings(outputs, cell, seed, device):
    x, y = data(cell, seed, "cpu")
    want = cell.reference.fit(x.double(), y.double(), cell.traffic["lr"],
                              cell.traffic["steps"])
    return {"w_gap": float((outputs["w"].double() - want).norm()
                           / want.norm())}

def control(outputs, cell, seed, device):
    x, y = data(cell, seed, "cpu")
    low = cell.reference.fit(x.half().float(), y.half().float(),
                             cell.traffic["lr"], cell.traffic["steps"])
    return readings({"w": low}, cell, seed, device)
'''
TOY_REFERENCE = '''
def fit(x, y, lr, steps):
    w = x.new_zeros(x.shape[1])
    for _ in range(steps):
        w = w - lr * x.T @ (x @ w - y) / x.shape[0]
    return w
'''


def test_a_second_family_runs_from_new_files_alone(tmp_path):
    pb, before, m = _copy(tmp_path)
    (pb / "drivers" / "toy_fit.py").write_text(TOY_DRIVER)
    (pb / "reference" / "toy_ref.py").write_text(TOY_REFERENCE)
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "reference": "toy_ref", "width": 16,
         "reduced": []}))
    (pb / "traffic" / "fit-64.json").write_text(json.dumps(
        {"kind": "toy_fit", "rows": 64, "lr": 0.1, "steps": 20}))
    (pb / "limits" / "toy.fit-64.json").write_text(json.dumps(
        {"w_gap": 1e-5}))
    (pb / "metrics" / "steps_traced.toy.py").write_text(
        'LAYER = "toy"\nUNIT = "steps"\nMOVES = "toy_steps_per_s"\n'
        'SOURCE = "program_counter"\n\n\ndef read(run):\n'
        '    return run.work.units\n')
    m["configs"].append({"name": "toy", "source": "x",
                         "file": "portbench/configs/toy.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "toy.fit-64", "config": "toy",
                           "traffic": "fit-64", "chips": 1, "why": "x"})
    m["end_to_end"].append({"name": "toy_steps_per_s", "unit": "steps/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["toy.fit-64"]})
    m["per_layer"].append({"name": "steps_traced.toy", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "toy", "moves": "toy_steps_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    bench = manifest.Benchmark.load(tmp_path, pb)
    cell = bench.cell("toy.fit-64")
    out = _tiny.run(cell, seed=3, bench_=bench)
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"toy_steps_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert list(out["compared"]) == ["w_gap"]
    # its control fails the limit the new file sets
    from portbench.harness import runner
    drv = bench.driver(cell.kind)
    low = runner.compare(drv.control(None, cell, 3, "cpu"), cell.limits)
    assert not low["w_gap"]["ok"], low
    # the old cell still finds its own pieces
    assert bench.cell(m["workloads"][0]["name"]).limits
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
