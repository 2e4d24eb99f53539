"""The benchmark's manifest, ``BENCHMARK.json``, and the files it names.

Every piece is found by name, so a later change adds a configuration, a
traffic mix, a driver kind or a per-layer metric as a new file and edits
none that exists:

    configuration   portbench/configs/<config>.json    (its "reference"
                    names its plain reference: portbench/reference/
                    <reference>.py)
    traffic mix     portbench/traffic/<traffic>.json   (its "kind" names
                    the general driver that reads it: portbench/drivers/
                    <kind>.py)
    cell limits     portbench/limits/<cell>.json       (the limit of each
                    number the check compares)
    per-layer       portbench/metrics/<metric name>.py (LAYER, UNIT,
    metric                                              MOVES, SOURCE, read)
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from dataclasses import dataclass

PACKAGE = pathlib.Path(__file__).resolve().parents[1]


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    reference: object        # the configuration's plain reference module

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


class Benchmark:
    """``BENCHMARK.json`` plus the lookups of the files it names, rooted at
    ``package`` (``portbench/``, or a copy of it in a test)."""

    def __init__(self, manifest: dict, package: pathlib.Path = PACKAGE):
        self.manifest = manifest
        self.package = pathlib.Path(package)
        self._modules = {}             # path -> module, loaded once

    @classmethod
    def load(cls, root: pathlib.Path, package: pathlib.Path = PACKAGE):
        with open(pathlib.Path(root) / "BENCHMARK.json") as f:
            return cls(json.load(f), package)

    # -- lookups ------------------------------------------------------------
    def _entry(self, key: str, name: str) -> dict:
        for e in self.manifest[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"{key} has no entry {name!r}: "
                       f"{[e['name'] for e in self.manifest[key]]}")

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        with open(self.package.parent / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.package / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, cell_name: str) -> dict:
        with open(self.package / "limits" / f"{cell_name}.json") as f:
            return {k: float(v) for k, v in json.load(f).items()}

    def reference(self, name: str):
        return self._load(self.package / "reference" / f"{name}.py",
                          f"portbench_reference_{name}")

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        config = self.config(w["config"])
        return Cell(name=name, config_name=w["config"],
                    traffic_name=w["traffic"], chips=int(w["chips"]),
                    config=config, traffic=self.traffic(w["traffic"]),
                    limits=self.limits(name),
                    reference=self.reference(config["reference"]))

    def end_to_end(self, cell: Cell) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.manifest["end_to_end"]
                if cell.name in m.get("workloads", [cell.name])]

    def per_layer(self, cell: Cell) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if (cell.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def driver(self, kind: str):
        return self._load(self.package / "drivers" / f"{kind}.py",
                          f"portbench_driver_{kind}")

    def metric(self, name: str):
        return self._load(self.package / "metrics" / f"{name}.py",
                          "portbench_metric_" + name.replace(".", "_")
                          .replace("-", "_"))

    def _load(self, path, module_name):
        if path not in self._modules:
            self._modules[path] = load_module(path, module_name)
        return self._modules[path]


def load_module(path: pathlib.Path, module_name: str):
    """Import a file by path (metric names hold dots, so the files are not
    importable as modules by name)."""
    path = pathlib.Path(path)
    if not path.exists():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
