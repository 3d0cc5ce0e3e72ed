"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its scene (``scenes/<name>.py``), its limits
(``checks/<cell>.json``) and the readers of its metrics
(``metrics/<name>.py``). A new cell, configuration, mix, scene or metric is
a new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _entry(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT, here: Path = HERE):
        spec = benchmark_spec(root)
        self.spec = spec
        self.name = name
        self.workload = _entry(spec["workloads"], name, "workload")
        self.config_entry = _entry(spec["configs"], self.workload["config"],
                                   "configuration")
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(here / "traffic" /
                                 f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])
        check = here / "checks" / f"{name}.json"
        self.limits = load_json(check)["limits"] if check.exists() else None
        self.here = here

    @property
    def params(self) -> dict:
        return self.config["params"]

    def metrics(self, trace: bool):
        """The metric entries this cell reports: its end-to-end metrics
        without ``--trace``, its per-layer metrics with it."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        return _module(self.here, "metrics", metric).read

    def scene(self):
        return _module(self.here, "scenes", self.traffic["scene"])


def _module(here: Path, kind: str, name: str):
    """Load ``<here>/<kind>/<name>.py`` by its path."""
    path = here / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{kind[:-1]} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"_benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
