"""``BENCHMARK.json`` and the files it names: a configuration is
``configs/<name>.json``, a traffic mix ``traffic/<name>.json``, a cell's
comparison limits ``limits/<workload>.json`` and a per-layer metric's
reader ``metrics/<name>.py``, all under the benchmark's folder."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Manifest:
    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json")):
        self.data = _load_json(path)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration file of ``name`` (its ``file`` entry)."""
        for c in self.data["configs"]:
            if c["name"] == name:
                return _load_json(os.path.join(ROOT, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name: str) -> dict:
        return _load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))

    @staticmethod
    def limits(workload: str) -> dict:
        return _load_json(os.path.join(BENCH_DIR, "limits", f"{workload}.json"))

    def end_to_end(self, workload: str) -> list[dict]:
        """Every cell reports every end-to-end metric."""
        self.workload(workload)
        return list(self.data["end_to_end"])

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics whose ``workloads`` list the cell."""
        return [m for m in self.data["per_layer"]
                if workload in m["workloads"]]

    @staticmethod
    def reader(name: str):
        """The module of ``metrics/<name>.py`` (its ``read(ctx)``)."""
        path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "cardbench_metric_" + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
