"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import os
import re

import pytest

from cardbench.harness.manifest import BENCH_DIR, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "cardbench/run.py"]
    assert bench["paths"] == ["cardbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))


def test_every_file_resolves_by_name(bench):
    m = Manifest()
    for c in bench["configs"]:
        assert c["file"].startswith("cardbench/")
        cfg = m.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
        m.traffic(w["traffic"])
        limits = m.limits(w["name"])
        assert limits["frames"] >= 1
        assert len(m.end_to_end(w["name"])) >= 2
        assert m.per_layer(w["name"])
    for metric in bench["per_layer"]:
        assert callable(m.reader(metric["name"]).read)
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           metric["name"] + ".py"))


def test_per_layer_metrics_move_fps(bench):
    cells = {w["name"] for w in bench["workloads"]}
    reporting_fps = {c for c in cells
                     if "fps" in {m["name"] for m in Manifest().end_to_end(c)}}
    for metric in bench["per_layer"]:
        assert metric["moves"] == "fps"
        assert metric["workloads"] and set(metric["workloads"]) <= reporting_fps
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    layers = {m["layer"] for m in bench["per_layer"]}
    assert {"host dispatch", "device", "backbones", "kernels"} <= layers


def test_end_to_end_bounds(bench):
    names = {m["name"]: m for m in bench["end_to_end"]}
    assert {"fps", "frame_ms_p95", "setup_s"} <= set(names)
    for m in bench["end_to_end"]:
        assert "workloads" not in m          # every cell reports each
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert names["setup_s"]["bound"] <= 0.25
