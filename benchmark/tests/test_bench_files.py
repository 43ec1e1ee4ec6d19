"""BENCHMARK.json and the files it names: every configuration, cell and
metric file parses and is found by name, and every cell reports the
metrics the contract asks of it."""

import ast
import importlib
import json
import os
import re

from benchmark.run import cell_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def test_configs_and_cells_load():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        importlib.import_module(f"benchmark.pipelines.{cfg['pipeline']}")
        for name, (side, limit) in cfg["checks"].items():
            assert side in ("<=", ">=") and limit is not None, name
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        with open(os.path.join(ROOT, "benchmark", "workloads",
                               f"{w['name']}.json")) as f:
            wl = json.load(f)
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        assert len(w["why"]) <= 200


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert callable(mod.read)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for w in b["workloads"]:
        e2e = {m["name"] for m in cell_metrics(b, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell_metrics(b, w["name"], True)


# the helpers through which a reader reads a layer: (rec, layer, ...)
LAYER_READERS = {"ms_per_frame", "per_frame"}


def layers_read(metric: str) -> set:
    """The layers the reader of `metric` names in its calls of the layer
    helpers of `metrics/_timings.py` and `metrics/_program.py`."""
    with open(os.path.join(ROOT, "benchmark", "metrics",
                           f"{metric}.py")) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) \
                in LAYER_READERS:
            layer = node.args[1]
            assert isinstance(layer, ast.Constant), metric
            out.add(layer.value)
    return out


def test_every_layer_a_cells_metrics_read_is_timed_in_its_config():
    """A per-layer metric that reads a layer's timings or its stages'
    ranges finds that layer in the `timings` of every cell it lists."""
    b = bench()
    configs = {}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            configs[c["name"]] = json.load(f)
    read = {m["name"]: layers_read(m["name"]) for m in b["per_layer"]}
    assert read["tracker_ms_per_frame"] == {"tracker"}
    assert read["solve_idle_ms_per_frame"] == {"solve"}
    for w in b["workloads"]:
        timings = configs[w["config"]]["timings"]
        for m in cell_metrics(b, w["name"], True):
            missing = read[m["name"]] - set(timings)
            assert not missing, (w["name"], m["name"], missing)
