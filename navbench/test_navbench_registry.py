"""Cells, configurations, mixes, limits and metric readers resolve by name,
and BENCHMARK.json keeps to the shape the harness reads."""

import dataclasses
import json
import re

import pytest

import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = harness.cell(BENCH, name)
    assert c["cfg"]["name"] == c["config"] and c["mix"]["kind"] in ("train", "serve")
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"], "every cell reports a per-layer metric"
    assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())
    for m in c["per_layer"]:
        assert callable(harness.metric_reader(m["name"])) and m["moves"] in e2e


def test_names_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert all(w in CELLS for w in m.get("workloads", []))
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_configuration_run(entry):
    """Every number the file gives the program is the port's registry
    value (nothing is cut: ``reduced`` is empty)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig

    cfg = harness.config_file(entry["name"])
    assert entry["file"] == f"navbench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    port, run = get_config(cfg["arch"]), harness.port_config(cfg)
    for f in dataclasses.fields(ArchConfig):
        if f.name not in ("name", "source", "head_dim"):
            assert getattr(run, f.name) == getattr(port, f.name), f.name
    assert run.resolved_head_dim == port.resolved_head_dim


def test_a_reader_without_a_trace_reads_nothing():
    view = {"kind": "train", "trace": None, "steps": 0, "traced_steps": 0}
    for m in BENCH["per_layer"]:
        assert harness.metric_reader(m["name"])(dict(view)) is None
