"""The benchmark's registry: cells, configurations, traffic, limits and
metric readers, each found by its name in ``BENCHMARK.json``.

* ``configs/<config>.json``: the configuration as it is run (the program's
  ``ArchConfig`` fields at the top level, ``arch`` its registry name), with
  its source, departures, ``assumed`` and ``reduced``;
* ``traffic/<mix>.json``: the mix's parameters; ``kind`` names the driver
  (``train`` or ``serve``) that reads them;
* ``limits/<cell>.json``: the limit of each number the cell's comparison
  decides ``correct`` by (``compare.py``);
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(view) ->
  float | None`` (None: nothing to read, and the metric is left out).

A later change adds a cell, a mix, a configuration or a metric as new files
and entries; none of these files needs an edit for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_benchmark(root: Path = REPO) -> dict:
    return _json(root / "BENCHMARK.json")


def config_file(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits_file(cell: str) -> dict:
    return _json(HERE / "limits" / f"{cell}.json")


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py`` (loaded by path: names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"navbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str, e2e_of_cell: set[str]) -> bool:
    """A per-layer metric is read in the cells it lists, or else in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_of_cell


def cell(bench: dict, name: str) -> dict:
    """The cell ``name`` with its files read and its metrics listed."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return {**entry, "cfg": config_file(entry["config"]), "mix": traffic_file(entry["traffic"]),
            "limits": limits_file(name), "end_to_end": e2e, "per_layer": per_layer}


MODEL_KEYS = ("name", "source")  # ArchConfig fields the file keeps as its own


def port_config(cfg: dict):
    """The program's ``ArchConfig`` of a configuration file: its registry
    entry with every field the file sets."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)} - set(MODEL_KEYS)
    return get_config(cfg["arch"]).with_(**{k: v for k, v in cfg.items() if k in fields})


def sync(dev) -> None:
    """Wait for the device (nothing to wait for on the CPU, where the tests
    drive a run)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, and the result as the last line of standard output, ``checks``
    its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps({**result, "checks": checks}), flush=True)
