"""The readers of the program's spans and counters (``spanstore.py``), each
on a synthetic store and view; a program without spans reads nothing; the
trace's ``RANGES`` are still names the port's spans give; a traced run on
the CPU records the spans the readers read."""

import re
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import devtrace
import harness

BENCH = harness.load_benchmark()
SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _rec(name, id, parent=None, device_s=0.0):
    return SimpleNamespace(name=name, id=id, parent=parent, device_s=device_s)


# two traced steps: each a train_step holding the loss head's two spans and
# the MoE's and the recurrence's backward, the MoE's holding a recomputation
STORE = [_rec("train_step", 0, None, 1.5), _rec("loss_head", 1, 0, 0.05),
         _rec("loss_head.bwd", 2, 0, 0.25), _rec("moe.bwd", 3, 0, 0.30),
         _rec("recompute", 4, 3, 0.10), _rec("moe_combine", 5, 4, 0.02),
         _rec("linear_recurrence.bwd", 6, 0, 0.08),
         _rec("train_step", 7, None, 1.5), _rec("loss_head", 8, 7, 0.05),
         _rec("loss_head.bwd", 9, 7, 0.25), _rec("moe.bwd", 10, 7, 0.30),
         _rec("recompute", 11, 10, 0.10), _rec("linear_recurrence.bwd", 12, 7, 0.08),
         _rec("prefill", 13, None, 0.6), _rec("prefill", 14, None, 0.6)]
COUNTERS = {"moe.slots": 1000.0, "moe.filled": 700.0}
TRAIN = {"kind": "train", "trace": {"busy_s": 2.7, "window_s": 3.2}, "traced_steps": 2}
SERVE = {"kind": "serve", "trace": {"busy_s": 1.02, "window_s": 1.4}, "traced_requests": 2}
WANT = {"loss_head_ms.train": (TRAIN, 300.0), "loss_head_ms.hybrid": (TRAIN, 300.0),
        "moe_bwd_ms.train": (TRAIN, 200.0), "recurrence_bwd_ms.train": (TRAIN, 80.0),
        "step_idle.train": (TRAIN, 10.0), "step_idle.hybrid": (TRAIN, 10.0),
        "prefill_idle.serve": (SERVE, 15.0), "moe_fill.train": (TRAIN, 70.0)}


@pytest.fixture
def store(monkeypatch):
    from repro_torch import spans

    monkeypatch.setattr(spans, "records", lambda: list(STORE))
    monkeypatch.setattr(spans, "counters", lambda: dict(COUNTERS))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_store(store, name):
    view, want = WANT[name]
    read = harness.metric_reader(name)
    assert read(dict(view)) == pytest.approx(want)
    other = SERVE if view is TRAIN else TRAIN  # the other kind of cell reads nothing
    assert read(dict(other)) is None
    assert read({**view, "trace": None}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    """Over a checkout whose program has no spans module the readers return
    None and raise nothing."""
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    view, _ = WANT[name]
    assert harness.metric_reader(name)(dict(view)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_new_metric_is_declared(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    cells = {w["name"]: harness.cell(BENCH, w["name"]) for w in BENCH["workloads"]}
    for cell in entry["workloads"]:
        assert entry["moves"] in {m["name"] for m in cells[cell]["end_to_end"]}


def test_ranges_are_names_the_ports_spans_give():
    """Every range the trace groups kernels by is opened through the port's
    ``spans.span`` under that name, and the port opens no range any other
    way."""
    opened, other = set(), []
    for path in SRC.rglob("*.py"):
        text = path.read_text()
        opened |= set(re.findall(r"span\(\s*\"([\w.]+)\"", text))
        if path.name != "spans.py" and "record_function" in text:
            other.append(path.name)
    assert set(devtrace.RANGES) <= opened and not other, (opened, other)
    assert {"train_step", "loss_head", "prefill", "moe", "linear_recurrence"} <= opened


@pytest.mark.parametrize("name,want", [("granite-moe-1b-a400m.train-8x4k",
                                        {"train_step", "loss_head.bwd", "moe.bwd"}),
                                       ("hymba-1.5b.train-2x8k",
                                        {"train_step", "loss_head.bwd", "linear_recurrence.bwd"}),
                                       ("hymba-1.5b.serve-32k", {"prefill", "linear_recurrence"})])
def test_a_traced_run_records_the_spans(small_cell, name, want):
    """The run's profile turns the spans on: its traced steps or
    prefills are what the store holds after the run. On the CPU no span
    has a device interval, so the span readers read nothing; the MoE's
    counters need none."""
    import torch

    import drive_serve
    import drive_train
    from repro_torch import spans

    cell = small_cell(name, "float32")
    run_cell = drive_train.run if cell["mix"]["kind"] == "train" else drive_serve.run
    got = run_cell(cell, 2**31 + 17, 0.3, True, torch.device("cpu"), 0.0)
    recs = spans.records()
    top = [r for r in recs if r.parent is None]
    traced = got["view"].get("traced_steps") or got["view"]["traced_requests"]
    assert want <= {r.name for r in recs} and len(top) == traced and spans.unclosed() == 0
    for m in cell["per_layer"]:
        value = harness.metric_reader(m["name"])(got["view"])
        if m["name"] == "moe_fill.train":
            assert 0 < value <= 100
        elif m["name"] in WANT:
            assert value is None
