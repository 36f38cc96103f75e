"""A run driven on the CPU at a small size, past the harness's look for a
card: the port agrees with the plain reference, the result line has the
contract's keys, and each fault planted under the timed path turns
``correct`` false against the cell's limits."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout
from types import SimpleNamespace

import pytest
import torch

import compare
import drive_serve
import drive_train
import faults
import harness
import run

CPU = torch.device("cpu")
TRAIN = ["granite-moe-1b-a400m.train-8x4k", "hymba-1.5b.train-2x8k"]
SERVE = ["hymba-1.5b.serve-32k"]
FAKE_TORCH = SimpleNamespace(cuda=SimpleNamespace(get_device_name=lambda i: "cpu"))


def drive(cell, fault=None, traced=False, seed=2**31 + 11):
    driver = drive_train.run if cell["mix"]["kind"] == "train" else drive_serve.run
    return driver(cell, seed, 0.5, traced, CPU, 0.0, fault)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_float32_port_equals_the_reference(small_cell, name):
    """In float32 the port and the reference agree to rounding."""
    got = drive(small_cell(name, "float32"))
    numbers = {k: v for k, v in got["numbers"].items() if not k.startswith("_")}
    assert numbers and all(v < 1e-5 for v in numbers.values()), numbers
    ok, _ = compare.judge(got["numbers"], small_cell(name)["limits"])
    assert ok and got["failed"] == 0 and got["attempted"] > 0


@pytest.mark.parametrize("name,traced", [(n, t) for n in TRAIN + SERVE for t in (False, True)])
def test_result_line_keys(small_cell, name, traced):
    cell = small_cell(name, "float32")
    got = drive(cell, traced=traced)
    out, checks = run.result(cell, got, traced, FAKE_TORCH)
    buf_out, buf_err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf_out), redirect_stderr(buf_err):
        harness.emit(out, checks)
    line = json.loads(buf_out.getvalue().splitlines()[-1])
    keys = list(line)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert keys == want + (["breakdown"] if traced else []) + ["checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if traced else set())
    if not traced:
        assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert set(line["checks"]) == set(cell["limits"])
    assert buf_err.getvalue().splitlines()[-len(checks):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAIN for f in ("unchanged", "half_batch")]
                         + [(n, "altered_token") for n in SERVE])
def test_a_planted_fault_is_not_correct(small_cell, name, fault):
    cell = small_cell(name, "float32", wide=name in SERVE)
    got = drive(cell, faults.BY_NAME[fault])
    ok, checks = compare.judge(got["numbers"], cell["limits"])
    assert not ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_train_state_is_the_programs_own(small_cell, name):
    """The state set-up builds has ``make_init_fn``'s leaves, in its order,
    with its dtypes and counters; the parameters and master copy hold the
    benchmark's weights and the moments are zero."""
    from repro_torch.distributed.steps import make_init_fn

    import weights

    t = drive_train.Train(small_cell(name, "bfloat16"), CPU)
    seed = 2**31 + 5
    got = weights.flatten(t.state(seed))
    want = weights.flatten(make_init_fn(t.port, t.opt_cfg, seed=0, device=CPU)())
    assert list(got) == list(want)
    w = weights.make(t.cfg, seed, CPU)
    for path, ref in want.items():
        assert (got[path].shape, got[path].dtype) == (ref.shape, ref.dtype), path
        head, _, leaf = path.partition("/")
        if head == "params":
            assert torch.equal(got[path], w[leaf]), path
        elif path.startswith("opt/master/"):
            assert torch.equal(got[path], w[path[len("opt/master/"):]].float()), path
        else:
            assert torch.equal(got[path], ref), path
