"""Each copy in the yardstick equals the program's function it was copied
from, at the configurations' shapes, so that a drift shows here and never
in the yardstick."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import devtrace
import generator
import harness
import yardstick

BENCH = harness.load_benchmark()
CFGS = [harness.config_file(c["name"]) for c in BENCH["configs"]]
SHAPES = [(1, 4096), (8, 4096), (2, 8192), (1, 32768), (3, 1000)]


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["name"])
def test_model_flops_equal_the_launchers(cfg):
    from repro_torch.launch import train as launch

    port = harness.port_config(cfg)
    assert yardstick.param_count(cfg) == port.param_count()
    assert yardstick.token_params(cfg) == launch.token_params(port)
    assert yardstick.attention_pair_flops(cfg) == launch.attention_pair_flops(port)
    for b, s in SHAPES:
        assert yardstick.recurrence_flops(cfg, b, s) == launch.recurrence_flops(port, b, s)
        assert yardstick.step_flops(cfg, b, s) == launch.step_flops(port, b, s)
        assert yardstick.causal_pairs(s, cfg["window"]) == launch.causal_pairs(s, cfg["window"])


@pytest.mark.parametrize("sq,sk,causal,window", [(4096, 4096, True, 0), (8192, 8192, True, 2048),
                                                 (32768, 32768, True, 2048), (1000, 1500, False, 0),
                                                 (300, 300, True, 300)])
def test_visible_pairs_and_k3_work(sq, sk, causal, window):
    from repro_torch.kernels.flash_attention.ops import visible_pairs

    import chip_smoke

    assert yardstick.visible_pairs(sq, sk, causal, window) == visible_pairs(sq, sk, causal, window)
    ours = yardstick.k3_work(2, 25, 5, sq, sk, 64, 64, causal, window)
    theirs = chip_smoke.k3_work(2, 25, 5, sq, sk, 64, 64, causal, window)
    assert (ours["flops"], ours["bytes"]) == (theirs["flops"], theirs["bytes"])
    assert ours["bound_s"] * 1e3 == pytest.approx(theirs["bound_ms"], rel=1e-12)


def test_k3_backward_count():
    """2 (3 D + 2 Dv) a visible pair and head, the count ``chip_smoke``'s
    ``k3_lse_case`` divides by (the products the gradient needs; the
    program's own FLOP formula for the operator counts 2 (4 D + 3 Dv))."""
    w = yardstick.k3_bwd_work(1, 4, 2, 128, 128, 64, 64, True, 0)
    assert w["flops"] == 2 * 4 * (3 * 64 + 2 * 64) * yardstick.visible_pairs(128, 128, True, 0)
    assert w["bytes"] == (4 * 128 * 256 + 2 * 128 * 256) * 2 + 4 * 128 * 4


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["name"])
def test_batches_equal_the_pipeline(cfg):
    from repro_torch.data import TokenPipeline

    port = harness.port_config(cfg)
    for seed, step in ((0, 0), (2**31 + 5, 3), (12345, 17)):
        want, _ = TokenPipeline(port, 64, 3, seed=seed).batch_at({"data_step": step,
                                                                   "seed": seed})
        got = generator.train_batch(seed, step, 3, 64, cfg["vocab"], 1.3)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def _event(name, dev, start, end, kernels=(), parent=None):
    span = SimpleNamespace(start=start, end=end, elapsed_us=lambda s=start, e=end: e - s)
    return SimpleNamespace(name=name, device_type=dev, is_user_annotation=False,
                           kernels=list(kernels), cpu_parent=parent, time_range=span)


def test_device_groups_equal_the_smokes():
    import chip_smoke

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    k = lambda n, d: SimpleNamespace(name=n, duration=d)  # noqa: E731
    step = _event("ProfilerStep", cpu, 0, 100)
    adam = _event("adamw_update", cpu, 1, 50, parent=step)
    op = _event("aten::mul", cpu, 2, 3, [k("elementwise_kernel", 7.0)], adam)
    mm = _event("aten::mm", cpu, 4, 5, [k("sm90_xmma_gemm", 11.0)], step)
    devs = [_event("elementwise_kernel", cuda, 10, 17), _event("sm90_xmma_gemm", cuda, 20, 31),
            _event("flash_fwd_kernel_wgmma", cuda, 40, 45),
            _event("flash_bwd_dq_wgmma", cuda, 50, 53)]
    prof = SimpleNamespace(events=lambda: [step, adam, op, mm] + devs)
    ours, theirs = devtrace.device_groups(prof), chip_smoke.device_groups(prof)
    assert ours["groups_ms"] == theirs["groups_ms"] and ours["busy_us"] == theirs["busy_us"]
    assert ours["top_kernels_ms"] == theirs["top_kernels_ms"]
    for name in ("flash_fwd_kernel_wgmma<64>", "flash_bwd_delta", "nvjet_tst", "Memcpy DtoD",
                 "reduce_kernel", "vectorized_elementwise"):
        assert devtrace.kernel_group(name) == chip_smoke._kernel_group(name)
    assert devtrace.RANGES == chip_smoke.RANGES
    s = devtrace.summarize(prof, 1e-4)
    assert s["range_s"] == pytest.approx({"adamw_update": 7e-6, "flash_attention_backward": 3e-6})
    assert s["busy_s"] == pytest.approx(26e-6)
    assert s["idle_gaps"][0] == ["adamw_update", 9e-6]  # the innermost host op over it
