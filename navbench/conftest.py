"""The harness's CPU tests: ``python3 -m pytest -q navbench`` from the root
of a checkout (the repository's own suite, ``tests/``, does not collect
them). A test that needs the card is marked ``cuda`` and skips without
one, deciding inside the test."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src"), str(HERE.parent)]

# the configurations at a size the CPU runs in seconds; widths as the
# registry's small configurations, the mixes cut to match
SMALL = {
    "granite-moe-1b-a400m": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                                 d_ff=64, moe_d_ff=64, n_experts=8, top_k=2, vocab=256,
                                 loss_chunk=64),
    "hymba-1.5b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab=256, ssm_state=8, window=32, chunk=16, loss_chunk=64),
}
# the published widths at two layers: logits of the full size's scale, so a
# limit in logit units (the serve cell's) reads here as on the card
WIDE = {"hymba-1.5b": dict(n_layers=2)}
SMALL_MIX = {"train": dict(batch=2, seq_len=48),
             "serve": dict(prompt_len=80, max_new=5, rate_per_s=50.0, checked_requests=3,
                           warmup_requests=1, traced_requests=1)}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips where there is none)")


@pytest.fixture
def small_cell():
    """``small_cell(name, dtype, wide)``: the benchmark's cell at the CPU's
    size (``wide``: its published widths at two layers)."""
    import harness

    def make(name: str, dtype: str = "float32", wide: bool = False) -> dict:
        c = harness.cell(harness.load_benchmark(), name)
        c["cfg"] = {**c["cfg"], **(WIDE if wide else SMALL)[c["config"]], "dtype": dtype}
        c["mix"] = {**c["mix"], **SMALL_MIX[c["mix"]["kind"]]}
        return c

    return make


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
