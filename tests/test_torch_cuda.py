"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA card (as on a CPU-only
machine) and run on an H100 with ``PYTHONPATH=src python -m pytest -q -m
cuda tests/test_torch_cuda.py``. ``chip_smoke.py`` runs the same checks at
the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.serializer import _chunk_rows
from repro_torch.kernels.colocate import colocate_match, colocate_match_plain
from repro_torch.kernels.delta_encode import changed_blocks, changed_blocks_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype,chunk", [
    ((100, 37), torch.float32, 7 * 37 * 4), ((33,), torch.int8, 4), ((5, 4, 3), torch.float64, 96),
    ((257, 130), torch.bfloat16, 16 * 260), ((4099,), torch.bool, 1000), ((), torch.float32, 4),
    ((0,), torch.float32, 64), ((70001, 3), torch.float32, 1 << 16),
])
def test_delta_encode_kernel_equals_plain(dev, shape, dtype, chunk):
    gen = torch.Generator().manual_seed(1)
    base = torch.randn(shape, generator=gen) * 50
    old = (base > 0 if dtype == torch.bool else base.to(dtype)).to(dev)
    rows = _chunk_rows(tuple(shape), old.element_size(), chunk)
    for mutate in ([], [0], [1, -1]):
        new = old.clone()
        for r in mutate:
            if shape and shape[0] > abs(r):
                new[r] = ~new[r] if dtype == torch.bool else new[r] + 1
        before = changed_blocks.launches
        got = changed_blocks(old, new, rows)
        assert torch.equal(got, changed_blocks_plain(old, new, rows))
        assert changed_blocks.launches == before + (1 if old.numel() else 0)


@pytest.mark.parametrize("n,m", [(1000, 300), (513, 512), (100, 1), (1, 700), (3000, 2049)])
def test_colocate_kernel_equals_plain_bitwise(dev, n, m):
    rng = np.random.default_rng(n + m)

    def unit(k):
        v = rng.standard_normal((k, 3)).astype(np.float32)
        return torch.from_numpy(v / np.linalg.norm(v, axis=1, keepdims=True)).to(dev)

    u, los = unit(n), unit(m)
    ki, kc = colocate_match(u, los)
    pi, pc = colocate_match_plain(u, los)
    assert torch.equal(ki, pi)
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))
