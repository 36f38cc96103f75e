"""K2 (colocate): the port's plain version against the JAX package's Pallas
kernel in interpret mode, and the CUDA kernel's algorithm against the plain
version.

The tolerance on ``cos`` is the JAX package's own kernel test's (rtol 1e-5,
atol 1e-6); ``idx`` must be exactly equal. Both sides compute each dot as
the fused chain fma(u2, l2, fma(u1, l1, u0 * l0)), so on this CPU they
also agree bitwise, which ``test_bitwise_equal_to_jax_on_this_cpu`` and the
tie-heavy cases pin down.

The CUDA kernel cannot run here, so its algorithm (an fmax running maximum
over ascending sub-tiles, a strict ``>`` merge, one deferred first-index
rescan) is emulated in plain torch and held bitwise against the plain
version, with the sub-tile width read from the kernel's source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.colocate.ops import colocate_match as jax_colocate_match
from repro_torch.kernels.colocate import colocate_match, colocate_match_plain
from repro_torch.kernels.colocate.ops import fma_f32
from repro_torch.kernels.colocate.cases import TIE_CASES, tie_case, unit_vectors

CSRC = Path(__file__).resolve().parent.parent / "src/repro_torch/kernels/csrc/colocate.cu"
SUB = int(re.search(r"constexpr int kSub = (\d+);", CSRC.read_text()).group(1))  # FOVs a sub-tile

CASES = [(1000, 300), (513, 512), (100, 1), (1, 700)]


@pytest.mark.parametrize("n,m", CASES)
def test_plain_matches_jax_kernel(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    u, los = unit_vectors(rng, n), unit_vectors(rng, m)
    gi, gc = jax_colocate_match(jnp.asarray(u), jnp.asarray(los), interpret=True)
    ti, tc = colocate_match_plain(torch.from_numpy(u), torch.from_numpy(los))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(gi))
    np.testing.assert_allclose(tc.numpy(), np.asarray(gc), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,m", CASES)
def test_wrapper_on_cpu_is_the_plain_version(n, m):
    rng = np.random.default_rng(7 + n + m)
    u, los = torch.from_numpy(unit_vectors(rng, n)), torch.from_numpy(unit_vectors(rng, m))
    before = colocate_match.launches
    wi, wc = colocate_match(u, los)
    pi, pc = colocate_match_plain(u, los, block_rows=64)  # blocking changes nothing
    assert torch.equal(wi, pi) and torch.equal(wc, pc)
    assert colocate_match.launches == before


def test_ties_go_to_the_lowest_index():
    u = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    los = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        [0.0, 1.0, 0.0]])
    idx, cos = colocate_match_plain(u, los)
    assert idx.tolist() == [1, 3] and cos.tolist() == [1.0, 1.0]


def test_empty_los_and_bad_inputs():
    idx, cos = colocate_match_plain(torch.ones(3, 3), torch.ones(0, 3))
    assert idx.tolist() == [0, 0, 0] and torch.isinf(cos).all() and (cos < 0).all()
    with pytest.raises(ValueError):
        colocate_match(torch.ones(3, 2), torch.ones(4, 2))
    with pytest.raises(ValueError):
        colocate_match(torch.ones(3, 3, dtype=torch.float64), torch.ones(4, 3))


def test_fma_f32_is_correctly_rounded():
    """Against exact rational arithmetic, including the double-rounding
    cases where the float64 sum sits halfway between two float32s."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.standard_normal(4000) * 10.0 ** rng.integers(-12, 3, 4000)).astype(np.float32)
    # double-rounding cases: a*b = -+2^-24 (1 - 2^-46), so the float64 sum
    # lands exactly halfway between two float32s next to an odd c, and only
    # the sign of the lost tail says which way to round
    t = np.float32(2.0 ** -24 * (1 + 2.0 ** -23))
    odd = np.float32(1.5 + 2.0 ** -23)
    a_tie = np.float32([t, -t])
    b_tie = np.float32([1 - 2.0 ** -23] * 2)
    c_tie = np.float32([odd, -odd])
    naive = (a_tie.astype(np.float64) * b_tie + c_tie).astype(np.float32)
    assert list(naive) != [odd, -odd]  # rounding twice gets these wrong
    a, b, c = (np.concatenate([a, a_tie]), np.concatenate([b, b_tie]),
               np.concatenate([c, c_tie]))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        winners = [v for v, d in zip(cands, dist) if d == best]
        if len(winners) == 2:  # exact tie: round half to even
            winners = [v for v in winners if not (v.view(np.int32) & 1)]
        assert gi == winners[0], (ai, bi, ci, gi, winners)
    assert list(got[-2:]) == [odd, -odd]


def test_bitwise_equal_to_jax_on_this_cpu():
    rng = np.random.default_rng(11)
    u, los = unit_vectors(rng, 700), unit_vectors(rng, 333)
    gi, gc = jax_colocate_match(jnp.asarray(u), jnp.asarray(los), interpret=True)
    ti, tc = colocate_match_plain(torch.from_numpy(u), torch.from_numpy(los))
    assert np.array_equal(ti.numpy(), np.asarray(gi))
    assert tc.numpy().tobytes() == np.asarray(gc).tobytes()


def emulate_kernel(u: torch.Tensor, los: torch.Tensor, sub: int):
    """The CUDA kernel's algorithm in plain torch: an fmax running maximum
    of each row's products over ascending sub-tiles of ``sub`` FOVs (the
    ragged last one padded with NaN FOVs), after each sub-tile a strict
    ``>`` against the best so far recording the sub-tile, then a rescan of
    the winning sub-tile for the first FOV whose product equals the
    maximum, whose product is the result."""
    n, m = u.shape[0], los.shape[0]
    pad = -m % sub
    lp = torch.cat([los, torch.full((pad, 3), float("nan"))])
    s = u[:, 0:1] * lp[:, 0]
    s = fma_f32(u[:, 1:2], lp[:, 1], s)
    s = fma_f32(u[:, 2:3], lp[:, 2], s)
    run = torch.full((n,), float("-inf"))
    best = run.clone()
    win = torch.full((n,), -1, dtype=torch.int64)
    for j0 in range(0, m + pad, sub):
        for j in range(j0, j0 + sub):
            run = torch.fmax(run, s[:, j])
        rose = run > best
        best = torch.where(rose, run, best)
        win = torch.where(rose, j0, win)
    idx = torch.zeros(n, dtype=torch.int32)
    cos = torch.full((n,), float("-inf"))
    rows = torch.nonzero(win >= 0).flatten()
    if len(rows):
        cols = win[rows, None] + torch.arange(sub)  # the winning sub-tile
        window = s[rows[:, None], cols]  # its padding is NaN: never equal
        first = (window == best[rows, None]).int().argmax(dim=1)
        assert bool((window[torch.arange(len(rows)), first] == best[rows]).all())
        idx[rows] = (win[rows] + first).to(torch.int32)
        cos[rows] = window[torch.arange(len(rows)), first]
    return idx, cos


@pytest.mark.parametrize("n,m", CASES + [(300, 33), (257, 32), (64, 95), (40, 0)])
def test_kernel_algorithm_equals_plain_bitwise(n, m):
    rng = np.random.default_rng(31 * n + m)
    u, los = torch.from_numpy(unit_vectors(rng, n)), torch.from_numpy(unit_vectors(rng, m))
    ei, ec = emulate_kernel(u, los, SUB)
    pi, pc = colocate_match_plain(u, los)
    assert torch.equal(ei, pi)
    assert torch.equal(ec.view(torch.int32), pc.view(torch.int32))


@pytest.mark.parametrize("label", [c[0] for c in TIE_CASES if c[3]])
def test_kernel_algorithm_breaks_ties_like_plain_and_jax(label):
    """On tie-heavy inputs the emulated kernel equals the plain version
    bitwise, and the plain version equals the Pallas kernel bitwise."""
    u, los = tie_case(label)
    _, n, m, dups = next(c for c in TIE_CASES if c[0] == label)
    tu, tl = torch.from_numpy(u), torch.from_numpy(los)
    pi, pc = colocate_match_plain(tu, tl)
    ei, ec = emulate_kernel(tu, tl, SUB)
    assert torch.equal(ei, pi)
    assert torch.equal(ec.view(torch.int32), pc.view(torch.int32))
    gi, gc = jax_colocate_match(jnp.asarray(u), jnp.asarray(los), interpret=True)
    assert np.array_equal(pi.numpy(), np.asarray(gi))
    assert pc.numpy().tobytes() == np.asarray(gc).tobytes()
    # the ties are real: copied pixels land on the lower index of their pair
    if dups == "all":
        assert not pi.any()
    else:
        k = n // 3
        want = np.resize([a for a, _ in dups], k)
        assert np.array_equal(pi.numpy()[:k], want)
