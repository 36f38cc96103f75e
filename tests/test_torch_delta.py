"""K1 (delta_encode) and core/delta: the port's plain version and hints
equal the JAX package's Pallas kernel (interpret mode) and its oracles."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core.delta import device_changed_hints as jax_hints
from repro.kernels.delta_encode.ops import changed_blocks as jax_changed_blocks
from repro_torch.checkpoint import SaveOptions, load_checkpoint, save_checkpoint
from repro_torch.core.delta import DeltaPolicy, DeltaTracker, device_changed_hints
from repro_torch.kernels.delta_encode import changed_blocks, changed_blocks_plain
from repro_torch.utils import numpy_to_tensor


def _port(old: np.ndarray, new: np.ndarray, rows: int) -> np.ndarray:
    return changed_blocks_plain(numpy_to_tensor(old, "cpu"), numpy_to_tensor(new, "cpu"),
                                rows).numpy()


def _jax(old: np.ndarray, new: np.ndarray, rows: int) -> np.ndarray:
    return np.asarray(jax_changed_blocks(jnp.asarray(old), jnp.asarray(new), rows,
                                         interpret=True))


@pytest.mark.parametrize(
    "shape,dtype,rows",
    [
        ((100, 37), "float32", 7),
        ((33,), "int8", 4),
        ((5, 4, 3), "float64", 2),
        ((257, 130), "bfloat16", 16),
        ((1,), "uint32", 1),
        ((8, 8), "float16", 3),
    ],
)
def test_plain_matches_jax_kernel(shape, dtype, rows):
    """The six shape/dtype/rows cases of the JAX package's kernel tests."""
    rng = np.random.default_rng(3)
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    if dtype == "bfloat16" or np.dtype(dtype).kind in "fc":
        old = rng.standard_normal(shape).astype(np.float32).astype(dt)
    else:
        old = rng.integers(0, 100, shape).astype(dt)
    new = old.copy()
    if old.size > 2 and old.ndim:
        idx = old.shape[0] // 2
        new[idx] = new[idx] + np.asarray(1, dt)
    np.testing.assert_array_equal(_port(old, new, rows), _jax(old, new, rows))


@settings(max_examples=30, deadline=None)
@given(
    n0=st.integers(1, 50),
    n1=st.integers(1, 8),
    rows=st.integers(1, 9),
    muts=st.lists(st.integers(0, 49), max_size=6),
)
def test_mutation_property_matches_jax(n0, n1, rows, muts):
    """Exactly the chunks containing a mutated row flag, as in JAX."""
    rng = np.random.default_rng(0)
    old = rng.standard_normal((n0, n1)).astype(np.float32)
    new = old.copy()
    changed_rows = set()
    for m in muts:
        if m < n0:
            new[m, m % n1] += 1.0
            changed_rows.add(m)
    want = np.zeros(-(-n0 // rows), bool)
    for r in changed_rows:
        want[r // rows] = True
    got = _port(old, new, rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax(old, new, rows))


def test_nan_is_bitwise():
    """Bitwise-identical NaNs are unchanged; another NaN payload or -0.0
    against +0.0 is a change."""
    x = np.array([np.nan, 1.0, 2.0, 3.0], np.float32)
    np.testing.assert_array_equal(_port(x, x.copy(), 2), [False, False])
    np.testing.assert_array_equal(_port(x, x.copy(), 2), _jax(x, x.copy(), 2))
    y = x.copy()
    y.view(np.uint32)[0] ^= 1  # another NaN payload
    y[3] = -0.0 if x[3] == 0 else y[3]
    z = np.array([0.0, 1.0], np.float32)
    np.testing.assert_array_equal(_port(x, y, 2), [True, False])
    np.testing.assert_array_equal(_port(z, -z, 1), [True, True])
    np.testing.assert_array_equal(_port(z, -z, 1), _jax(z, -z, 1))


@pytest.mark.parametrize("shape", [(), (0,), (0, 4), (6, 0)])
def test_degenerate_shapes_match_jax_oracle(shape):
    """0-d is one block, an array with no rows one unchanged block. The JAX Pallas
    kernel refuses zero-width rows and its oracle zero-row 2-d arrays, so
    (0, 4) is held against the expected answer alone."""
    from repro.kernels.delta_encode.ref import changed_blocks_ref

    a = np.zeros(shape, np.float32)
    got = _port(a, a.copy(), 2)
    n0 = shape[0] if shape else 1
    np.testing.assert_array_equal(got, np.zeros(max(1, -(-n0 // 2)), bool))
    if shape != (0, 4):
        want = np.asarray(changed_blocks_ref(jnp.asarray(a), jnp.asarray(a.copy()), 2))
        np.testing.assert_array_equal(got, want)


def test_wrapper_runs_plain_version_on_cpu():
    old = torch.arange(20, dtype=torch.float32)
    new = old.clone()
    new[13] = -1
    before = changed_blocks.launches
    assert changed_blocks(old, new, 4).tolist() == [False, False, False, True, False]
    assert changed_blocks.launches == before  # no kernel ran


def test_wrapper_rejects_mismatch():
    with pytest.raises(ValueError):
        changed_blocks(torch.zeros(4), torch.zeros(5), 1)
    with pytest.raises(ValueError):
        changed_blocks(torch.zeros(4), torch.zeros(4, dtype=torch.float64), 1)


def _hint_trees():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 16)).astype(np.float32)
    b = rng.integers(0, 9, (300,)).astype(np.int32)
    m = rng.random(1000) > 0.5
    w2 = w.copy()
    w2[7] += 1.0
    w2[33] -= 1.0
    b2 = b.copy()
    b2[-1] += 1
    prev = {"w": w, "b": b, "m": m, "s": 1.0, "new_later": None}
    cur = {"w": w2, "b": b2, "m": m.copy(), "s": 2.0, "added": w[:3]}
    return prev, cur


@pytest.mark.parametrize("chunk_bytes", [256, 1024, 16 << 20])
def test_device_changed_hints_match_jax(chunk_bytes):
    prev, cur = _hint_trees()
    # the JAX package's hints reject bool leaves (lax.bitcast_convert_type
    # refuses bool); the port compares their bytes like any other dtype
    jprev = {k: v for k, v in prev.items() if k != "m"}
    jcur = {k: v for k, v in cur.items() if k != "m"}
    want = jax_hints({k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                      for k, v in jprev.items()},
                     {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                      for k, v in jcur.items()}, chunk_bytes=chunk_bytes)
    t = lambda tree: {k: numpy_to_tensor(v, "cpu") if isinstance(v, np.ndarray) else v
                      for k, v in tree.items()}
    got = device_changed_hints(t(prev), t(cur), chunk_bytes=chunk_bytes)
    assert sorted(got) == ["b", "m", "w"] and sorted(want) == ["b", "w"]
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert not got["m"].any() and len(got["m"]) == -(-1000 // min(1000, chunk_bytes))
    # numpy leaves take the same path
    got_np = device_changed_hints(prev, cur, chunk_bytes=chunk_bytes)
    for k in want:
        np.testing.assert_array_equal(got_np[k], got[k])


def test_hints_skip_shape_mismatch():
    assert device_changed_hints({"w": torch.zeros(4, 4)}, {"w": torch.zeros(5, 4)}) == {}
    assert device_changed_hints({"w": torch.zeros(4)}, {"w": torch.zeros(4, dtype=torch.int32)}) == {}


def test_hints_match_serializer_grid(tmp_path):
    """A save using the hints makes exactly the refs that hash-compare makes."""
    prev, cur = _hint_trees()
    t0 = {"w": torch.from_numpy(prev["w"])}
    t1 = {"w": torch.from_numpy(cur["w"])}
    cb = 16 * 16 * 4  # 16 rows/chunk
    save_checkpoint(tmp_path, "c0", t0, options=SaveOptions(chunk_bytes=cb))
    hints = device_changed_hints(t0, t1, chunk_bytes=cb)
    assert hints["w"].tolist() == [True, False, True]
    m_hint = save_checkpoint(tmp_path, "c1", t1,
                             options=SaveOptions(chunk_bytes=cb, parent="c0", changed_hint=hints))
    m_hash = save_checkpoint(tmp_path, "c2", t1, options=SaveOptions(chunk_bytes=cb, parent="c0"))
    assert m_hint.extra["stats"]["ref_chunks"] == m_hash.extra["stats"]["ref_chunks"] == 1
    got, _ = load_checkpoint(tmp_path, "c1")
    assert got["w"].numpy().tobytes() == cur["w"].tobytes()


def test_tracker_resets_chain():
    t = DeltaTracker(DeltaPolicy(full_every=3))

    class FakeStore:
        def cmi_root(self, _):
            return "/nonexistent"

    t.record_published("j", "a")
    t.record_published("j", "b")
    t.record_published("j", "c")
    assert t.parent_for("j", FakeStore()) is None
