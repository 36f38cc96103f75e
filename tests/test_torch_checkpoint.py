"""The port's CMIs and the JAX package's share one on-disk format.

CMIs written by repro_torch restore bit-identically through the JAX
package and the reverse; one v4 store deduplicates chunks across both; the
port's fsck accepts stores from both; the golden v1–v3 fixtures load.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.checkpoint.fsck import fsck_store as jax_fsck
from repro.core import cmi as jcmi
from repro_torch.checkpoint import (
    SaveOptions,
    load_arrays,
    load_checkpoint,
    load_manifest,
    save_checkpoint,
)
from repro_torch.checkpoint.fsck import fsck_store
from repro_torch.core import cmi as tcmi
from repro_torch.utils import from_numpy_tree

FIXTURES = Path(__file__).resolve().parent / "ckpt_fixtures"


def _numpy_state(seed: int = 0) -> dict:
    """A tree of every dtype the shared format carries, as numpy (the JAX package's view)."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((37, 5)).astype(np.float32),
        "f64": rng.standard_normal((11,)),
        "i32": rng.integers(-1000, 1000, (9, 2, 3)).astype(np.int32),
        "i8": rng.integers(-100, 100, (33,)).astype(np.int8),
        "mask": rng.random(17) > 0.5,
        "bf16": rng.standard_normal((13, 3)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "scalar0d": np.asarray(3.25, np.float32),
        "nested": [{"w": rng.standard_normal((4,)).astype(np.float32)}, ("tag", 7)],
        "step": 12,
    }


def _as_bytes(x) -> tuple:
    """(dtype name, shape, raw bytes) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return ("bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes())
        x = x.numpy()
    x = np.asarray(x)
    return (x.dtype.name, tuple(x.shape), np.ascontiguousarray(x).tobytes())


def _assert_same_tree(got, want):
    from repro.utils import flatten_with_paths as jflat

    gf, _ = jflat(got, is_leaf=lambda v: isinstance(v, torch.Tensor))
    wf, _ = jflat(want, is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert list(gf) == list(wf)
    for k in wf:
        if isinstance(wf[k], (np.ndarray, torch.Tensor, jax.Array)):
            assert _as_bytes(gf[k]) == _as_bytes(wf[k]), k
        else:
            assert gf[k] == wf[k], k


@pytest.mark.parametrize("cas", [False, True], ids=["v3", "v4"])
@pytest.mark.parametrize("writers", [1, 3])
def test_port_cmi_restores_bit_identical_in_jax(tmp_path, cas, writers):
    want = _numpy_state()
    state = from_numpy_tree(want, "cpu")
    man = tcmi.save_cmi(tmp_path, "c", state, step=4,
                        options=SaveOptions(chunk_bytes=64, writers=writers, cas=cas))
    assert man.version == (4 if cas else 3)
    got, jman = jcmi.restore_cmi(tmp_path, "c")
    assert jman.step == 4
    _assert_same_tree(got, want)


@pytest.mark.parametrize("cas", [False, True], ids=["v3", "v4"])
def test_jax_cmi_restores_bit_identical_in_port(tmp_path, cas):
    want = _numpy_state(1)
    jstate = dict(want, f32=jnp.asarray(want["f32"]), bf16=jnp.asarray(want["bf16"]))
    jcmi.save_cmi(tmp_path, "c", jstate, step=2,
                  options=jser.SaveOptions(chunk_bytes=64, writers=2, cas=cas))
    got, man = tcmi.restore_cmi(tmp_path, "c", device="cpu")
    assert man.step == 2
    assert got["bf16"].dtype == torch.bfloat16 and got["mask"].dtype == torch.bool
    _assert_same_tree(got, want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("cas", [False, True], ids=["v3", "v4"])
def test_partial_restore_equals_reference(tmp_path, writer, cas):
    """``load_arrays`` on a store written by either package: the named
    arrays only, each bitwise the reference's ``load_arrays``, serial and
    with four read threads; all arrays for ``paths=None``."""
    want = _numpy_state(3)
    if writer == "jax":
        jcmi.save_cmi(tmp_path, "c", want, options=jser.SaveOptions(chunk_bytes=64, cas=cas))
    else:
        tcmi.save_cmi(tmp_path, "c", from_numpy_tree(want, "cpu"),
                      options=SaveOptions(chunk_bytes=64, writers=2, cas=cas))
    paths = ["bf16", "nested/0/w", "i32", "scalar0d"]
    ref = jser.load_arrays(tmp_path, "c", paths=paths)
    for threads in (1, 4):
        got = load_arrays(tmp_path, "c", paths=paths, io_threads=threads, device="cpu")
        assert list(got) == paths
        for k in paths:
            assert _as_bytes(got[k]) == _as_bytes(ref[k]), k
    every = load_arrays(tmp_path, "c")
    assert sorted(every) == sorted(jser.load_arrays(tmp_path, "c"))
    assert all(t.device.type == "cpu" for t in every.values())
    # a sharded partial restore on a 1x1 mesh (a gloo group of one, here):
    # DTensors whose blocks are the whole arrays; a path the mapping gives
    # no sharding lands on ``device``
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.group import free_port, in_group
    from repro_torch.distributed.sharding import NamedSharding, P

    with in_group(0, 1, free_port(), "cpu", 60):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        sh = {"i32": NamedSharding(mesh, P("data", None)), "scalar0d": NamedSharding(mesh, P())}
        got = load_arrays(tmp_path, "c", paths=["i32", "scalar0d", "bf16"], shardings=sh,
                          device="cpu")
        assert isinstance(got["i32"], DTensor) and isinstance(got["scalar0d"], DTensor)
        assert not isinstance(got["bf16"], DTensor)
        for k in ("i32", "scalar0d"):
            assert _as_bytes(got[k].to_local()) == _as_bytes(ref[k]), k
        assert _as_bytes(got["i32"].full_tensor()) == _as_bytes(ref["i32"])


def test_jax_sharded_cmi_restores_onto_one_device(tmp_path):
    """A CMI with a pspec (saved on a mesh) lands whole on the one device."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data", None))
    w = np.arange(24, dtype=np.float32).reshape(8, 3)
    jcmi.save_cmi(tmp_path, "c", {"w": jax.device_put(w, sh)})
    assert load_manifest(tmp_path, "c").arrays["w"].sharding.pspec == ["data", None]
    got, _ = tcmi.restore_cmi(tmp_path, "c", device="cpu")
    assert got["w"].device.type == "cpu"
    assert got["w"].numpy().tobytes() == w.tobytes()


def test_one_v4_store_dedups_across_packages(tmp_path):
    want = _numpy_state(2)
    jman = jser.save_checkpoint(tmp_path, "jax", want,
                                options=jser.SaveOptions(chunk_bytes=128, cas=True))
    assert jman.extra["stats"]["objects_written"] > 0
    tman = save_checkpoint(tmp_path, "torch", from_numpy_tree(want, "cpu"),
                           options=SaveOptions(chunk_bytes=128, cas=True))
    assert tman.extra["stats"]["objects_written"] == 0
    assert tman.extra["stats"]["written_bytes"] == 0
    # the chunk tables agree entry for entry
    assert {k: v.to_json() for k, v in tman.arrays.items()} == {
        k: v.to_json() for k, v in jman.arrays.items()}
    # ... and the reverse direction writes nothing either
    again = jser.save_checkpoint(tmp_path, "jax2", want,
                                 options=jser.SaveOptions(chunk_bytes=128, cas=True))
    assert again.extra["stats"]["objects_written"] == 0


def test_delta_chain_across_packages(tmp_path):
    """A port publish can delta against a JAX parent (and reads back)."""
    base = _numpy_state(3)
    jser.save_checkpoint(tmp_path, "p", base, options=jser.SaveOptions(chunk_bytes=64))
    cur = from_numpy_tree(base, "cpu")
    cur["f32"][5] += 1.0
    man = save_checkpoint(tmp_path, "c", cur, options=SaveOptions(chunk_bytes=64, parent="p"))
    stats = man.extra["stats"]
    assert stats["ref_chunks"] > 0 and stats["written_bytes"] < stats["ref_bytes"]
    got, _ = jcmi.restore_cmi(tmp_path, "c")
    assert got["f32"].tobytes() == cur["f32"].numpy().tobytes()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_port_fsck_clean_on_both_packages_stores(tmp_path, writer):
    state = _numpy_state(4)
    for i, cas in enumerate([False, True, True]):
        if writer == "jax":
            jser.save_checkpoint(tmp_path, f"c{i}", state,
                                 options=jser.SaveOptions(chunk_bytes=96, cas=cas))
        else:
            save_checkpoint(tmp_path, f"c{i}", from_numpy_tree(state, "cpu"),
                            options=SaveOptions(chunk_bytes=96, cas=cas))
    report = fsck_store(tmp_path)
    assert report.clean, report.summary()
    assert len(report.cmis) == 3 and report.objects_checked > 0
    assert jax_fsck(tmp_path).summary() == report.summary()


def test_port_fsck_finds_corruption(tmp_path):
    save_checkpoint(tmp_path, "c", {"w": torch.arange(64, dtype=torch.float32)},
                    options=SaveOptions(chunk_bytes=64, writers=1))
    data = tmp_path / "c" / "data-0.bin"
    raw = bytearray(data.read_bytes())
    raw[3] ^= 0xFF
    data.write_bytes(bytes(raw))
    report = fsck_store(tmp_path)
    assert not report.clean and "CRC mismatch" in report.errors[0]
    with pytest.raises(IOError):
        load_checkpoint(tmp_path, "c")


def _expected_golden(version: int) -> dict:
    base = np.arange(48, dtype=np.float32).reshape(12, 4)
    return {
        "model": {"w": base + float(version), "b": np.arange(12, dtype=np.int64) * version},
        "tag": f"golden-v{version}",
        "step": 10 * version,
    }


@pytest.mark.parametrize("version", [1, 2, 3])
def test_golden_fixtures_load_bit_identical(version):
    tree, man = load_checkpoint(FIXTURES, f"v{version}-cmi")
    assert man.version == version
    _assert_same_tree(tree, _expected_golden(version))


def test_golden_store_fsck_clean():
    report = fsck_store(FIXTURES)
    assert report.clean and len(report.cmis) == 3


def test_async_snapshot_publish_equals_sync(tmp_path):
    """snapshot_to_host copies tensors (later writes do not leak in)."""
    state = from_numpy_tree(_numpy_state(5), "cpu")
    before = state["f32"].clone()
    snap = tcmi.snapshot_to_host(state)
    state["f32"].add_(1.0)  # mutate after the snapshot point
    save_checkpoint(tmp_path, "snap", snap, options=SaveOptions(chunk_bytes=64))
    got, _ = load_checkpoint(tmp_path, "snap")
    assert got["f32"].numpy().tobytes() == before.numpy().tobytes()
    assert got["bf16"].view(torch.int16).numpy().tobytes() == \
        state["bf16"].view(torch.int16).numpy().tobytes()


@pytest.mark.parametrize("cas,fault", [
    (False, "crash_after_data"), (False, "publish.before_commit"),
    (True, "crash_after_data"), (True, "publish.before_commit"),
    (True, "cas.publish.post_objects"),
])
def test_interrupted_save_keeps_previous_cmi(tmp_path, cas, fault):
    """A save killed before COMMIT (paper Q4) leaves the previous CMI under
    the same name intact, and the JAX package still reads it."""
    from repro_torch.chaos import faults
    from repro_torch.checkpoint.atomic import _InjectedCrash

    old = {"w": torch.arange(32, dtype=torch.float32)}
    save_checkpoint(tmp_path, "c", old, step=1, options=SaveOptions(chunk_bytes=32, cas=cas))
    new = {"w": torch.arange(32, dtype=torch.float32) + 1}
    opts = SaveOptions(chunk_bytes=32, cas=cas)
    if fault == "crash_after_data":
        with pytest.raises(_InjectedCrash):
            save_checkpoint(tmp_path, "c", new, step=2, options=opts, _crash_after_data=True)
    else:
        with faults.arm({"point": fault, "action": "error"}):
            with pytest.raises(faults.FaultInjected):
                save_checkpoint(tmp_path, "c", new, step=2, options=opts)
    got, man = load_checkpoint(tmp_path, "c")
    assert man.step == 1 and torch.equal(got["w"], old["w"])
    theirs, _ = jcmi.restore_cmi(tmp_path, "c")
    assert theirs["w"].tobytes() == old["w"].numpy().tobytes()
    assert fsck_store(tmp_path).clean  # torn stages and new objects are benign orphans
