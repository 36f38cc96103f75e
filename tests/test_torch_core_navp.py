"""repro_torch's NavP core on CPU nodes: the scenarios of the JAX package's
``tests/test_core_navp.py`` (DHP hop/publish/restart, itineraries, plugins,
async publish), with CMIs that the JAX package reads back."""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import cmi as jcmi
from repro_torch.checkpoint.serializer import load_manifest
from repro_torch.core import DHP, NBS, JobStore
from repro_torch.core.delta import DeltaPolicy, device_changed_hints
from repro_torch.core.itinerary import Itinerary, MobilePipeline, Stage, stage_ref, validate_stages
from repro_torch.core.jobstore import STATUS_CKPT
from repro_torch.core.preemption import SpotSchedule


@pytest.fixture
def cluster(tmp_path):
    nbs = NBS(tmp_path / "s3")
    nbs.add_node("A", device="cpu")
    nbs.add_node("B", device=torch.device("cpu"))
    store = JobStore(tmp_path / "jobs")
    return nbs, store


def test_publish_restart_roundtrip(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store)
    job = store.create_job({})
    state = {"params": {"w": torch.arange(16.0)}, "step": 3}
    name = dhp.publish(job.job_id, STATUS_CKPT, state, step=3)
    got, step = dhp.restart(job.job_id, node="B")
    assert step == 3 and got["step"] == 3
    assert torch.equal(got["params"]["w"], torch.arange(16.0))
    theirs, _ = jcmi.restore_cmi(store.cmi_root(job.job_id), name)  # the JAX package reads it
    np.testing.assert_array_equal(theirs["params"]["w"], np.arange(16.0, dtype=np.float32))


@pytest.mark.parametrize("via", ["store", "live", "auto"])
def test_hop(cluster, via):
    nbs, store = cluster
    events = []
    nbs.plugins.subscribe("on_hop", lambda **kw: events.append(kw["via"]))
    dhp = DHP(nbs, "A", store)
    s2 = dhp.hop({"x": torch.ones(4, 4), "tag": "t"}, "B", via=via)
    assert dhp.node == "B"
    s3 = dhp.hop(s2, "A", via=via)
    assert torch.equal(s3["x"], torch.ones(4, 4)) and s3["tag"] == "t"
    assert events == ["store" if via == "store" else "live"] * 2
    assert list(nbs.hop_root.iterdir()) == []  # transit CMIs never leak


def test_hop_paths_that_need_the_fabric_raise(cluster):
    """The fabric's paths exist now (tests/test_torch_fabric.py drives them);
    without a worker process behind them they raise errors that name the
    problem."""
    from repro_torch.core.nbs import RemoteStateRef

    nbs, store = cluster
    dhp = DHP(nbs, "A", store)
    with pytest.raises(ValueError, match="process-backed"):
        dhp.hop({"x": torch.ones(2)}, "B", via="stream")
    with pytest.raises(OSError):
        nbs.add_remote_node("W", ("unix", "/nonexistent"))
    with pytest.raises(KeyError, match="no such node"):
        dhp.fetch(RemoteStateRef(node="W", token="res-0", step=0, leaves=1))


def test_hop_to_reclaimed_node_raises(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store)
    nbs.remove_node("B")
    with pytest.raises(KeyError, match="reclaimed"):
        dhp.hop({"x": torch.ones(2)}, "B")


def test_plugin_event_order(cluster):
    nbs, store = cluster
    events = []
    nbs.plugins.subscribe("on_checkpoint", lambda **kw: events.append("ckpt"))
    nbs.plugins.subscribe("on_publish", lambda **kw: events.append("pub"))
    nbs.plugins.subscribe("on_restart", lambda **kw: events.append("restart"))
    dhp = DHP(nbs, "A", store)
    job = store.create_job({})
    dhp.publish(job.job_id, STATUS_CKPT, {"x": torch.ones(2)}, step=1)
    dhp.restart(job.job_id)
    assert events == ["ckpt", "pub", "restart"]


def test_async_publish_flush(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store, async_publish=True)
    job = store.create_job({})
    w = torch.zeros(256)
    for i in range(3):
        w.fill_(float(i))  # in place: the snapshot must have copied it
        dhp.publish(job.job_id, STATUS_CKPT, {"w": w}, step=i)
    dhp.flush()
    got, step = dhp.restart(job.job_id)
    assert step == 2 and torch.equal(got["w"], torch.full((256,), 2.0))
    dhp.close()


def test_flush_surfaces_all_async_errors(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store, async_publish=True)

    def boom(msg):
        raise RuntimeError(msg)

    dhp._submit(boom, "first failure")
    dhp._submit(boom, "second failure")
    with pytest.raises(RuntimeError, match="first failure") as ei:
        dhp.flush(timeout=30)
    assert any("second failure" in n for n in getattr(ei.value, "__notes__", []))
    dhp.flush(timeout=30)
    dhp.close()


def test_async_publish_machinery_stress(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store, async_publish=True)
    ran, lock = [], threading.Lock()

    def task(i):
        with lock:
            ran.append(i)

    threads = [threading.Thread(target=lambda b=b: [dhp._submit(task, b + i) for i in range(50)])
               for b in (0, 50, 100, 150)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    dhp.flush(timeout=30)
    assert sorted(ran) == list(range(200))
    dhp.close()


def test_delta_publish_chain_with_device_hints(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store, delta=DeltaPolicy(full_every=3), chunk_bytes=64)
    job = store.create_job({})
    w = torch.zeros(64)
    prev = None
    written = []
    for i in range(5):
        w = w.clone()
        w[i] = 1.0
        hint = device_changed_hints(prev, {"w": w}, chunk_bytes=64) if prev else {}
        name = dhp.publish(job.job_id, STATUS_CKPT, {"w": w}, step=i, changed_hint=hint)
        written.append(load_manifest(store.cmi_root(job.job_id), name).extra["stats"])
        prev = {"w": w}
    got, step = dhp.restart(job.job_id)
    assert step == 4 and torch.equal(got["w"][:5], torch.ones(5))
    # after the first publish only the one changed 64-byte chunk is written
    assert [s["objects_written"] for s in written[1:]] == [1, 1, 1, 1]


def test_finished_product_uses_io_engine(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store, chunk_bytes=256, writers=2)
    job = store.create_job({})
    dhp.publish(job.job_id, STATUS_CKPT, {"w": torch.ones(1024)}, step=1)
    name = dhp.publish(job.job_id, "finished", product={"w": torch.arange(1024.0)}, step=1)
    man = load_manifest(store.cmi_root(job.job_id), name)
    assert man.version == 4 and man.data_files == [] and len(man.arrays["w"].chunks) > 1


def _inc(s):
    return {**s, "x": s["x"] + 1}


def _double(s):
    return {**s, "x": s["x"] * 2}


def _minus3(s):
    return {**s, "x": s["x"] - 3}


def test_itinerary_fig8_and_resume(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store)
    job = store.create_job({})
    stages = [Stage("B", _inc, "read", publish=True), Stage("A", _double, "compute", publish=True),
              Stage("B", _minus3, "write")]
    assert validate_stages(stages, nbs) == []
    it = Itinerary(dhp, job.job_id)
    out = it.run({"x": torch.tensor(10.0)}, stages)
    assert float(out["x"]) == 19.0
    assert [n for n, _ in it.trace] == ["read", "compute", "write"]
    it2 = Itinerary(DHP(nbs, "A", store), job.job_id)
    out2 = it2.resume(stages)
    assert float(out2["x"]) == 19.0 and [n for n, _ in it2.trace] == ["write"]


def test_itinerary_resume_tensor_state_and_step(cluster):
    nbs, store = cluster
    job = store.create_job({})
    fail_once = {"armed": True}

    def compute(s):
        if fail_once["armed"]:
            fail_once["armed"] = False
            raise RuntimeError("preempted mid-tour")
        return s * 2

    stages = [Stage("B", lambda s: s + 1, "read", publish=True),
              Stage("A", compute, "compute", publish=True),
              Stage("B", lambda s: s - 3, "write", publish=True)]
    with pytest.raises(RuntimeError, match="preempted"):
        Itinerary(DHP(nbs, "A", store), job.job_id, via="store").run(
            torch.tensor(10.0), stages, step0=100)
    assert store.read_job(job.job_id).step == 100
    it2 = Itinerary(DHP(nbs, "A", store), job.job_id, via="store")
    out = it2.resume(stages)
    assert float(out) == 19.0 and [n for n, _ in it2.trace] == ["compute", "write"]
    assert store.read_job(job.job_id).step == 102


def test_stage_ref_addressability():
    assert stage_ref(_inc) == f"{__name__}:_inc"
    assert stage_ref(lambda s: s) is None

    def local_fn(s):
        return s

    assert stage_ref(local_fn) is None
    assert stage_ref(functools.partial(_inc)) is None
    problems = validate_stages([Stage("Z", lambda s: s, "bad")])
    assert len(problems) == 1 and "lambda" in problems[0]


def test_mobile_pipeline_schedule(cluster):
    nbs, store = cluster
    dhp = DHP(nbs, "A", store)
    mp = MobilePipeline(dhp, [Stage("A", lambda s: s + 1, "r"), Stage("B", lambda s: s * 2, "c")])
    res = mp.run([torch.tensor(float(i)) for i in range(4)])
    assert [float(r) for r in res] == [2.0, 4.0, 6.0, 8.0]
    assert max(len(t) for t in mp.tick_log) == 2


def test_spot_schedule_is_the_reference_copy():
    from repro.core.preemption import SpotSchedule as JSpotSchedule

    mine = SpotSchedule(hazard_per_step=0.3, seed=5)
    theirs = JSpotSchedule(hazard_per_step=0.3, seed=5)
    assert [mine.should_preempt(i) for i in range(50)] == [theirs.should_preempt(i) for i in range(50)]


def test_jobstore_lease_and_gc(cluster):
    _, store = cluster
    job = store.create_job({})
    claimed = store.svc_get_job(worker="w1", lease_s=0.05)
    assert claimed.job_id == job.job_id and store.svc_get_job(worker="w2") is None
    time.sleep(0.1)
    assert store.svc_get_job(worker="w2").lease_owner == "w2"  # expired lease is claimable
