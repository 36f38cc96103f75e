"""The port's fabric with real torch worker processes (``--device cpu``).

Ported from ``tests/test_fabric.py``: RPC ping/hop/fetch against a
``python -m repro_torch.fabric.worker`` process, streamed hops that bypass
the store bit-identically, a second hop that streams only the changed
chunks, the transparent store fallback, and the paper's co-location tour
(read on the driver, geometry and match inside two workers, the product
streamed back) whose product equals the in-process port tour's bit for bit,
calm and after a SIGKILL of the match worker, with ``hop_root`` empty.

Every test is wrapped in a SIGALRM guard so a hung worker can never wedge
the suite. The job-loop cases (SIGKILL mid-job, respawn, lease steal) are in
``tests/test_torch_fabric_jobs.py``.
"""

import functools
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.fsck import fsck_store
from repro_torch.core import DHP, NBS, JobStore
from repro_torch.core import colocation as co
from repro_torch.core.cmi import restore_cmi
from repro_torch.core.delta import device_changed_hints
from repro_torch.core.itinerary import Itinerary, Stage
from repro_torch.core.jobstore import STATUS_CKPT
from repro_torch.core.nbs import RemoteStateRef
from repro_torch.fabric import wire
from repro_torch.fabric.supervisor import FabricSupervisor
from repro_torch.fabric.worker import EXIT_PREEMPTED

PER_TEST_TIMEOUT_S = int(os.environ.get("NAVP_TEST_TIMEOUT", "180"))
GRANULES = dict(n_scans=2, viirs_lines_per_scan=2, viirs_pixels_per_scan=40)  # 160 x 540


@pytest.fixture(autouse=True)
def _alarm_guard():
    """Per-test wall-clock guard: process-spawning tests must never hang."""

    def on_alarm(signum, frame):
        raise TimeoutError(f"fabric test exceeded {PER_TEST_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(PER_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def fab(tmp_path, request):
    """(supervisor of CPU torch workers, jobstore) with guaranteed cleanup;
    indirect-parametrize with "unix" (the default) or "tcp"."""
    jroot = tmp_path / "jobs"
    sup = FabricSupervisor(str(tmp_path / "s3"), str(jroot), device="cpu",
                           transport=getattr(request, "param", "unix"))
    try:
        yield sup, JobStore(jroot)
    finally:
        sup.shutdown()


def _cluster(sup, tmp_path, names=("W",), socket_paths=None):
    for name in names:
        sup.spawn(name, serve_only=True, socket_path=(socket_paths or {}).get(name))
    nbs = NBS(tmp_path / "s3")
    nbs.add_node("A", device="cpu")
    for name in names:
        nbs.add_remote_node(name, sup.workers[name].address)
    return nbs


def _fetch_state(nbs, token, node="W"):
    fetched = nbs.call(node, "svc/fetch", token=token, drop=False)
    state, _ = restore_cmi(nbs.hop_root, fetched["cmi"], device="cpu")
    return state


def _src(seed, rows=500):
    g = np.random.default_rng(seed)
    return {"x": torch.from_numpy(g.standard_normal((rows, 64))),
            "h": torch.from_numpy(g.standard_normal((rows, 8)).astype(np.float32)).bfloat16(),
            "step": 9}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# RPC and streamed hops
# ---------------------------------------------------------------------------


def test_remote_node_rpc_ping_hop_fetch(fab, tmp_path):
    sup, _ = fab
    nbs = _cluster(sup, tmp_path)
    info = nbs.call("W", "svc/ping")
    assert info["node"] == "W" and info["pid"] == sup.workers["W"].pid != os.getpid()
    assert info["device"] == "cpu" and nbs.node("W").device is None
    with pytest.raises(wire.RemoteError, match="no service"):
        nbs.call("W", "svc/nope")

    # store-mediated hop: state lands in the worker; receipt comes back
    dhp = DHP(nbs, "A")
    src = {"x": torch.arange(64, dtype=torch.float64), "step": 7}
    ref = dhp.hop(dict(src), "W", via="store")
    assert isinstance(ref, RemoteStateRef) and ref.leaves == 2 and ref.step == 7
    assert dhp.node == "W"
    fetched = nbs.call("W", "svc/fetch", token=ref.token)
    names = {p.name for p in nbs.hop_root.iterdir()}
    assert fetched["cmi"] in names and len(names) == 1  # the transit CMI was GC'd
    back, _ = restore_cmi(nbs.hop_root, fetched["cmi"], device="cpu")
    assert torch.equal(back["x"], src["x"]) and int(back["step"]) == 7

    nbs.remove_node("W")  # closes the client socket
    # serve-only workers still honor the SIGTERM notice path
    assert sup.reclaim("W", notice=True) == EXIT_PREEMPTED


def test_fetch_onto_a_process_backed_home_lands_where_asked(fab, tmp_path):
    """A DHP made on a worker's node has no device in this process: a fetch
    lands on the device the caller names, and with none on the card, which
    raises where there is none rather than landing on the host unasked."""
    sup, _ = fab
    nbs = _cluster(sup, tmp_path)
    src = _src(2)
    ref = DHP(nbs, "A", chunk_bytes=1 << 14).hop(dict(src), "W")
    dhp = DHP(nbs, "W", chunk_bytes=1 << 14)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dhp.fetch(ref)
        assert nbs.call("W", "svc/ping")["resident"] == 1  # nothing left the worker
    back = dhp.fetch(ref, device="cpu")
    assert _same(back["x"], src["x"]) and _same(back["h"], src["h"])
    assert back["x"].device == torch.device("cpu")
    rec = nbs.node("W").last_fetch_receipt  # the fetch session's own counters
    assert rec["chunks"] == rec["data_chunks"] > 0
    # payload bytes on the wire: compressed where that came out smaller
    assert 0 < rec["bytes"] <= src["x"].numel() * 8 + src["h"].numel() * 2 + 8


@pytest.mark.parametrize("fab", ["unix", "tcp"], indirect=True)
def test_stream_hop_and_fetch_bit_identical_without_store(fab, tmp_path):
    """via="auto" streams to a process-backed node, bf16 included; the fetch
    streams back onto the driver's device and the worker drops its copy."""
    sup, _ = fab
    nbs = _cluster(sup, tmp_path)
    dhp = DHP(nbs, "A", chunk_bytes=1 << 14)
    src = _src(1)
    ref = dhp.hop(dict(src), "W")
    assert isinstance(ref, RemoteStateRef) and ref.via == "stream"
    assert ref.step == 9 and dhp.node == "W"
    assert list(nbs.hop_root.iterdir()) == []  # nothing transited the store
    back = dhp.fetch(ref)
    assert _same(back["x"], src["x"]) and _same(back["h"], src["h"])
    assert back["step"] == 9 and back["x"].device == torch.device("cpu")
    assert list(nbs.hop_root.iterdir()) == []
    assert nbs.call("W", "svc/ping")["resident"] == 0  # dropped after the ack

    ref2 = dhp.hop(dict(src), "W")
    state2 = dhp.fetch(ref2, via="store")
    assert _same(state2["x"], src["x"]) and _same(state2["h"], src["h"])
    assert list(nbs.hop_root.iterdir()) == []  # transit CMI GC'd after restore


def test_stream_delta_second_hop_sends_only_changed_chunks(fab, tmp_path):
    """The repeat hop deltas against the resident copy; with K1's hints
    (its plain version on the CPU) unchanged chunks are not even hashed."""
    sup, _ = fab
    nbs = _cluster(sup, tmp_path)
    wnode = nbs.node("W")
    dhp = DHP(nbs, "A", chunk_bytes=1 << 14)  # 16 KiB chunks
    src = _src(2, rows=1000)
    dhp.hop(dict(src), "W")
    full = dict(wnode.last_stream_receipt)
    assert full["ref_chunks"] == 0

    src2 = {**src, "x": src["x"].clone()}
    src2["x"][:100] += 1.0  # rows 0-99 of 32-row chunks: 4 chunks change
    hints = device_changed_hints(src, src2, chunk_bytes=1 << 14)
    changed = sum(int(h.sum()) for h in hints.values())
    assert changed == 4
    ref2 = dhp.hop(dict(src2), "W", changed_hint=hints)
    delta = dict(wnode.last_stream_receipt)
    assert ref2.via == "stream" and delta["chunks"] == full["chunks"]
    assert delta["data_chunks"] == changed
    assert delta["ref_chunks"] == full["chunks"] - changed
    assert delta["sent_bytes"] < full["sent_bytes"] / 2
    back = _fetch_state(nbs, ref2.token)
    assert _same(back["x"], src2["x"]) and _same(back["h"], src2["h"])


def test_stream_failure_falls_back_to_store_transparently(fab, tmp_path):
    """The receiver aborts mid-stream every time: dhp.hop retries via the
    store path and the state still lands bit-identical; a forced stream
    surfaces the failure instead."""
    sup, _ = fab
    nbs = _cluster(sup, tmp_path)
    nbs.node("W")._stream_fail_after = 2
    dhp = DHP(nbs, "A", chunk_bytes=1 << 14)
    src = _src(3)
    ref = dhp.hop(dict(src), "W")
    assert isinstance(ref, RemoteStateRef) and ref.via == "store" and ref.step == 9
    back = _fetch_state(nbs, ref.token)
    assert _same(back["x"], src["x"]) and _same(back["h"], src["h"])
    # nothing half-streamed became resident: only the store-hop state lives
    assert nbs.call("W", "svc/ping")["resident"] == 1
    with pytest.raises(ConnectionError):
        dhp.hop(dict(src), "W", via="stream")


# ---------------------------------------------------------------------------
# the co-location tour across torch workers
# ---------------------------------------------------------------------------


def _colocation_stages(publish=True):
    return [
        Stage("A", functools.partial(co.stage_read, device="cpu", seed=0, **GRANULES),
              "read", publish=publish),
        Stage("B", co.stage_geometry, "geometry", publish=publish),
        Stage("C", co.stage_match, "match", publish=publish),
    ]


def _in_process_tour(tmp_path):
    nbs = NBS(tmp_path / "local")
    for name in ("A", "B", "C"):
        nbs.add_node(name, device="cpu")
    return Itinerary(DHP(nbs, "A")).run({}, _colocation_stages(publish=False))


def _assert_same_product(out, want):
    for k in ("idx", "within", "los", "pos"):
        assert _same(out[k], want[k]), k
    got_p, want_p = co.stage_product(out), co.stage_product(want)
    assert np.array_equal(got_p["cris_match_count"], want_p["cris_match_count"])
    assert got_p["cris_match_count"].shape == (2 * 30 * 9,)


def test_remote_colocation_tour_store_free_bit_identical(fab, tmp_path):
    """Fig. 8 across two worker processes: the first hop streams, the B->C
    move is a worker-initiated relay, geometry and match run inside the
    workers, and the product streams back — never through the store."""
    sup, js = fab
    nbs = _cluster(sup, tmp_path, names=("B", "C"))
    vias = []
    nbs.plugins.subscribe("on_hop", lambda **kw: vias.append(kw["via"]))
    job = js.create_job({"app": "viirs-cris-colocation"})
    dhp = DHP(nbs, "A", js, chunk_bytes=1 << 14)
    it = Itinerary(dhp, job.job_id)
    out = it.run({}, _colocation_stages())

    assert vias == ["stream", "relay", "fetch_stream"], vias
    assert list(nbs.hop_root.iterdir()) == []
    assert [n for n, _ in it.trace] == ["read", "geometry", "match"]
    assert out["idx"].device == torch.device("cpu")
    _assert_same_product(out, _in_process_tour(tmp_path))
    for name in ("B", "C"):  # every leg dropped its source copy
        assert nbs.call(name, "svc/ping")["resident"] == 0
    assert fsck_store(js.cmi_root(job.job_id)).clean


def test_remote_tour_midkill_resume_bit_identical(fab, tmp_path):
    """C is SIGKILLed before the tour moves there: the tour raises with the
    job at its geometry publish and B still holding the state; C respawns in
    place and ``Itinerary.resume`` finishes with the calm tour's product."""
    sup, js = fab
    pins = {n: sup.pin(n) for n in ("B", "C")}
    nbs = _cluster(sup, tmp_path, names=("B", "C"), socket_paths=pins)
    job = js.create_job({"app": "viirs-cris-colocation"})
    sup.reclaim("C", notice=False)
    nbs.node("C").client.reconnect_timeout_s = 1.0  # fail fast, not after 10s
    with pytest.raises(OSError):
        Itinerary(DHP(nbs, "A", js, chunk_bytes=1 << 14), job.job_id).run(
            {}, _colocation_stages())
    j = js.read_job(job.job_id)
    assert j.status == STATUS_CKPT and j.step == 1  # the geometry publish
    assert nbs.call("B", "svc/ping")["resident"] >= 1  # the holder kept its copy

    sup.spawn("C", serve_only=True, socket_path=pins["C"])
    nbs.call("C", "svc/ping")  # reconnect the proxy to the new incarnation
    it2 = Itinerary(DHP(nbs, "A", js, chunk_bytes=1 << 14), job.job_id)
    out = it2.resume(_colocation_stages())
    assert [n for n, _ in it2.trace] == ["match"]
    _assert_same_product(out, _in_process_tour(tmp_path))
    assert list(nbs.hop_root.iterdir()) == []
    assert fsck_store(js.cmi_root(job.job_id)).clean


def test_unaddressable_stage_localizes(fab, tmp_path):
    """A stage fn the worker cannot import (a lambda, or a reference the
    worker cannot resolve) streams the state back and runs in the driver."""
    from repro_torch.fabric import worker as fw

    sup, _ = fab
    nbs = _cluster(sup, tmp_path, names=("B",))
    x = torch.from_numpy(np.random.default_rng(22).standard_normal((128, 64)))
    stages = [
        Stage("B", fw.tour_read, "read"),
        Stage("B", fw.tour_write, "write", fn_ref="no.such.module:tour_write"),
        Stage("B", lambda s: {**s, "x": s["x"] * 2.0}, "double"),
    ]
    out = Itinerary(DHP(nbs, "A", chunk_bytes=1 << 14)).run({"x": x.clone()}, stages)
    want = fw.tour_write(fw.tour_read({"x": x.clone()}))
    assert torch.equal(out["x"], want["x"] * 2.0) and out["toured"] == 1
    assert list(nbs.hop_root.iterdir()) == []


def test_worker_asked_for_cuda_without_a_card_exits_nonzero(fab):
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    sup, _ = fab
    with pytest.raises(RuntimeError, match="died during startup"):
        sup.spawn("G", serve_only=True, device="cuda")
