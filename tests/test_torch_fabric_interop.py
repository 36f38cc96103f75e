"""One wire across both packages: JAX drivers and workers talk to torch ones.

* a JAX driver (``repro.core.DHP`` with ``add_remote_node``) stream-hops to
  a torch worker, deltas a second hop against the torch worker's resident
  copy, and fetches back bit-identically, bfloat16 leaf included;
* a torch worker ``svc/relay``s to a JAX worker (``python -m
  repro.fabric.worker``) and the JAX worker relays back;
* a torch driver store-hops a CMI onto a JAX worker and fetches it back.

Workers run on the CPU (``--device cpu`` for torch, ``JAX_PLATFORMS=cpu``
for JAX), each test under a SIGALRM guard.
"""

import os
import signal

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import DHP as JDHP
from repro.core import NBS as JNBS
from repro.fabric.supervisor import FabricSupervisor as JFabricSupervisor
from repro_torch.core import DHP, NBS
from repro_torch.core.nbs import RemoteStateRef
from repro_torch.fabric.supervisor import FabricSupervisor
from repro_torch.utils import from_numpy_tree

PER_TEST_TIMEOUT_S = int(os.environ.get("NAVP_TEST_TIMEOUT", "180"))


@pytest.fixture(autouse=True)
def _alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError(f"interop test exceeded {PER_TEST_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(PER_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def sups(tmp_path):
    """(torch supervisor, JAX supervisor) over one shared store."""
    tsup = FabricSupervisor(str(tmp_path / "s3"), device="cpu")
    jsup = JFabricSupervisor(str(tmp_path / "s3"))
    try:
        yield tsup, jsup
    finally:
        tsup.shutdown()
        jsup.shutdown()


def _np_state(seed: int, rows: int = 400) -> dict:
    g = np.random.default_rng(seed)
    return {
        "x": g.standard_normal((rows, 64)),
        "h": g.standard_normal((rows, 16)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "m": g.standard_normal(rows) > 0,
        "step": 5,
    }


def _np_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _assert_same(got: dict, want: dict) -> None:
    for k in ("x", "h", "m"):
        assert _np_bytes(got[k]) == _np_bytes(want[k]), k
    assert int(got["step"]) == int(want["step"])


def test_jax_driver_streams_to_torch_worker_and_back(sups, tmp_path):
    tsup, _ = sups
    h = tsup.spawn("T", serve_only=True)
    nbs = JNBS(tmp_path / "s3")
    nbs.add_node("A", mesh=None)
    tnode = nbs.add_remote_node("T", h.address)
    assert nbs.call("T", "svc/ping")["device"] == "cpu"  # a key JAX clients ignore
    dhp = JDHP(nbs, "A", chunk_bytes=1 << 14)
    vias = []
    nbs.plugins.subscribe("on_hop", lambda **kw: vias.append(kw["via"]))

    src = _np_state(1)
    ref = dhp.hop(dict(src), "T")
    assert ref.via == "stream" and ref.step == 5
    full = dict(tnode.last_stream_receipt)
    src2 = {**src, "x": src["x"].copy()}
    src2["x"][:40] += 1.0  # rows 0-39 of 32-row chunks: 2 chunks change
    ref2 = dhp.hop(dict(src2), "T")  # deltas against the torch worker's copy
    delta = dict(tnode.last_stream_receipt)
    assert delta["data_chunks"] == 2 and delta["ref_chunks"] == full["chunks"] - 2
    back = dhp.fetch(ref2)
    assert back["h"].dtype == ml_dtypes.bfloat16
    _assert_same(back, src2)
    assert list(nbs.hop_root.iterdir()) == []
    assert vias == ["stream", "stream", "fetch_stream"], vias


def test_torch_worker_relays_to_jax_worker_and_back(sups, tmp_path):
    tsup, jsup = sups
    th = tsup.spawn("T", serve_only=True)
    jh = jsup.spawn("J", serve_only=True)
    nbs = NBS(tmp_path / "s3")
    nbs.add_node("A", device="cpu")
    nbs.add_remote_node("T", th.address)
    nbs.add_remote_node("J", jh.address)
    dhp = DHP(nbs, "A", chunk_bytes=1 << 14)
    vias = []
    nbs.plugins.subscribe("on_hop", lambda **kw: vias.append(kw["via"]))

    src = _np_state(2)
    ref = dhp.hop(from_numpy_tree(src, "cpu"), "T")
    ref = dhp.hop(ref, "J")  # svc/relay on the torch worker, into the JAX one
    assert isinstance(ref, RemoteStateRef) and ref.node == "J" and ref.via == "stream"
    assert nbs.call("T", "svc/ping")["resident"] == 0
    assert nbs.call("J", "svc/ping")["resident"] == 1
    ref = dhp.hop(ref, "T")  # and the JAX worker relays it back
    assert ref.node == "T" and nbs.call("J", "svc/ping")["resident"] == 0
    back = dhp.fetch(ref)
    assert back["h"].dtype == torch.bfloat16 and back["m"].dtype == torch.bool
    _assert_same(back, src)
    assert vias == ["stream", "relay", "relay", "fetch_stream"], vias
    assert list(nbs.hop_root.iterdir()) == []


def test_torch_driver_store_hops_onto_jax_worker(sups, tmp_path):
    _, jsup = sups
    jh = jsup.spawn("J", serve_only=True)
    nbs = NBS(tmp_path / "s3")
    nbs.add_node("A", device="cpu")
    nbs.add_remote_node("J", jh.address)
    dhp = DHP(nbs, "A")
    src = _np_state(3)
    ref = dhp.hop(from_numpy_tree(src, "cpu"), "J", via="store")
    assert isinstance(ref, RemoteStateRef) and ref.via == "store" and ref.leaves == 4
    assert list(nbs.hop_root.iterdir()) == []  # the JAX worker GC'd the transit CMI
    back = dhp.fetch(ref, via="store")
    _assert_same(back, src)
    assert list(nbs.hop_root.iterdir()) == []
