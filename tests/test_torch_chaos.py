"""The port's chaos matrix, against the JAX package's, with torch workers.

The matrix's cells are the reference's, id for id and spec for spec; the
port fires every registered protocol state as often as the reference does;
and both the JAX package's coverage checker and the port's own
(``repro_torch.analysis``), pointed at the port's tree, find the fire
sites, ``SITES``, the port's cells and ``docs/fabric.md`` in 1:1
agreement. The live half runs a few real cells (multi-process, real
signals) with ``device="cpu"`` workers: the reference's four live cells of
``tests/test_chaos.py`` plus the two serve cells that need the serving
fleet. The full sweep is ``python -m repro_torch.chaos.matrix``.

The last tests pin the rule that keeps the fabric's stage fallback honest:
a stage never writes its argument, so the input a failed stage leaves
resident (``fabric/server.py``'s ``svc/run_stage``) is the original.
"""

import functools
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.coverage import check_coverage, extract_fire_sites
from repro.chaos import matrix as jax_matrix
from repro_torch.chaos import faults, matrix
from repro_torch.chaos.sites import FAMILIES, SITES, family
from repro_torch.core import NBS
from repro_torch.core import colocation as co
from repro_torch.fabric import stream, wire
from repro_torch.fabric import worker as fw
from repro_torch.fabric.proxy import FabricClient
from repro_torch.fabric.server import NodeServer
from repro_torch.utils import flatten_with_paths

PER_TEST_TIMEOUT_S = int(os.environ.get("NAVP_TEST_TIMEOUT", "180"))
REPO = Path(__file__).resolve().parent.parent
GRANULES = dict(n_scans=2, viirs_lines_per_scan=2, viirs_pixels_per_scan=40)


@pytest.fixture(autouse=True)
def _alarm_guard():
    def on_alarm(signum, frame):
        raise TimeoutError(f"chaos test exceeded {PER_TEST_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(PER_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _driver_role():
    """Tests run as the driver; restore whatever role the process had."""
    faults.set_role("driver")
    yield
    faults.set_role("driver")


# ---------------------------------------------------------------------------
# the matrix as data
# ---------------------------------------------------------------------------


def test_cells_are_the_reference_cells():
    assert matrix.CELLS == jax_matrix.CELLS
    assert matrix.SMOKE_IDS == jax_matrix.SMOKE_IDS
    assert len(matrix.CELLS) == 36
    assert len({c["id"] for c in matrix.CELLS}) == len(matrix.CELLS)
    assert {c["scenario"] for c in matrix.CELLS} == {"tour", "job", "fleet", "serve"}


def test_cell_registry_is_machine_readable():
    registry = matrix.cell_registry()
    assert registry == jax_matrix.cell_registry()
    assert len(registry) == len(matrix.CELLS)
    for cell in registry:
        assert cell["point"] in SITES
        assert cell["family"] == cell["point"].split(".")[0]
        assert set(cell) == {"id", "point", "family", "action",
                             "scenario", "role", "smoke"}
    assert sum(c["smoke"] for c in registry) == len(matrix.SMOKE_IDS)
    covered = {family(c["spec"]["point"]) for c in matrix.CELLS}
    assert covered == set(FAMILIES)


def test_fault_coverage_holds_over_the_port_tree():
    """Every fire site under src/repro_torch is registered, every SITES
    entry is fired and has a cell, and docs/fabric.md names each."""
    findings = check_coverage(REPO / "src" / "repro_torch", sites=SITES,
                              cells=matrix.CELLS, docs_path=REPO / "docs" / "fabric.md")
    assert findings == [], "\n".join(f"{f.code}: {f.message}" for f in findings)


def test_port_coverage_checker_holds_over_the_port_tree():
    """The port's own checker (``repro_torch.analysis``), with its default
    SITES and cells, finds what the reference's finds over the port."""
    from repro_torch.analysis.coverage import check_coverage as port_check_coverage

    docs = REPO / "docs" / "fabric.md"
    findings = port_check_coverage(REPO / "src" / "repro_torch", docs_path=docs)
    assert findings == [], "\n".join(f"{f.code}: {f.message}" for f in findings)
    doctored = {k: v for k, v in SITES.items() if k != "hop.after_save"}
    port = port_check_coverage(REPO / "src" / "repro_torch", sites=doctored, docs_path=docs)
    ref = check_coverage(REPO / "src" / "repro_torch", sites=doctored,
                         cells=matrix.CELLS, docs_path=docs)
    assert [(f.code, f.path, f.line) for f in port] == [(f.code, f.path, f.line) for f in ref]
    assert {f.code for f in port} >= {"NAV501", "NAV504", "NAV506"}


def test_port_fires_each_point_as_often_as_the_reference():
    """Site for site: the four serve points included (admit, the migration
    stream's frames, drain, the reclaim notice)."""
    port = extract_fire_sites(REPO / "src" / "repro_torch")
    ref = extract_fire_sites(REPO / "src" / "repro")
    assert {p: len(v) for p, v in port.items()} == {p: len(v) for p, v in ref.items()}
    serve = {p: [Path(f).name for f, _ in v] for p, v in port.items() if p.startswith("serve.")}
    assert serve == {"serve.admit": ["worker.py"], "serve.migrate.mid_stream": ["worker.py"],
                     "serve.drain": ["worker.py"], "serve.reclaim.notice": ["worker.py"]}


def test_matrix_cli_lists_and_rejects(capsys):
    assert matrix.main(["--smoke", "--list"]) == 0
    assert capsys.readouterr().out.split() == matrix.SMOKE_IDS
    with pytest.raises(SystemExit):
        matrix.main(["--cells", "hop.nowhere:error"])


# ---------------------------------------------------------------------------
# live matrix cells (real torch worker processes, real kills)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell_id", [
    "hop.before_receipt:kill_conn",  # dedup resend converges, no respawn
    "wire.send_bulk:garble",  # crc trips -> stream falls back to store
    "publish.before_commit:sigkill",  # paper Q4: torn commit never wins
    "agent.respawn:error",  # fleet: agent retries with backoff, gen bumps
    "serve.migrate.mid_stream:kill_conn",  # both stream legs die -> store leg
    "serve.reclaim.notice:sigkill",  # notice cut short -> resume from cadence
])
def test_live_matrix_cell(cell_id):
    cell = next(c for c in matrix.CELLS if c["id"] == cell_id)
    matrix.run_cell(cell, device="cpu")  # raises AssertionError on any breach


# ---------------------------------------------------------------------------
# a stage never writes its argument
# ---------------------------------------------------------------------------


def _snapshot(tree) -> dict:
    leaves, _ = flatten_with_paths(tree)
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in leaves.items()}


def _unchanged(tree, snap) -> None:
    leaves, _ = flatten_with_paths(tree)
    assert set(leaves) == set(snap)
    for k, v in leaves.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == snap[k].dtype and torch.equal(v, snap[k]), k
        else:
            assert v == snap[k], k


def _stage_inputs() -> dict:
    """Each stage function of the port -> (the function, an input it takes)."""
    read = co.stage_read({"tag": 1}, device="cpu", seed=0, **GRANULES)
    geo = co.stage_geometry(read)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 8)))
    return {
        "stage_read": (functools.partial(co.stage_read, device="cpu", seed=0, **GRANULES),
                       {"tag": 1, "x": x.clone()}),
        "stage_geometry": (co.stage_geometry, read),
        "stage_match": (co.stage_match, geo),
        "stage_product": (co.stage_product, co.stage_match(geo)),
        "tour_read": (fw.tour_read, {"x": x.clone()}),
        "tour_compute": (fw.tour_compute, {"x": x.clone()}),
        "tour_write": (fw.tour_write, {"x": x.clone(), "toured": 1}),
    }


STAGES = ("stage_read", "stage_geometry", "stage_match", "stage_product",
          "tour_read", "tour_compute", "tour_write")


def test_stage_list_names_every_stage_of_the_port():
    assert set(STAGES) == set(_stage_inputs())
    assert {n for n in vars(co) if n.startswith("stage_")} | {
        n for n in vars(fw) if n.startswith("tour_")} == set(STAGES)


@pytest.mark.parametrize("name", STAGES)
def test_stage_leaves_its_input_bitwise_unchanged(name):
    fn, state = _stage_inputs()[name]
    snap = _snapshot(state)
    fn(state)
    _unchanged(state, snap)


def test_failed_stage_leaves_the_original_input_resident(tmp_path):
    """svc/run_stage keeps a failed stage's input resident for the
    caller's fallback; because stages do not write their argument, what
    stays resident — and what a fetch brings back — is the input itself."""
    nbs = NBS(tmp_path / "s3")
    nbs.add_node("W", device="cpu")
    srv = NodeServer(nbs, "W", ("unix", str(tmp_path / "w.sock"))).start()
    try:
        x = torch.from_numpy(np.random.default_rng(9).standard_normal((32, 4)))
        sent = {"y": x.clone(), "step": 3}  # tour stages read "x": this one raises
        receipt, _ = stream.send_state_stream(srv.address, sent, src="A", step=3)
        token = receipt["token"]
        with FabricClient(srv.address) as client, \
                pytest.raises(wire.RemoteError, match="KeyError"):
            client.request("svc/run_stage", token=token,
                           fn="repro_torch.fabric.worker:tour_read")
        kept, _ = srv.resident[token]
        assert torch.equal(kept["y"], x) and int(kept["step"]) == 3
        back, _, _ = stream.fetch_state_stream(srv.address, token, device="cpu")
        assert torch.equal(back["y"], x)
    finally:
        srv.stop()
