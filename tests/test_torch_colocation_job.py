"""The slice as a whole: the Fig. 7 co-location job survives a preemption
in both packages, from seed 0, and the products agree.

The JAX package's job is the one in ``tests/test_system.py``; the port runs
the same stages on CPU nodes. The geometry differs by float32 ulps (the two
frameworks' sin/cos), so a pixel whose two best CrIS fields of view are
within a few ulps of a tie may pick the other one: every such pixel is
checked to be a near-tie in the JAX package's own scores, and the rest of
the product is held exactly (counts) or to float32 rounding (means, whose
``segment_sum`` became ``index_add_`` and sums in another order). Fed the
JAX package's float32 geometry, the port's match is exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DHP as JDHP, NBS as JNBS, JobStore as JJobStore
from repro.core import cmi as jcmi
from repro.core import colocation as jco
from repro.core.dhp import Preempted as JPreempted
from repro.core.itinerary import Itinerary as JItinerary, Stage as JStage
from repro.core.jobstore import STATUS_CKPT as J_CKPT, STATUS_FINISHED as J_FINISHED
from repro.core.preemption import run_preemptible as j_run_preemptible
from repro_torch.checkpoint.fsck import fsck_store
from repro_torch.core import DHP, NBS, JobStore, restore_cmi
from repro_torch.core import colocation as co
from repro_torch.core.dhp import Preempted
from repro_torch.core.itinerary import Itinerary, Stage
from repro_torch.core.jobstore import STATUS_CKPT, STATUS_FINISHED
from repro_torch.core.preemption import run_preemptible

GRANULES = dict(n_scans=2, viirs_pixels_per_scan=200, viirs_lines_per_scan=2)


def _run_jax_job(root):
    nbs = JNBS(root / "s3")
    nbs.add_node("cloud-0", mesh=None)
    nbs.add_node("cloud-1", mesh=None)
    store = JJobStore(root / "jobs")
    job = store.create_job({"app": "viirs-cris"})
    final = {}

    def stage_read(s):
        g = jco.make_synthetic_granules(0, **GRANULES)
        return {**s, **{k: jnp.asarray(v) for k, v in g.items()}}

    def stage_geometry(s):
        los = jco.cris_los_ecef(s["cris_lat"], s["cris_lon"], s["sat_pos"])
        pos = jco.viirs_pos_ecef(s["viirs_lat"], s["viirs_lon"])
        return {**s, "los": los, "pos": pos}

    def stage_match(s):
        idx, cos, within = jco.match_viirs_to_cris(s["pos"], s["los"], s["sat_pos"])
        return {**s, "idx": idx, "within": within}

    killed = {"done": False}

    def make_worker(incarnation):
        def worker():
            node = f"cloud-{incarnation}"
            dhp = JDHP(nbs, node, store)
            it = JItinerary(dhp, job.job_id)
            stages = [JStage(node, stage_read, "read", publish=True),
                      JStage(node, stage_geometry, "geom", publish=True),
                      JStage(node, stage_match, "match", publish=True)]
            if store.read_job(job.job_id).status == J_CKPT:
                s = it.resume(stages)
            else:
                s = it.run({}, stages)
                if not killed["done"]:
                    killed["done"] = True
                    raise JPreempted("spot reclaim after match stage published")
            g = {k: np.asarray(v) for k, v in s.items() if hasattr(v, "shape")}
            prod = jco.build_product({"cris_lat": g["cris_lat"], "viirs_rad": g["viirs_rad"]},
                                     s["idx"], s["within"])
            dhp.publish(job.job_id, J_FINISHED, product={"matched_frac": prod["matched_frac"]})
            final.update(g)
            return prod

        return worker

    prod, inc = j_run_preemptible(make_worker)
    return prod, inc, store.read_job(job.job_id).status, final


def _run_port_job(root):
    nbs = NBS(root / "s3")
    nbs.add_node("cloud-0", device="cpu")
    nbs.add_node("cloud-1", device="cpu")
    store = JobStore(root / "jobs")
    job = store.create_job({"app": "viirs-cris"})
    final = {}
    killed = {"done": False}

    def stage_read(s):
        return co.stage_read(s, device="cpu", seed=0, **GRANULES)

    def make_worker(incarnation):
        def worker():
            node = f"cloud-{incarnation}"
            dhp = DHP(nbs, node, store)
            it = Itinerary(dhp, job.job_id)
            stages = [Stage(node, stage_read, "read", publish=True),
                      Stage(node, co.stage_geometry, "geom", publish=True),
                      Stage(node, co.stage_match, "match", publish=True)]
            if store.read_job(job.job_id).status == STATUS_CKPT:
                s = it.resume(stages)
            else:
                s = it.run({}, stages)
                if not killed["done"]:
                    killed["done"] = True
                    raise Preempted("spot reclaim after match stage published")
            prod = co.stage_product(s)
            dhp.publish(job.job_id, STATUS_FINISHED, product={"matched_frac": prod["matched_frac"]})
            final.update({k: v for k, v in s.items() if isinstance(v, torch.Tensor)})
            return prod

        return worker

    prod, inc = run_preemptible(make_worker)
    return prod, inc, store, job.job_id, final


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    jprod, jinc, jstatus, jstate = _run_jax_job(tmp_path_factory.mktemp("jax"))
    tprod, tinc, store, job_id, tstate = _run_port_job(tmp_path_factory.mktemp("port"))
    return dict(jprod=jprod, jinc=jinc, jstatus=jstatus, jstate=jstate,
                tprod=tprod, tinc=tinc, store=store, job_id=job_id, tstate=tstate)


def test_both_survive_preemption_and_finish(jobs):
    assert jobs["jinc"] == jobs["tinc"] == 2
    assert jobs["jstatus"] == J_FINISHED
    assert jobs["store"].read_job(jobs["job_id"]).status == STATUS_FINISHED
    assert jobs["tprod"]["matched_frac"] > 0.9
    assert abs(jobs["tprod"]["matched_frac"] - jobs["jprod"]["matched_frac"]) <= 1e-6


def test_geometry_agrees_to_float32_ulps(jobs):
    js, ts = jobs["jstate"], jobs["tstate"]
    for k in ("cris_lat", "cris_lon", "viirs_lat", "viirs_lon", "viirs_rad", "sat_pos"):
        assert ts[k].dtype == torch.float32 and js[k].dtype == np.float32, k
        assert ts[k].numpy().tobytes() == js[k].tobytes(), k  # same granules
    # ECEF positions (~6e6 m): relative 1e-6; unit LOS vectors, whose
    # components cross zero: relative 1e-6 or 1e-6 absolute
    np.testing.assert_allclose(ts["pos"].numpy(), js["pos"], rtol=1e-6)
    np.testing.assert_allclose(ts["los"].numpy(), js["los"], rtol=1e-6, atol=1e-6)


def test_match_fed_jax_geometry_is_exact(jobs):
    js = jobs["jstate"]
    idx, cos, within = co.match_viirs_to_cris(
        torch.from_numpy(js["pos"]), torch.from_numpy(js["los"]), torch.from_numpy(js["sat_pos"]))
    np.testing.assert_array_equal(idx.numpy(), js["idx"])
    np.testing.assert_array_equal(within.numpy(), js["within"])
    jidx, jcos, _ = jco.match_viirs_to_cris(jnp.asarray(js["pos"]), jnp.asarray(js["los"]),
                                            jnp.asarray(js["sat_pos"]))
    assert cos.numpy().tobytes() == np.asarray(jcos).tobytes()
    # the reference paths (the JAX oracle, the port's plain version) agree too
    ridx, rcos, rwithin = co.match_viirs_to_cris_ref(
        torch.from_numpy(js["pos"]), torch.from_numpy(js["los"]), torch.from_numpy(js["sat_pos"]))
    jridx, jrcos, _ = jco.match_viirs_to_cris_ref(jnp.asarray(js["pos"]), jnp.asarray(js["los"]),
                                                  jnp.asarray(js["sat_pos"]))
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(jridx))
    assert rcos.numpy().tobytes() == np.asarray(jrcos).tobytes()
    assert torch.equal(rwithin, within)


def test_products_agree(jobs):
    js, ts = jobs["jstate"], jobs["tstate"]
    jprod, tprod = jobs["jprod"], jobs["tprod"]
    m = js["cris_lat"].shape[0]
    jidx, tidx = js["idx"], ts["idx"].numpy()
    moved = np.flatnonzero(jidx != tidx)
    assert len(moved) <= len(jidx) // 100
    # every moved pixel is a near-tie in the JAX package's own scores
    u = np.asarray(jco._unit(jnp.asarray(js["pos"]) - jnp.asarray(js["sat_pos"])[None, :]))
    score = lambda i, j: float(np.dot(u[i].astype(np.float64), js["los"][j].astype(np.float64)))
    for i in moved:
        assert abs(score(i, jidx[i]) - score(i, tidx[i])) <= 4e-7, i
    np.testing.assert_array_equal(ts["within"].numpy(), js["within"])
    # counts: exact aggregation of each package's own match
    for prod, idx, within in ((jprod, jidx, js["within"]), (tprod, tidx, ts["within"].numpy())):
        np.testing.assert_array_equal(
            prod["cris_match_count"], np.bincount(idx[within], minlength=m).astype(np.int32))
    touched = np.zeros(m, bool)
    touched[jidx[moved]] = touched[tidx[moved]] = True
    same = ~touched
    np.testing.assert_array_equal(tprod["cris_match_count"][same], jprod["cris_match_count"][same])
    assert tprod["cris_match_count"].sum() == jprod["cris_match_count"].sum()
    # means: NaN exactly where nothing matched; float32 rounding elsewhere
    np.testing.assert_array_equal(np.isnan(tprod["cris_mean_rad"]), tprod["cris_match_count"] == 0)
    np.testing.assert_allclose(tprod["cris_mean_rad"][same], jprod["cris_mean_rad"][same],
                               rtol=1e-5)


def test_port_cmis_restore_in_jax_and_fsck_clean(jobs):
    store, job_id = jobs["store"], jobs["job_id"]
    root = store.cmi_root(job_id)
    names = store.list_cmis(job_id) + [store.read_job(job_id).product]
    assert len(names) >= 2
    for name in names:
        mine, _ = restore_cmi(root, name, device="cpu")
        theirs, _ = jcmi.restore_cmi(root, name)
        assert sorted(mine) == sorted(theirs)
        for k, v in mine.items():
            if isinstance(v, torch.Tensor):
                assert v.numpy().tobytes() == np.asarray(theirs[k]).tobytes(), (name, k)
            else:
                assert v == theirs[k], (name, k)
    assert fsck_store(root).clean
