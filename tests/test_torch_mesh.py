"""The port's mesh half on gloo process groups (CPU ranks), against the JAX
package on forced host devices.

* CMIs cross between the packages and between meshes bit for bit: the JAX
  package writes on a 4×2 mesh (8 host devices, in a subprocess), the port
  restores on a 2×2 torch mesh (each rank reading its own shards, the
  specs remapped) and on no mesh; the port writes on 2×2 (ranks send their
  shards to rank 0), the JAX package restores that on 4×2. The port's
  sharding records, chunk slices and chunk digests equal the JAX
  package's for the same state on the same mesh; a replicated array is
  written once.
* The 2×2 train step agrees with the reference's ``Model.loss(...,
  n_groups=2)`` and ``adamw_update`` on unsharded inputs, in float32, to
  1e-5 of each compared tensor's largest magnitude (a data-parallel sum
  adds in another order than one device does), for qwen3 and granite
  (both on their shards).
* The tensor-parallel train step (``distributed/tp.py``) of the dense and
  vlm families against the same unsharded reference step, with and
  without ``seq_shard``: qwen3 and internvl2 on 2×2 (q and kv heads split)
  and on 1×4 (qwen3: one q head a rank, G = 2, kv heads whole, each rank
  reading a view of one), and yi-34b's smoke config with 6 heads and 2 kv
  heads on 1×4 (its heads do not divide, as yi's 56 on 16: the attention
  runs whole on every rank, the MLP and vocab split). With
  ``DTensor.full_tensor`` raising, every dense and vlm train, prefill and
  decode step runs on 2×2 and records the ``tp`` path.
* The MoE family on its shards (granite: GQA + MoE; deepseek-v3: MLA +
  MoE), against the reference's unsharded step with as many routing groups
  as data rows, on 2×2 (experts over (data, model), and granite with 6
  experts over model alone) and 1×4, each without and with
  ``moe_buf_shard`` and ``seq_shard``; a MoE layer alone at a capacity that
  drops assignments, against the reference's; with
  ``DTensor.full_tensor`` raising, their train, prefill and decode steps
  run on 2×2 and record the ``tp`` path.
* hymba's, xlstm's and whisper's steps take ``seq_shard`` and
  ``moe_buf_shard`` (``test_torch_mesh_hybrid.py`` and
  ``test_torch_mesh_encdec.py`` hold their steps against the reference):
  the flags that change nothing there leave the step bitwise as it was.
* The launcher's elastic restart: ``--remesh 2x2,1x2`` with a reclaim
  resumes from a state bitwise the published one and goes on within 1e-5
  of an uninterrupted 2×2 run (the model axis kept, so each model rank
  computes as before); ``--remesh 2x2,2x1`` (the model axis shrunk)
  resumes bitwise from the published state; ``--remesh 2x2,2x2`` ends
  bitwise equal to the uninterrupted run; a one-rank mesh equals no mesh
  bit for bit.
* ``sharding_context``/``constrain`` redistribute a DTensor activation to
  the placements installed for its kind.

One 4-rank group runs every in-group check (module fixture); each group
and subprocess has its own deadline, so a hang fails in seconds.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_manifest
from repro_torch.configs import get_smoke_config
from repro_torch.core import JobStore
from repro_torch.core.cmi import restore_cmi, save_cmi, snapshot_to_host
from repro_torch.distributed.group import check_devices, run_ranks
from repro_torch.distributed.sharding import NamedSharding, P, distribute, sharding_of
from repro_torch.launch import train as launch_train

GROUP_TIMEOUT_S = 120
TRAIN_ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m")

# Arrays and their specs, the same in both packages: sharded on one and two
# axes, a two-axis entry, replicated (written once), bf16 and int32.
SPECS = {"w": ("data", "model"), "e": (None, "model"), "x": (),
         "y": (("data", "model"), None), "b": ("model", None), "i": ("data", None)}


def _arrays():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "e": rng.standard_normal((8, 12)).astype(np.float32),
            "x": np.arange(1024, dtype=np.float32),
            "y": rng.standard_normal((16, 4)).astype(np.float32),
            "b": (rng.standard_normal((8, 6)).astype(np.float32).view(np.uint32) >> 16)
            .astype(np.uint16),  # bf16 bits
            "i": rng.integers(0, 100, (4, 8)).astype(np.int32)}


JAX_WRITE = r"""
import sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_mesh import SPECS, _arrays
from repro.configs import get_smoke_config
from repro.core.cmi import save_cmi
from repro.distributed.steps import make_init_fn
from repro.optim import AdamWConfig

root = {root!r}
arrays = _arrays()
arrays["b"] = arrays["b"].view(jnp.bfloat16)

def place(mesh):
    st = {{k: jax.device_put(v, NamedSharding(mesh, P(*SPECS[k]))) for k, v in arrays.items()}}
    st["step"] = 7
    return st

mesh42 = jax.make_mesh((4, 2), ("data", "model"))
mesh22 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
save_cmi(root, "jax42", place(mesh42), step=7)
save_cmi(root, "jax22", place(mesh22), step=7)
cfg = get_smoke_config("qwen3-1.7b")
for name, mesh in (("jax42_train", mesh42), ("jax22_train", mesh22)):
    init_fn, _ = make_init_fn(cfg, mesh, AdamWConfig())
    save_cmi(root, name, init_fn(), step=0)
print("JAX_WRITE_OK")
"""

JAX_READ = r"""
import sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_mesh import SPECS, _arrays
from repro.core.cmi import restore_cmi

root = {root!r}
arrays = _arrays()
mesh42 = jax.make_mesh((4, 2), ("data", "model"))
got, man = restore_cmi(root, "torch22", mesh=mesh42)
assert man.step == 7 and got["step"] == 7
for k, want in arrays.items():
    g = np.asarray(got[k])
    g = g.view(np.uint16) if k == "b" else g
    assert g.tobytes() == want.tobytes(), k
    assert got[k].sharding.mesh.devices.shape == (4, 2)
assert got["w"].sharding.spec == P("data", "model")
assert got["y"].sharding.spec == P(("data", "model"), None)
assert got["x"].sharding.spec == P(None)
full, _ = restore_cmi(root, "jax42_train", mesh=None)
mine, _ = restore_cmi(root, "torch22_train", mesh=mesh42)
fl, ml = jax.tree_util.tree_leaves(full), jax.tree_util.tree_leaves(mine)
assert len(fl) == len(ml) > 10
for a, b in zip(fl, ml):
    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
print("JAX_READ_OK")
"""


def _group_checks(rank: int, root: str, step_inputs: str) -> dict:
    """Every in-group check on a 2×2 ``("data", "model")`` mesh of 4 gloo
    ranks; rank 0 returns what the tests assert."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.steps import (make_train_step, train_state_from_numpy,
                                               train_state_shardings)
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import flatten_with_paths

    from repro_torch.launch.mesh import make_debug_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    arrays = _arrays()
    out: dict = {"rank": rank}
    debug = make_debug_mesh(n_model=2, device_type="cpu")
    out["debug_mesh"] = (tuple(debug.shape), tuple(debug.mesh_dim_names))
    out["debug_mesh_1"] = tuple(make_debug_mesh(device_type="cpu").shape)

    def t(k, v):
        x = torch.from_numpy(v)
        return x.view(torch.bfloat16) if k == "b" else x

    # (1) the JAX package's 4x2 CMI on this 2x2 mesh, each rank its blocks
    state, man = restore_cmi(root, "jax42", mesh=mesh)
    out["jax42_specs"] = {k: tuple(sharding_of(state[k]).spec) for k in arrays}
    out["jax42_step"] = (man.step, state["step"])
    bad = []
    for k, v in arrays.items():
        dt = state[k]
        sh = sharding_of(dt)
        block = sh.shard_index(v.shape, tuple(mesh.get_coordinate()))
        want = t(k, v)[tuple(slice(a, b) for a, b in block)]
        if not (isinstance(dt, DTensor) and torch.equal(dt.to_local(), want)
                and torch.equal(dt.full_tensor(), t(k, v))):
            bad.append(k)
    out["jax42_bad"] = bad
    full, _ = restore_cmi(root, "jax42", device="cpu")  # no mesh: whole tensors
    out["jax42_nomesh_bad"] = [k for k, v in arrays.items()
                               if full[k].device.type != "cpu" or not torch.equal(full[k], t(k, v))]

    # (2) the same arrays written by the port on 2x2: shards gathered to rank 0
    tstate = {k: distribute(t(k, v), NamedSharding(mesh, P(*SPECS[k])))
              for k, v in arrays.items()}
    tstate["step"] = 7
    host = snapshot_to_host(tstate)
    if rank == 0:
        save_cmi(root, "torch22", host, step=7)
    else:
        out["others_get_none"] = all(host[k] is None for k in arrays)

    # (3) the JAX package's 4x2 train state on 2x2, bitwise, then re-pinned to
    # the port's rules and written as the port's 2x2 train-state CMI
    cfg = get_smoke_config("qwen3-1.7b")
    ts, _ = restore_cmi(root, "jax42_train", mesh=mesh)
    whole, _ = restore_cmi(root, "jax42_train", device="cpu")
    tflat, wflat = flatten_with_paths(ts)[0], flatten_with_paths(whole)[0]
    out["train_bad"] = [k for k in wflat if not torch.equal(tflat[k].full_tensor(), wflat[k])]
    out["train_n"] = len(wflat)
    ts = place_tree(ts, train_state_shardings(cfg, AdamWConfig(), mesh))
    host = snapshot_to_host(ts)
    if rank == 0:
        save_cmi(root, "torch22_train", host, step=0)

    # (4) one sharded train step a model, against the reference's numbers
    with open(step_inputs, "rb") as f:
        cases = pickle.load(f)
    out["steps"] = {}
    for arch, case in cases.items():
        cfg = get_smoke_config(arch).with_(dtype="float32")
        opt_cfg = AdamWConfig()
        st = train_state_from_numpy(case["state"], cfg, opt_cfg, mesh=mesh)
        step_fn = make_train_step(cfg, opt_cfg, mesh=mesh, **case["sched"])
        batch = {k: torch.from_numpy(v).long() for k, v in case["batch"].items()}
        st, m = step_fn(st, batch)
        new = {k: v.full_tensor().numpy() for k, v in flatten_with_paths(
            {"params": st["params"], "opt": st["opt"]})[0].items()}
        out["steps"][arch] = {"new": new, "loss": float(m["loss"]), "lr": float(m["lr"]),
                              "grad_norm": float(m["grad_norm"]),
                              "step": int(st["step"].to_local())}

    # (5) sharding_context: a DTensor activation comes back with the
    # placements installed for its kind; a plain tensor, a kind with none
    # installed and anything outside the context come back as they are
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.ctx import constrain, sharding_context
    from repro_torch.distributed.sharding import local_block

    resid = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    x = distribute(resid, NamedSharding(mesh, P("data", None, None)))
    want = NamedSharding(mesh, P("data", None, "model"))
    with sharding_context({"resid": want}):
        y = constrain(x, "resid")
        same = [constrain(resid, "resid") is resid, constrain(x, "moe_buf") is x]
    same.append(constrain(x, "resid") is x)
    out["ctx"] = {"placements": list(y.placements) == [Shard(0), Shard(2)],
                  "spec": tuple(sharding_of(y).spec),
                  "local": torch.equal(y.to_local(), local_block(resid, want)),
                  "full": torch.equal(y.full_tensor(), resid), "same": same}
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """The JAX package's CMIs, the group's checks and the port's CMIs, and
    the reference's step numbers they are held to."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import Model as JModel
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.optim.adamw import adamw_update as jax_adamw
    from repro.optim.adamw import init_opt_state as jax_init_opt
    from repro.optim.schedules import warmup_cosine as jax_warmup
    from repro.utils import flatten_with_paths as jax_flatten

    from conftest import run_python as subproc

    root = tmp_path_factory.mktemp("cmis")
    tests = str(__import__("pathlib").Path(__file__).parent)
    assert "JAX_WRITE_OK" in subproc(JAX_WRITE.format(root=str(root), tests=tests), devices=8,
                                     timeout=GROUP_TIMEOUT_S)
    sched = {"peak_lr": 3e-3, "warmup": 5, "total_steps": 10}
    cases, want = {}, {}
    for arch in TRAIN_ARCHS:
        jcfg = jax_smoke_config(arch).with_(dtype="float32")
        jm = JModel(jcfg)
        params, _ = jm.init(jax.random.PRNGKey(1))
        opt = jax_init_opt(params, JAdamW())
        rng = np.random.default_rng(3)
        batch = {k: rng.integers(0, jcfg.vocab, (4, 12)).astype(np.int32)
                 for k in ("tokens", "labels")}
        batch["labels"][0, :5] = -1  # unequal valid labels across the shards
        state = {"params": params, "opt": opt, "step": jnp.asarray(3, jnp.int32),
                 "rng": jnp.asarray([0, 1], jnp.uint32),
                 "data": {"data_step": jnp.asarray(3, jnp.int32),
                          "seed": jnp.asarray(0, jnp.int32)}}
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, n_groups=2)
        )(params)
        lr = jax_warmup(state["step"], total=sched["total_steps"], warmup=sched["warmup"],
                        peak_lr=sched["peak_lr"])
        new_p, new_o, om = jax_adamw(grads, opt, params, lr, JAdamW())
        cases[arch] = {"state": jax.tree_util.tree_map(np.array, state), "batch": batch,
                       "sched": sched}
        want[arch] = {"loss": float(loss), "lr": float(lr), "grad_norm": float(om["grad_norm"]),
                      "new": {k: np.asarray(v) for k, v in
                              jax_flatten({"params": new_p, "opt": new_o})[0].items()}}
    inputs = root / "step_inputs.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    out = run_ranks(_group_checks, 4, args=(str(root), str(inputs)),
                    timeout_s=GROUP_TIMEOUT_S, threads=2)
    jax_read = subproc(JAX_READ.format(root=str(root), tests=tests), devices=8,
                       timeout=GROUP_TIMEOUT_S)
    return {"root": root, "ranks": out, "want": want, "jax_read": jax_read}


def test_jax_cmi_restores_on_a_torch_2x2_mesh_and_on_no_mesh(crossed):
    """Written on 4×2 by the JAX package: on 2×2 every rank holds its block
    of every array (and the gathered whole), the specs remapped by axis
    name; on no mesh, whole tensors; all bitwise."""
    for r in crossed["ranks"]:
        assert r["jax42_bad"] == [] and r["jax42_nomesh_bad"] == []
        assert r["jax42_step"] == (7, 7)
        assert r["jax42_specs"] == {"w": ("data", "model"), "e": (None, "model"),
                                    "x": (None,), "y": (("data", "model"), None),
                                    "b": ("model", None), "i": ("data", None)}
        assert r["train_bad"] == [] and r["train_n"] > 10
        assert r["debug_mesh"] == ((2, 2), ("data", "model")) and r["debug_mesh_1"] == (4, 1)


def test_torch_cmi_records_and_chunks_equal_jax_and_restore_in_jax(crossed):
    """Written by the port on 2×2 (ranks send their shards to rank 0): the
    JAX package restores it on 4×2 bitwise (arrays and the re-pinned train
    state); its sharding records, chunk slices and digests equal the JAX
    package's 2×2 CMI of the same state, array for array; the replicated
    array is written once and a sharded one's chunks tile it."""
    assert "JAX_READ_OK" in crossed["jax_read"]
    assert all(r.get("others_get_none", True) for r in crossed["ranks"])
    root = crossed["root"]
    for mine, theirs in (("torch22", "jax22"), ("torch22_train", "jax22_train")):
        a, b = load_manifest(root, mine), load_manifest(root, theirs)
        assert sorted(a.arrays) == sorted(b.arrays)
        for path, ea in a.arrays.items():
            eb = b.arrays[path]
            assert (ea.shape, ea.dtype, ea.sharding) == (eb.shape, eb.dtype, eb.sharding), path
            assert [(c.slice, c.hash) for c in ea.chunks] == \
                [(c.slice, c.hash) for c in eb.chunks], path
    man = load_manifest(root, "torch22")
    x = man.arrays["x"]
    assert x.sharding.pspec == [] and x.sharding.mesh_shape == [2, 2]
    assert [c.slice for c in x.chunks] == [[[0, 1024]]]  # one copy, not four
    slices = sorted(tuple(map(tuple, c.slice)) for c in man.arrays["y"].chunks)
    assert [s[0] for s in slices] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert man.arrays["y"].sharding.pspec == [["data", "model"], None]
    assert load_manifest(root, "torch22_train").arrays["opt/mu/embed"].sharding.pspec == \
        ["model", "data"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_equals_reference(crossed, arch):
    """One step on 2×2 (float32, two routing groups = the two data shards,
    unequal valid labels) against the reference's unsharded step: the
    global-mean loss, the learning rate, the global gradient norm and the
    moments (linear and quadratic in the summed gradient) within 1e-5 of
    each max. AdamW's first update divides each moment by its own root, so
    a gradient near 0, whose float32 sum over the shards has a large
    relative error, moves its weight by up to lr either way: params and
    master weights are within 1e-5 of each max wherever the reference's
    gradient is above 1e-3 of its largest or exactly 0, and within 2 lr
    everywhere (the unsharded step's own criterion, ``test_torch_train.py``).
    Every rank ends with the same numbers."""
    _assert_step_equals_reference(crossed["want"][arch],
                                  [r["steps"][arch] for r in crossed["ranks"]])


def _assert_step_equals_reference(want: dict, got: list[dict]) -> None:
    """``test_sharded_train_step_equals_reference``'s criteria, every rank."""
    lr = want["lr"]
    for g in got:
        assert g["step"] == 4
        assert g["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert g["lr"] == pytest.approx(lr, rel=1e-6)
        assert g["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-5)
        assert sorted(g["new"]) == sorted(want["new"])
        for k, w in want["new"].items():
            w, x = np.asarray(w, np.float32), g["new"][k].astype(np.float32)
            err = np.abs(x - w)
            if k.startswith(("opt/mu", "opt/nu")) or k == "opt/count":
                assert err.max() <= 1e-5 * max(np.abs(w).max(), 1e-12), k
                continue
            assert err.max() <= 2 * lr, k
            leaf = k.removeprefix("params/").removeprefix("opt/master/")
            mu = np.abs(np.asarray(want["new"]["opt/mu/" + leaf], np.float32))
            # a firm gradient, or none at all (an untied embedding's rows of
            # tokens the batch lacks: only the weight decay moves them)
            firm = (mu > 1e-3 * mu.max()) | (mu == 0)
            assert firm.mean() > 0.5, k
            assert err[firm].max() <= 1e-5 * max(np.abs(w).max(), 1e-12), k
    for g in got[1:]:
        assert all(np.array_equal(g["new"][k], got[0]["new"][k]) for k in g["new"])


def assert_step_equals_reference(want: dict, got: list[dict]) -> None:
    """``test_torch_mesh._assert_step_equals_reference`` with AdamW's
    second moment ``nu`` (the gradient's square, after one update) held by
    its root, linear in the gradient as ``mu`` is: held as it is, ``nu``
    holds its largest gradient to half the tolerance ``mu`` does. The SSD's
    ``dt_bias`` gradient sums terms that cancel: the port's unsharded step
    differs from the reference's by 1.07e-5 of the max in its ``nu`` and
    5.8e-6 in its ``mu`` (hymba smoke, these inputs), so held as it is
    ``nu`` measures float32 order, not the sharding.

    An attention's key bias ``bk`` adds ``q.b`` to every score of a row,
    which softmax cancels: its gradient is 0 up to rounding in both
    packages (``test_torch_encdec.py``), so its moments are held to 1e-6
    of the largest of their kind in both, and AdamW's first update moves
    each of its weights by up to lr either way (held within 2 lr)."""
    def roots(step: dict) -> dict:
        return {**step, "new": {k: np.sqrt(np.asarray(v, np.float32)) if k.startswith("opt/nu/")
                                else v for k, v in step["new"].items()}}

    want, got = roots(want), [roots(g) for g in got]
    zero = sorted(k for k in want["new"] if k.endswith("/bk"))
    for g in got:
        for k in zero:
            w, x = np.asarray(want["new"][k], np.float32), g["new"][k].astype(np.float32)
            kind = k.split("/")[1] if k.startswith("opt/") else "params"
            if kind in ("mu", "nu"):
                scale = max(float(np.abs(np.asarray(v, np.float32)).max())
                            for n, v in want["new"].items() if n.startswith(f"opt/{kind}/"))
                assert max(np.abs(w).max(), np.abs(x).max()) <= 1e-6 * scale, k
            else:
                assert np.abs(x - w).max() <= 2 * want["lr"], k
    _assert_step_equals_reference(
        {**want, "new": {k: v for k, v in want["new"].items() if k not in zero}},
        [{**g, "new": {k: v for k, v in g["new"].items() if k not in zero}} for g in got])


def reference_steps(cases: dict, config, batch_of, tmp_path) -> tuple:
    """The reference's unsharded step for each case (``config(jax smoke
    config, case)``, ``batch_of(cfg)``; ``perturb(params, rng)`` where
    ``cases`` maps a case to it), from its init at key 1 at step 3, and the
    inputs pickled for the ranks: ``(path, want)``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import Model as JModel
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.optim.adamw import adamw_update as jax_adamw
    from repro.optim.adamw import init_opt_state as jax_init_opt
    from repro.optim.schedules import warmup_cosine as jax_warmup
    from repro.utils import flatten_with_paths as jax_flatten

    inputs, want = {}, {}
    for case, perturb in cases.items():
        jcfg = config(jax_smoke_config, case)
        jm = JModel(jcfg)
        params, _ = jm.init(jax.random.PRNGKey(1))
        if perturb is not None:
            params = perturb(params, np.random.default_rng(11))
        opt = jax_init_opt(params, JAdamW())
        batch = batch_of(jcfg)
        state = {"params": params, "opt": opt, "step": jnp.asarray(3, jnp.int32),
                 "rng": jnp.asarray([0, 1], jnp.uint32),
                 "data": {"data_step": jnp.asarray(3, jnp.int32),
                          "seed": jnp.asarray(0, jnp.int32)}}
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
        lr = jax_warmup(state["step"], total=TP_SCHED["total_steps"], warmup=TP_SCHED["warmup"],
                        peak_lr=TP_SCHED["peak_lr"])
        new_p, new_o, om = jax_adamw(grads, opt, params, lr, JAdamW())
        inputs[case] = {"state": jax.tree_util.tree_map(np.array, state), "batch": batch}
        want[case] = {"loss": float(loss), "lr": float(lr), "grad_norm": float(om["grad_norm"]),
                      "new": {k: np.asarray(v) for k, v in
                              jax_flatten({"params": new_p, "opt": new_o})[0].items()}}
    path = tmp_path / "inputs.pkl"
    path.write_bytes(pickle.dumps(inputs))
    return path, want


def sharded_steps(rank: int, inputs: str, meshes: dict, config) -> dict:
    """Each case of each mesh shape (``meshes``: shape -> cases) stepped
    once from the reference's state, without and with ``seq_shard``,
    with ``DTensor.full_tensor`` raising during the step: ``{(shape, case,
    seq_shard): the new state whole, the metrics}``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.steps import make_train_step, train_state_from_numpy
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import flatten_with_paths

    def refuse(self, *args, **kwargs):
        raise AssertionError("a weight gathered whole: DTensor.full_tensor")

    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for shape, names in meshes.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        for case in names:
            cfg = config(get_smoke_config, case)
            batch = {k: torch.from_numpy(v) if v.dtype == np.float32 else
                     torch.from_numpy(v).long() for k, v in cases[case]["batch"].items()}
            for seq_shard in (False, True):
                st = train_state_from_numpy(cases[case]["state"], cfg, AdamWConfig(), mesh=mesh)
                step_fn = make_train_step(cfg, AdamWConfig(), mesh=mesh, seq_shard=seq_shard,
                                          **TP_SCHED)
                full_tensor, DTensor.full_tensor = DTensor.full_tensor, refuse
                try:
                    st, m = step_fn(st, batch)
                finally:
                    DTensor.full_tensor = full_tensor
                new = {k: v.full_tensor().numpy() for k, v in flatten_with_paths(
                    {"params": st["params"], "opt": st["opt"]})[0].items()}
                out[shape, case, seq_shard] = {
                    "new": new, "loss": float(m["loss"]), "lr": float(m["lr"]),
                    "grad_norm": float(m["grad_norm"]), "step": int(st["step"].to_local()),
                    "path": m["path"]}
    return out


def test_sharding_context_redistributes_a_dtensor_activation(crossed):
    """``constrain(x, "resid")`` inside ``sharding_context`` gives the
    residual stream, sharded over data only, the installed placements
    (data on dim 0, model on dim 2): each rank holds its block of the same
    tensor. A plain tensor, a kind with nothing installed, and a call
    outside the context return their input itself."""
    for r in crossed["ranks"]:
        c = r["ctx"]
        assert c["placements"] and c["spec"] == ("data", None, "model")
        assert c["local"] and c["full"] and c["same"] == [True, True, True]


# ---------------------------------------------------------------------------
# tensor-parallel compute on the model axis (the dense and vlm families)
# ---------------------------------------------------------------------------

# (arch, replacements): smoke configs, float32, with these replacements in
# both packages: yi's 6 heads and 2 kv heads on a 4-way model axis stay
# whole, as its 56 on 16; a vocab of 254 stays whole on it too
TP_CASES = {"qwen3-1.7b": ("qwen3-1.7b", {}), "internvl2-76b": ("internvl2-76b", {}),
            "yi-34b": ("yi-34b", {"n_heads": 6, "n_kv_heads": 2}),
            "qwen3-1.7b-vocab254": ("qwen3-1.7b", {"vocab": 254})}
TP_MESHES = {(2, 2): ("qwen3-1.7b", "internvl2-76b"), (1, 4): tuple(TP_CASES)}
TP_SCHED = {"peak_lr": 3e-3, "warmup": 5, "total_steps": 10}
# every dense and vlm smoke arch, each step run with DTensor.full_tensor raising
TP_ARCHS = ("qwen3-1.7b", "stablelm-12b", "yi-34b", "command-r-plus-104b", "internvl2-76b")


def _tp_config(smoke_config, case: str):
    import dataclasses

    arch, replacements = TP_CASES[case]
    return dataclasses.replace(smoke_config(arch).with_(dtype="float32"), **replacements)


def _tp_batch(cfg) -> dict:
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["labels"][0, :5] = -1  # unequal valid labels across the data shards
    if cfg.vision_prefix:
        batch["vis_embeds"] = rng.standard_normal(
            (4, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return batch


def _tp_rank(rank: int, inputs: str) -> dict:
    return sharded_steps(rank, inputs, TP_MESHES, _tp_config)


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    """The reference's unsharded step for each of :data:`TP_CASES`, and the
    ranks' steps on each of :data:`TP_MESHES`, without and with
    ``seq_shard``."""
    path, want = reference_steps({case: None for case in TP_CASES}, _tp_config, _tp_batch,
                                 tmp_path_factory.mktemp("tp"))
    return want, run_ranks(_tp_rank, 4, args=(str(path),), timeout_s=GROUP_TIMEOUT_S, threads=1)


@pytest.mark.parametrize("seq_shard", [False, True], ids=["", "seq_shard"])
@pytest.mark.parametrize("shape,arch", [(s, a) for s, archs in TP_MESHES.items() for a in archs],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_tensor_parallel_train_step_equals_reference(tp_steps, shape, arch, seq_shard):
    """The ``tp`` path's step against the reference's unsharded one, at
    ``test_sharded_train_step_equals_reference``'s tolerances. The cases
    cover each branch of the layers: on 2×2 the q and kv heads, the MLP
    and the vocab split 2 ways; on 1×4 qwen3's and internvl2's one q head
    a rank (G = 2) read a view of the whole kv projection, yi's 6 heads
    stay whole (its attention on every rank; under ``seq_shard`` on the
    gathered sequence, each rank keeping its positions), and a vocab of
    254 stays whole (every rank embeds and unembeds it all; under
    ``seq_shard`` each rank's loss covers its positions and the sums are
    added). ``seq_shard`` splits the residual stream along S between
    layers (internvl2's 8 prefix positions and 12 tokens included)."""
    want, ranks = tp_steps
    got = [r[shape, arch, seq_shard] for r in ranks]
    assert {g["path"] for g in got} == {"tp"}
    _assert_step_equals_reference(want[arch], got)


def _no_gather_rank(rank: int, archs: tuple = TP_ARCHS, moe_buf: bool = False) -> dict:
    """Each of ``archs``' train (with and without ``seq_shard``, and with
    ``moe_buf_shard`` too where ``moe_buf``), prefill and decode steps on
    2×2 with ``DTensor.full_tensor`` raising; the paths they record."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.steps import (make_decode_step, make_init_fn,
                                               make_prefill_step, make_train_step)
    from repro_torch.optim import AdamWConfig

    def refuse(self, *args, **kwargs):
        raise AssertionError("a weight gathered whole: DTensor.full_tensor")

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    flags = [(ss, mb) for mb in ((False, True) if moe_buf else (False,)) for ss in (False, True)]
    for arch in archs:
        cfg = get_smoke_config(arch).with_(dtype="float32")
        batch = {k: torch.from_numpy(v).long() for k, v in _tp_batch(cfg).items()
                 if k != "vis_embeds"}
        if cfg.vision_prefix:
            batch["vis_embeds"] = torch.zeros(4, cfg.vision_prefix, cfg.d_model)
        s_max = 16 + cfg.vision_prefix
        st = make_init_fn(cfg, AdamWConfig(), seed=1, mesh=mesh)()
        trains = [make_train_step(cfg, AdamWConfig(), mesh=mesh, seq_shard=ss,
                                  moe_buf_shard=mb) for ss, mb in flags]
        pstep, _, _ = make_prefill_step(cfg, mesh, InputShape("p", 16, 4, "prefill"))
        dstep, _, _ = make_decode_step(cfg, mesh, InputShape("d", s_max, 4, "decode"))
        full_tensor, DTensor.full_tensor = DTensor.full_tensor, refuse
        try:
            paths = [fn(st, batch)[1]["path"] for fn in trains]
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            logits, caches = pstep(st["params"], prompt)
            logits2, _ = dstep(st["params"], caches, batch["tokens"][:, :1],
                               12 + cfg.vision_prefix)
        finally:
            DTensor.full_tensor = full_tensor
        out[arch] = {"paths": paths + [pstep.path, dstep.path],
                     "finite": bool(torch.isfinite(logits.full_tensor()).all()
                                    and torch.isfinite(logits2.full_tensor()).all())}
    return out


def test_dense_and_vlm_steps_gather_no_weight():
    """With ``DTensor.full_tensor`` patched to raise, every dense and vlm
    smoke arch's train (with and without ``seq_shard``), prefill and
    decode steps run on 2×2 and record the ``tp`` path; their logits are
    finite."""
    for r in run_ranks(_no_gather_rank, 4, timeout_s=GROUP_TIMEOUT_S, threads=1):
        for arch in TP_ARCHS:
            assert r[arch] == {"paths": ["tp"] * 4, "finite": True}, (arch, r[arch])


# ---------------------------------------------------------------------------
# the MoE family on its shards (granite: GQA + MoE; deepseek-v3: MLA + MoE)
# ---------------------------------------------------------------------------

# (arch, replacements): granite with 6 experts puts them over the model axis
# alone on 2x2 (6 do not split 4 ways); 8 lie over (data, model)
MOE_CASES = {"granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
             "deepseek-v3-671b": ("deepseek-v3-671b", {}),
             "granite-moe-1b-a400m-x6": ("granite-moe-1b-a400m", {"n_experts": 6})}
MOE_MESHES = {(2, 2): tuple(MOE_CASES), (1, 4): ("granite-moe-1b-a400m", "deepseek-v3-671b")}
# (seq_shard, moe_buf_shard)
MOE_VARIANTS = {"plain": (False, False), "moe_buf_shard": (False, True),
                "seq_shard": (True, False), "seq_shard+moe_buf_shard": (True, True)}
MOE_EXPERTS = {"granite-moe-1b-a400m": ["data", "model"], "deepseek-v3-671b": ["data", "model"],
               "granite-moe-1b-a400m-x6": ["model"]}


def _moe_config(smoke_config, case: str):
    import dataclasses

    arch, replacements = MOE_CASES[case]
    return dataclasses.replace(smoke_config(arch).with_(dtype="float32"), **replacements)


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The reference's unsharded step for each case and data degree (its
    routing groups: one a data row, as the sharded step's), and the inputs
    pickled for the ranks."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import Model as JModel
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.optim.adamw import adamw_update as jax_adamw
    from repro.optim.adamw import init_opt_state as jax_init_opt
    from repro.optim.schedules import warmup_cosine as jax_warmup
    from repro.utils import flatten_with_paths as jax_flatten

    cases, want = {}, {}
    for case in MOE_CASES:
        jcfg = _moe_config(jax_smoke_config, case)
        jm = JModel(jcfg)
        params, _ = jm.init(jax.random.PRNGKey(1))
        opt = jax_init_opt(params, JAdamW())
        batch = _tp_batch(jcfg)
        state = {"params": params, "opt": opt, "step": jnp.asarray(3, jnp.int32),
                 "rng": jnp.asarray([0, 1], jnp.uint32),
                 "data": {"data_step": jnp.asarray(3, jnp.int32),
                          "seed": jnp.asarray(0, jnp.int32)}}
        cases[case] = {"state": jax.tree_util.tree_map(np.array, state), "batch": batch}
        for groups in sorted({shape[0] for shape, names in MOE_MESHES.items() if case in names}):
            loss, grads = jax.value_and_grad(lambda p: jm.loss(
                p, {k: jnp.asarray(v) for k, v in batch.items()}, n_groups=groups))(params)
            lr = jax_warmup(state["step"], total=TP_SCHED["total_steps"],
                            warmup=TP_SCHED["warmup"], peak_lr=TP_SCHED["peak_lr"])
            new_p, new_o, om = jax_adamw(grads, opt, params, lr, JAdamW())
            want[case, groups] = {
                "loss": float(loss), "lr": float(lr), "grad_norm": float(om["grad_norm"]),
                "new": {k: np.asarray(v) for k, v in
                        jax_flatten({"params": new_p, "opt": new_o})[0].items()}}
    path = tmp_path_factory.mktemp("moe") / "moe_inputs.pkl"
    path.write_bytes(pickle.dumps(cases))
    return path, want


def _moe_rank(rank: int, inputs: str, mesh_shape: tuple) -> dict:
    """One step a case of this mesh and a variant, from the reference's
    state."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.steps import make_train_step, train_state_from_numpy
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import flatten_with_paths

    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for case in MOE_MESHES[mesh_shape]:
        cfg = _moe_config(get_smoke_config, case)
        batch = {k: torch.from_numpy(v).long() for k, v in cases[case]["batch"].items()}
        for variant, (seq_shard, moe_buf_shard) in MOE_VARIANTS.items():
            st = train_state_from_numpy(cases[case]["state"], cfg, AdamWConfig(), mesh=mesh)
            step_fn = make_train_step(cfg, AdamWConfig(), mesh=mesh, seq_shard=seq_shard,
                                      moe_buf_shard=moe_buf_shard, **TP_SCHED)
            st, m = step_fn(st, batch)
            new = {k: v.full_tensor().numpy() for k, v in flatten_with_paths(
                {"params": st["params"], "opt": st["opt"]})[0].items()}
            out[case, variant] = {"new": new, "loss": float(m["loss"]), "lr": float(m["lr"]),
                                  "grad_norm": float(m["grad_norm"]),
                                  "step": int(st["step"].to_local()),
                                  "meta": (m["path"], m["moe_buf_shard"], m["experts"])}
    return out


@pytest.fixture(scope="module")
def moe_steps(moe_reference):
    return {shape: run_ranks(_moe_rank, 4, args=(str(moe_reference[0]), shape),
                             timeout_s=GROUP_TIMEOUT_S, threads=1)
            for shape in MOE_MESHES}


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
@pytest.mark.parametrize("shape,case", [(s, c) for s, cases in MOE_MESHES.items() for c in cases],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_moe_train_step_on_its_shards_equals_reference(moe_reference, moe_steps, shape, case,
                                                        variant):
    """The ``tp`` path's MoE step against the reference's unsharded one
    (routing groups one a data row), at ``test_sharded_train_step_equals_reference``'s
    tolerances, every rank. On 2×2 granite's and deepseek's 8 experts lie
    over (data, model), 2 a rank: without ``moe_buf_shard`` each model
    column's expert weights are all-gathered over data, with it the slots
    move by all-to-all; granite with 6 experts puts them over the model
    axis alone (3 a rank, no token moves). On 1×4 (one data row) the
    experts split 4 ways over the model axis. ``seq_shard`` routes each
    data row's gathered sequence. deepseek's MLA heads split 2 and 4
    ways; its router bias has no gradient in either package. Each step
    records the path, the flag and the experts' axes."""
    got = [r[case, variant] for r in moe_steps[shape]]
    assert all(g["meta"] == ("tp", MOE_VARIANTS[variant][1], MOE_EXPERTS[case]) for g in got)
    _assert_step_equals_reference(moe_reference[1][case, shape[0]], got)


def _moe_layer_rank(rank: int, inputs: str) -> dict:
    """A MoE layer alone on 2×2 (each layout, without and with the
    buffer placed): this rank's rows of its output."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.distributed.steps import DEFAULT_RULES, model_axes_for, tree_shardings
    from repro_torch.models import moe, params_from_numpy
    from repro_torch.utils import flatten_with_paths

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for case, c in cases.items():
        cfg = _moe_config(get_smoke_config, case).with_(capacity_factor=0.5)
        axes, specs = model_axes_for(cfg)
        p_sh = tree_shardings(axes, specs, mesh, DEFAULT_RULES)
        params = place_tree(params_from_numpy(c["params"], cfg, "cpu"), p_sh)
        g = "g1" if cfg.first_dense_layers else "g0"
        local = {k: v.to_local()[0] for k, v in
                 flatten_with_paths(params["blocks"][g]["ffn"])[0].items()}
        x = torch.from_numpy(c["x"])
        rows = x[rank // 2 * 2:(rank // 2 + 1) * 2]  # this data row's two sequences
        for flag in (False, True):
            plan = tp.plan_for(cfg, p_sh, mesh, moe_buf_shard=flag)
            with torch.no_grad():
                out[case, flag] = moe.moe_ffn(local, rows, cfg, n_groups=1, plan=plan).numpy()
    return out


def test_moe_layer_on_its_shards_equals_reference(tmp_path):
    """A MoE layer alone (float32, capacity factor 0.5, so at least half of
    each group's assignments are dropped: a kept set that differed from the
    reference's would move the output by whole values) on 2×2, each data
    row routing its two sequences as one group: every rank's output within
    1e-5 of the max of the reference's ``moe_ffn`` on those rows with the
    same weights, for experts over (data, model) (granite, deepseek with its
    sigmoid router and shared expert) and over the model axis alone
    (granite with 6), with the buffer placed as the experts are (tokens
    moved by all-to-all) and without (weights gathered in a column)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import Model as JModel
    from repro.models import moe as jmoe

    cases, want = {}, {}
    rng = np.random.default_rng(7)
    for case in MOE_CASES:
        jcfg = _moe_config(jax_smoke_config, case).with_(capacity_factor=0.5)
        params, _ = JModel(jcfg).init(jax.random.PRNGKey(4))
        x = rng.standard_normal((4, 12, jcfg.d_model)).astype(np.float32)
        g = "g1" if jcfg.first_dense_layers else "g0"
        ffn = jax.tree_util.tree_map(lambda t: t[0], params["blocks"][g]["ffn"])
        want[case] = np.asarray(jmoe.moe_ffn(ffn, jnp.asarray(x), jcfg, n_groups=2))
        cases[case] = {"params": jax.tree_util.tree_map(np.asarray, params), "x": x}
    inputs = tmp_path / "layer.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    for rank, r in enumerate(run_ranks(_moe_layer_rank, 4, args=(str(inputs),),
                                       timeout_s=GROUP_TIMEOUT_S, threads=1)):
        for (case, flag), got in r.items():
            ref = want[case][rank // 2 * 2:(rank // 2 + 1) * 2]
            err = float(np.abs(got - ref).max())
            assert err <= 1e-5 * float(np.abs(ref).max()), (case, flag, rank, err)


def test_moe_steps_gather_no_weight():
    """With ``DTensor.full_tensor`` patched to raise, granite's and
    deepseek's train steps (without and with ``seq_shard`` and
    ``moe_buf_shard``), prefill and decode run on 2×2 and record the
    ``tp`` path; their logits are finite."""
    archs = ("granite-moe-1b-a400m", "deepseek-v3-671b")
    for r in run_ranks(_no_gather_rank, 4, args=(archs, True), timeout_s=GROUP_TIMEOUT_S,
                       threads=1):
        for arch in archs:
            assert r[arch] == {"paths": ["tp"] * 6, "finite": True}, (arch, r[arch])


def _flags_rank(rank: int) -> dict:
    """hymba's, xlstm's and whisper's smoke train steps on 1×2 from one
    init, without a flag, with ``seq_shard`` and with ``moe_buf_shard``:
    the loss, the grad norm and the new params."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.steps import make_init_fn, make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import flatten_with_paths

    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(2)
    out = {}
    for arch in ("hymba-1.5b", "xlstm-1.3b", "whisper-tiny"):
        cfg = get_smoke_config(arch).with_(dtype="float32")
        batch = {k: torch.from_numpy(v).long() for k, v in _tp_batch(cfg).items()}
        if cfg.encdec:
            batch["enc_frames"] = torch.from_numpy(
                rng.standard_normal((4, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        for flag in ("", "seq_shard", "moe_buf_shard"):
            st = make_init_fn(cfg, AdamWConfig(), seed=1, mesh=mesh)()
            step = make_train_step(cfg, AdamWConfig(), mesh=mesh, **({flag: True} if flag else {}))
            st, m = step(st, batch)
            out[arch, flag] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                               "path": m["path"], "moe_buf_shard": m["moe_buf_shard"],
                               "params": {k: v.full_tensor().numpy().tobytes() for k, v in
                                          flatten_with_paths(st["params"])[0].items()}}
    return out


@pytest.fixture(scope="module")
def flag_steps():
    return run_ranks(_flags_rank, 2, timeout_s=GROUP_TIMEOUT_S, threads=1)


@pytest.mark.parametrize("flag", ["seq_shard", "moe_buf_shard"])
@pytest.mark.parametrize("arch,item", [("hymba-1.5b", "4f"), ("xlstm-1.3b", "4f"),
                                       ("whisper-tiny", "4g")])
def test_families_still_gathered_refuse_the_flags(flag_steps, arch, item, flag):
    """(Named when these families' steps gathered their weights and
    refused both flags, until ROADMAP items 4f and 4g.) hymba's, xlstm's
    and whisper's sharded steps now compute on their shards and take
    ``seq_shard`` and ``moe_buf_shard`` wherever the reference takes them,
    on a 1×2 mesh from one init: ``moe_buf_shard`` (no MoE layer in any of
    them) and whisper's ``seq_shard`` (the reference's encoder–decoder
    constrains no residual stream) are bitwise the step without the flag;
    hymba's and xlstm's ``seq_shard`` splits the residual stream and
    computes the same step within 1e-6 (the reference's own criteria are
    in ``test_torch_mesh_hybrid.py``). Every step records the ``tp`` path
    and the flag."""
    for r in flag_steps:
        plain, got = r[arch, ""], r[arch, flag]
        assert plain["path"] == got["path"] == "tp"
        assert got["moe_buf_shard"] == (flag == "moe_buf_shard")
        if flag == "moe_buf_shard" or arch == "whisper-tiny":
            assert (got["loss"], got["grad_norm"]) == (plain["loss"], plain["grad_norm"])
            assert got["params"] == plain["params"]
        else:
            assert got["loss"] == pytest.approx(plain["loss"], rel=1e-6)
            assert got["grad_norm"] == pytest.approx(plain["grad_norm"], rel=1e-6)


# ---------------------------------------------------------------------------
# the launcher: --mesh and --remesh
# ---------------------------------------------------------------------------

ARCH = "qwen3-1.7b"


def _run(tmp_path, name, *extra):
    store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                       "--publish-every", "2", "--seq-len", "16", "--batch", "4",
                       "--log-every", "0", "--store", str(store), "--metrics", str(metrics),
                       *extra])
    js = JobStore(store)
    (job_id, _), = js.svc_list_jobs()
    return js, job_id, [json.loads(ln) for ln in metrics.read_text().splitlines()]


def _steps(rec):
    return [(r["step"], r["loss"]) for r in rec if r["event"] == "step"]


def _digests(js, job_id, cmi=None):
    man = load_manifest(js.cmi_root(job_id), cmi or js.read_job(job_id).cmi)
    return man, {p: [c.hash for c in e.chunks] for p, e in man.arrays.items()}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("a22")
    return _run(tmp, "a", "--mesh", "2x2")


def test_remesh_onto_a_smaller_mesh_resumes_the_published_state(tmp_path, uninterrupted):
    """Reclaimed at step 2 on 2×2, resumed on 1×2 (the spot market's
    smaller instance, the data axis shrunk): the state the second
    incarnation restored (remapped onto 1×2, re-pinned) is bitwise the CMI
    published at the reclaim; every later loss is within 1e-5 of the
    uninterrupted 2×2 run's (each model rank computes its shards as before;
    only the data-parallel sums change), the final loss finite; the CMIs
    record each incarnation's mesh."""
    js, job_id, rec = _run(tmp_path, "c", "--remesh", "2x2,1x2", "--preempt-at", "2")
    starts = [r for r in rec if r["event"] == "start"]
    assert [(s["mesh"], s["resumed"], s["step"]) for s in starts] == \
        [("2x2", False, 0), ("1x2", True, 2)]
    published = next(r["cmi"] for r in rec if r["event"] == "publish" and r["step"] == 2)
    state, _ = restore_cmi(js.cmi_root(job_id), published, device="cpu")
    assert starts[1]["restored_digest"] == launch_train.state_digest(state)
    man, _ = _digests(js, job_id, published)
    assert man.arrays["opt/mu/embed"].sharding.mesh_shape == [2, 2]
    final, _ = _digests(js, job_id)
    assert final.arrays["opt/mu/embed"].sharding.mesh_shape == [1, 2]
    _, _, rec_a = uninterrupted
    got, want = _steps(rec), _steps(rec_a)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, rel=1e-5)
    assert np.isfinite(got[-1][1])
    assert rec[-1]["incarnations"] == 2 and rec[-1]["mesh"] == ["2x2", "1x2"]


def test_remesh_onto_a_smaller_model_axis_resumes_the_published_state(tmp_path,
                                                                       uninterrupted):
    """Reclaimed at step 2 on 2×2, resumed on 2×1 (the model axis shrunk to
    1, so the resumed run computes the whole model on each rank): the
    restored state is bitwise the CMI published at the reclaim, remapped
    onto 2×1; the steps before the reclaim are the uninterrupted 2×2
    run's bit for bit; every later loss is within rel 2e-4 of the
    uninterrupted run's. In bf16 a 2-way model axis adds its partial sums
    with roundings of its own, as the reference's GSPMD program on
    another mesh does, so the whole model on each rank differs from it:
    by at most 8.3e-5 over seeds 0-4 (6.8e-5 at seed 0, this test's)."""
    js, job_id, rec = _run(tmp_path, "d", "--remesh", "2x2,2x1", "--preempt-at", "2")
    starts = [r for r in rec if r["event"] == "start"]
    assert [(s["mesh"], s["resumed"], s["step"]) for s in starts] == \
        [("2x2", False, 0), ("2x1", True, 2)]
    published = next(r["cmi"] for r in rec if r["event"] == "publish" and r["step"] == 2)
    state, _ = restore_cmi(js.cmi_root(job_id), published, device="cpu")
    assert starts[1]["restored_digest"] == launch_train.state_digest(state)
    final, _ = _digests(js, job_id)
    assert final.arrays["opt/mu/embed"].sharding.mesh_shape == [2, 1]
    got, want = _steps(rec), _steps(uninterrupted[2])
    assert got[:2] == want[:2] and [s for s, _ in got] == [1, 2, 3, 4]
    for (_, g), (_, w) in zip(got[2:], want[2:]):
        assert g == pytest.approx(w, rel=2e-4)
    assert np.isfinite(got[-1][1])
    assert rec[-1]["incarnations"] == 2 and rec[-1]["mesh"] == ["2x2", "2x1"]


def test_remesh_onto_the_same_mesh_is_bitwise_uninterrupted(tmp_path, uninterrupted):
    """``--remesh 2x2,2x2`` reclaimed at step 2: every step loss and every
    chunk digest of the final CMI equal the uninterrupted 2×2 run's."""
    js, job_id, rec = _run(tmp_path, "b", "--remesh", "2x2,2x2", "--preempt-at", "2")
    js_a, job_a, rec_a = uninterrupted
    assert _steps(rec) == _steps(rec_a)
    assert _digests(js, job_id)[1] == _digests(js_a, job_a)[1]
    assert [r["resumed"] for r in rec if r["event"] == "start"] == [False, True]


def test_one_rank_mesh_equals_no_mesh(tmp_path):
    """A 1×1 mesh (a gloo group of one, in this process): every step loss
    and every chunk digest of the final CMI equal the run without a mesh;
    the CMI records ``mesh_shape [1, 1]`` and the rules' specs."""
    js0, job0, rec0 = _run(tmp_path, "nomesh")
    js1, job1, rec1 = _run(tmp_path, "mesh11", "--mesh", "1x1")
    assert _steps(rec0) == _steps(rec1) and len(_steps(rec0)) == 4
    man0, d0 = _digests(js0, job0)
    man1, d1 = _digests(js1, job1)
    assert d0 == d1
    assert man0.arrays["params/embed"].sharding is None
    rec = man1.arrays["params/embed"].sharding
    assert (rec.mesh_shape, rec.mesh_axes, rec.pspec) == ([1, 1], ["data", "model"], [None, None])
    assert man1.arrays["step"].sharding.pspec == []
    with pytest.raises(RuntimeError, match="cards"):
        check_devices("cuda", torch.cuda.device_count() + 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _run(tmp_path, "cuda", "--mesh", "2x1", "--device", "cuda")
