"""The hybrid (hymba: attention ‖ SSD) and mLSTM (xLSTM) families on their
shards: the sharded train step (``distributed/tp.py``'s ``tp`` path) on
gloo process groups of CPU ranks, against the JAX package's unsharded
step.

* hymba's and xlstm's float32 smoke train steps on 2×2 and 1×4, with and
  without ``seq_shard``, within 1e-5 of each max of the reference's
  unsharded step (``test_torch_mesh._assert_step_equals_reference``: the
  loss, the grad norm, the moments and, where the gradient is firm, the
  params; 2·lr elsewhere), the second moment held by its root
  (``test_torch_mesh.assert_step_equals_reference``). Each step runs with ``DTensor.full_tensor``
  raising, so no weight is gathered whole. The cases cover each branch:
  on 2×2 hymba's 4 q heads, its 4 SSD heads and its MLP split 2 ways (its
  2 kv heads too), xlstm's 2 mLSTM heads split 2 ways; on 1×4 hymba's one
  q head and one SSD head a rank, reading one of its 2 kv heads (G = 2),
  xlstm with 4 heads (both packages' smoke config given 4, as yi's 6 are
  in ``test_torch_mesh.py``) one a rank; and, as hymba's 25 heads and
  xlstm's 4 on 16, heads that stay whole on 1×4 (hymba with 6 heads and
  2 kv heads, xlstm's own 2), the mixer on every model rank (on the
  gathered sequence under ``seq_shard``, each rank keeping its
  positions).
* The mLSTM layer alone on split heads: its ``ln_out`` is one RMSNorm over
  every head's features, so each rank's sum of squares is added over the
  model axis (``Plan.psum``) and each rank's gradient of that sum is
  added too; the output and every gradient (each weight's, the input's)
  within 1e-5 of each max of the reference's.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.group import run_ranks
from test_torch_mesh import (GROUP_TIMEOUT_S, _tp_batch, assert_step_equals_reference,
                             reference_steps, sharded_steps)

# (arch, replacements): smoke configs, float32, with these replacements in both packages
CASES = {"hymba-1.5b": ("hymba-1.5b", {}),
         "hymba-1.5b-h6": ("hymba-1.5b", {"n_heads": 6, "n_kv_heads": 2}),
         "xlstm-1.3b": ("xlstm-1.3b", {}),
         "xlstm-1.3b-h4": ("xlstm-1.3b", {"n_heads": 4, "n_kv_heads": 4})}
MESHES = {(2, 2): ("hymba-1.5b", "xlstm-1.3b"), (1, 4): tuple(CASES)}
TOL = 1e-5


def _config(smoke_config, case: str):
    arch, replacements = CASES[case]
    return dataclasses.replace(smoke_config(arch).with_(dtype="float32"), **replacements)


def _rank(rank: int, inputs: str) -> dict:
    return sharded_steps(rank, inputs, MESHES, _config)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    path, want = reference_steps({case: None for case in CASES}, _config, _tp_batch,
                                 tmp_path_factory.mktemp("hybrid"))
    return want, run_ranks(_rank, 4, args=(str(path),), timeout_s=GROUP_TIMEOUT_S, threads=1)


@pytest.mark.parametrize("seq_shard", [False, True], ids=["", "seq_shard"])
@pytest.mark.parametrize("shape,case", [(s, c) for s, cases in MESHES.items() for c in cases],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_hybrid_and_mlstm_train_steps_on_their_shards_equal_reference(steps, shape, case,
                                                                      seq_shard):
    """The ``tp`` path's step against the reference's unsharded one, every
    rank, with ``DTensor.full_tensor`` raising (see the module's
    docstring for the splits each case covers)."""
    want, ranks = steps
    got = [r[shape, case, seq_shard] for r in ranks]
    assert {g["path"] for g in got} == {"tp"}
    assert_step_equals_reference(want[case], got)


# ---------------------------------------------------------------------------
# the mLSTM layer alone: ln_out over split heads
# ---------------------------------------------------------------------------


def _mlstm_layer_rank(rank: int, inputs: str) -> dict:
    """The mLSTM layer on this rank's head of 4 (1×4), its output and the
    gradients of ``sum(y * r)``: each split leaf's block, the whole
    ``ln_out``'s and the input's."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.distributed.steps import DEFAULT_RULES, model_axes_for, tree_shardings
    from repro_torch.models import params_from_numpy, ssm
    from repro_torch.utils import flatten_with_paths

    with open(inputs, "rb") as f:
        c = pickle.load(f)
    cfg = _config(get_smoke_config, "xlstm-1.3b-h4")
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    axes, specs = model_axes_for(cfg)
    p_sh = tree_shardings(axes, specs, mesh, DEFAULT_RULES)
    params = place_tree(params_from_numpy(c["params"], cfg, "cpu"), p_sh)
    plan = tp.plan_for(cfg, p_sh, mesh)
    assert plan.heads and plan.size == 4
    local = {k: v.to_local()[0].detach().requires_grad_(True) for k, v in
             flatten_with_paths(params["blocks"]["g0"]["mlstm"])[0].items()}
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    y = ssm.mlstm_train(local, x, cfg, plan)
    grads = torch.autograd.grad((y * torch.from_numpy(c["r"])).sum(), [x, *local.values()])
    return {"y": y.detach().numpy(), "x": grads[0].numpy(),
            **{k: g.numpy() for k, g in zip(local, grads[1:])}}


def test_mlstm_layer_on_split_heads_equals_reference(tmp_path):
    """The mLSTM layer on a 1×4 mesh, one of 4 heads a rank (random
    weights, ``ln_out``'s scale drawn too): each rank's output within 1e-5
    of each max of the reference's ``mlstm_train``, and the gradients of
    ``sum(y * r)``: of the input and of ``ln_out`` whole on every rank (the
    sums of squares' gradients added over the ranks: Megatron's identity
    backward would leave each rank only its own heads' share), of each
    head-split weight the rank's block of the reference's."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import Model as JModel
    from repro.models import ssm as jssm

    jcfg = _config(jax_smoke_config, "xlstm-1.3b-h4")
    params, _ = JModel(jcfg).init(jax.random.PRNGKey(4))
    rng = np.random.default_rng(9)
    ln = params["blocks"]["g0"]["mlstm"]["ln_out"]
    params["blocks"]["g0"]["mlstm"]["ln_out"] = jnp.asarray(
        1.0 + 0.5 * rng.standard_normal(ln.shape), ln.dtype)
    p = jax.tree_util.tree_map(lambda t: t[0], params["blocks"]["g0"]["mlstm"])
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)

    def f(p, x):
        y = jssm.mlstm_train(p, x, jcfg)
        return (y * r).sum(), y

    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    want = {"y": np.asarray(y), "x": np.asarray(gx),
            **{k: np.asarray(v) for k, v in gp.items()}}
    inputs = tmp_path / "layer.pkl"
    inputs.write_bytes(pickle.dumps({"params": jax.tree_util.tree_map(np.asarray, params),
                                     "x": x, "r": r}))
    for rank, got in enumerate(run_ranks(_mlstm_layer_rank, 4, args=(str(inputs),),
                                         timeout_s=GROUP_TIMEOUT_S, threads=1)):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if k in ("y", "x", "ln_out"):
                block = w
            elif k == "wo":
                block = w[rank:rank + 1]
            else:  # (e, h, ...) or (h,): this rank's head
                block = w[rank:rank + 1] if w.ndim == 1 else w[:, rank:rank + 1]
            assert got[k].shape == block.shape, (k, got[k].shape, block.shape)
            err = float(np.abs(got[k] - block).max())
            assert err <= TOL * float(np.abs(block).max()), (k, rank, err)
