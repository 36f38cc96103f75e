"""The encoder–decoder family (whisper) on its shards: the sharded train
step on gloo process groups of CPU ranks, against the JAX package's
unsharded step.

* whisper's float32 smoke train step on 2×2 (4 heads and 128 MLP units
  split 2 ways) and 1×4 (4 ways), with and without ``seq_shard``, within
  1e-5 of each max of the reference's unsharded step
  (``test_torch_mesh.assert_step_equals_reference``), every rank,
  with ``DTensor.full_tensor`` raising during the step. The reference's
  biases are zeros at init, so a bias added once a rank would not show:
  every bias (the attentions' ``bq``/``bk``/``bv``/``bo``, the MLPs'
  ``b_in``/``b_out``, the layernorms' ``_b``) is drawn at random in both
  packages' state. The reference constrains no residual stream in the
  encoder–decoder, so ``seq_shard`` changes nothing: its step is bitwise
  the step without it.
* The hazards alone on a 1×4 mesh with random weights and biases:
  ``gelu_mlp`` on the rank's hidden units (``b_out`` added once, after the
  partial sums) and the cross attention on the rank's heads (k/v from an
  encoder output every rank holds whole, ``bo`` added once): each rank's
  output and every gradient (each weight's block, the whole biases', the
  inputs') within 1e-5 of each max of the reference's; the key bias's,
  0 up to rounding in both (softmax cancels it), within 1e-6 of the
  largest gradient.
"""

import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.group import run_ranks
from test_torch_mesh import (GROUP_TIMEOUT_S, _tp_batch, assert_step_equals_reference,
                             reference_steps, sharded_steps)

ARCH = "whisper-tiny"
MESHES = {(2, 2): (ARCH,), (1, 4): (ARCH,)}
TOL = 1e-5


def _config(smoke_config, case: str = ARCH):
    return smoke_config(case).with_(dtype="float32")


def _batch(cfg) -> dict:
    batch = _tp_batch(cfg)
    rng = np.random.default_rng(4)
    batch["enc_frames"] = rng.standard_normal((4, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _biases(params, rng):
    """Every bias of the reference's tree drawn at random (normal * 0.1)."""
    import jax
    import jax.numpy as jnp

    def draw(path, t):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("bq", "bk", "bv", "bo", "b_in", "b_out") or name.endswith("_b"):
            return jnp.asarray(0.1 * rng.standard_normal(t.shape), t.dtype)
        return t

    return jax.tree_util.tree_map_with_path(draw, params)


def _rank(rank: int, inputs: str) -> dict:
    return sharded_steps(rank, inputs, MESHES, _config)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    path, want = reference_steps({ARCH: _biases}, _config, _batch,
                                 tmp_path_factory.mktemp("encdec"))
    return want, run_ranks(_rank, 4, args=(str(path),), timeout_s=GROUP_TIMEOUT_S, threads=1)


@pytest.mark.parametrize("seq_shard", [False, True], ids=["", "seq_shard"])
@pytest.mark.parametrize("shape", list(MESHES), ids=lambda v: "x".join(map(str, v)))
def test_encoder_decoder_train_step_on_its_shards_equals_reference(steps, shape, seq_shard):
    """The ``tp`` path's step against the reference's unsharded one, every
    rank, with ``DTensor.full_tensor`` raising; with ``seq_shard``, bitwise
    the step without it (the reference's encoder–decoder constrains no
    stream, so the flag changes nothing)."""
    want, ranks = steps
    got = [r[shape, ARCH, seq_shard] for r in ranks]
    assert {g["path"] for g in got} == {"tp"}
    assert_step_equals_reference(want[ARCH], got)
    if seq_shard:
        for r in ranks:
            plain, flag = r[shape, ARCH, False], r[shape, ARCH, True]
            assert (plain["loss"], plain["grad_norm"]) == (flag["loss"], flag["grad_norm"])
            assert all(plain["new"][k].tobytes() == flag["new"][k].tobytes() for k in plain["new"])


# ---------------------------------------------------------------------------
# the hazards alone: gelu_mlp's b_out and the cross attention's bo, once
# ---------------------------------------------------------------------------


def _layer_rank(rank: int, inputs: str) -> dict:
    """The decoder's layer-0 MLP and cross attention on 1×4, this rank's
    units and heads: their outputs and the gradients of ``sum(y * r)``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tp
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.distributed.steps import DEFAULT_RULES, model_axes_for, tree_shardings
    from repro_torch.models import attention, params_from_numpy
    from repro_torch.models.layers import gelu_mlp
    from repro_torch.utils import flatten_with_paths

    with open(inputs, "rb") as f:
        c = pickle.load(f)
    cfg = _config(get_smoke_config)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    axes, specs = model_axes_for(cfg)
    p_sh = tree_shardings(axes, specs, mesh, DEFAULT_RULES)
    params = place_tree(params_from_numpy(c["params"], cfg, "cpu"), p_sh)
    plan = tp.plan_for(cfg, p_sh, mesh)
    assert plan.heads and plan.kv_heads and plan.mlp

    def local(tree):
        return {k: v.to_local()[0].detach().requires_grad_(True)
                for k, v in flatten_with_paths(tree)[0].items()}

    out = {}
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    enc = torch.from_numpy(c["enc"]).requires_grad_(True)
    r = torch.from_numpy(c["r"])
    m = local(params["dec"]["mlp"])
    y = gelu_mlp(x, m["w_in"], m["b_in"], m["w_out"], m["b_out"], plan)
    grads = torch.autograd.grad((y * r).sum(), [x, *m.values()])
    out["mlp"] = {"y": y.detach().numpy(), "x": grads[0].numpy(),
                  **{k: g.numpy() for k, g in zip(m, grads[1:])}}
    a = local(params["dec"]["cross_attn"])
    y = attention.gqa_train(a, x, cfg, causal=False, use_rope=False, kv_source=enc, plan=plan)
    grads = torch.autograd.grad((y * r).sum(), [x, enc, *a.values()])
    out["cross_attn"] = {"y": y.detach().numpy(), "x": grads[0].numpy(), "enc": grads[1].numpy(),
                         **{k: g.numpy() for k, g in zip(a, grads[2:])}}
    return out


# each leaf's dim that a rank's block of 4 is cut from (None: whole)
_SPLIT = {"w_in": 1, "b_in": 0, "w_out": 0, "b_out": None, "wq": 1, "wk": 1, "wv": 1,
          "bq": 0, "bk": 0, "bv": 0, "wo": 0, "bo": None, "y": None, "x": None, "enc": None}


def test_mlp_and_cross_attention_biases_added_once(tmp_path):
    """On 1×4 (random weights and biases): ``gelu_mlp`` on each rank's 32
    of 128 hidden units and the cross attention on its one head of 4
    (Sq 12, Sk 64), each rank's output within 1e-5 of each max of the
    reference's ``gelu_mlp`` and ``gqa_train(..., kv_source=enc)``, ``b_out``
    and ``bo`` counted once; the gradients of ``sum(y * r)``: each split
    leaf's block, ``b_out``'s and ``bo``'s whole, the input's and the
    encoder output's whole on every rank."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import Model as JModel
    from repro.models import attention as jattn
    from repro.models.layers import gelu_mlp as jgelu_mlp

    jcfg = _config(jax_smoke_config)
    rng = np.random.default_rng(6)
    params, _ = JModel(jcfg).init(jax.random.PRNGKey(5))
    params = _biases(params, rng)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    mlp = jax.tree_util.tree_map(lambda t: t[0], params["dec"]["mlp"])
    cross = jax.tree_util.tree_map(lambda t: t[0], params["dec"]["cross_attn"])

    def f_mlp(p, x):
        y = jgelu_mlp(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
        return (y * r).sum(), y

    def f_cross(p, x, e):
        y = jattn.gqa_train(p, x, jcfg, causal=False, use_rope=False, kv_source=e)
        return (y * r).sum(), y

    want = {}
    (_, y), (gp, gx) = jax.value_and_grad(f_mlp, argnums=(0, 1), has_aux=True)(
        mlp, jnp.asarray(x))
    want["mlp"] = {"y": y, "x": gx, **gp}
    (_, y), (gp, gx, ge) = jax.value_and_grad(f_cross, argnums=(0, 1, 2), has_aux=True)(
        cross, jnp.asarray(x), jnp.asarray(enc))
    want["cross_attn"] = {"y": y, "x": gx, "enc": ge, **gp}
    inputs = tmp_path / "layers.pkl"
    inputs.write_bytes(pickle.dumps({"params": jax.tree_util.tree_map(np.asarray, params),
                                     "x": x, "enc": enc, "r": r}))
    for rank, got in enumerate(run_ranks(_layer_rank, 4, args=(str(inputs),),
                                         timeout_s=GROUP_TIMEOUT_S, threads=1)):
        for layer, leaves in want.items():
            assert sorted(got[layer]) == sorted(leaves), layer
            for k, w in leaves.items():
                w = np.asarray(w)
                d = _SPLIT[k]
                block = w if d is None else np.split(w, 4, axis=d)[rank]
                assert got[layer][k].shape == block.shape, (layer, k)
                if k == "bk":  # softmax cancels q.b: 0 up to rounding in both
                    scale = max(float(np.abs(np.asarray(v)).max()) for v in leaves.values())
                    assert max(np.abs(got[layer][k]).max(), np.abs(block).max()) <= 1e-6 * scale
                    continue
                err = float(np.abs(got[layer][k] - block).max())
                assert err <= TOL * float(np.abs(block).max()), (layer, k, rank, err)
