"""The port's GPipe schedule (``distributed/pipeline.py``) on a 4-stage gloo
mesh (CPU ranks), against a sequential stack and against the JAX
package's ``pipeline_forward`` on 4 host devices (in a subprocess), both
to 1e-5 (float32 sums of the same products in another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed.group import run_ranks
from repro_torch.distributed.pipeline import pipeline_forward, stage_shardings

S, M, MB, D = 4, 6, 2, 16
TIMEOUT_S = 120


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, b, x


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(w, b, x):
    h = torch.from_numpy(x)
    for s in range(S):
        h = stage_fn({"w": torch.from_numpy(w[s]), "b": torch.from_numpy(b[s])}, h)
    return h.numpy()


def _pipelined(rank: int, axis_first: bool):
    """Every rank's output of the 4-stage pipeline; the mesh is (1, 4)
    ``("data", "model")`` with the stages on "model", or (4, 1) with them
    on "data"."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import place_tree

    shape, axis = ((S, 1), "data") if axis_first else ((1, S), "model")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    w, b, x = _inputs()
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    placed = place_tree(params, stage_shardings(params, mesh, axis))
    assert placed["w"].to_local().shape == (1, D, D)
    return pipeline_forward(stage_fn, placed, torch.from_numpy(x), mesh, axis).numpy()


JAX_PIPELINE = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_forward, stage_shardings
S, M, MB, D = 4, 6, 2, 16
rng = np.random.default_rng(0)
w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
b = (rng.standard_normal((S, D)) * 0.1).astype(np.float32)
x = rng.standard_normal((M, MB, D)).astype(np.float32)
mesh = jax.make_mesh((1, S), ("data", "model"))
params = {{"w": jnp.asarray(w), "b": jnp.asarray(b)}}
def stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])
params_sh = jax.tree_util.tree_map(jax.device_put, params, stage_shardings(params, mesh))
got = jax.jit(lambda p, xx: pipeline_forward(stage_fn, p, xx, mesh))(params_sh, jnp.asarray(x))
np.save({out!r}, np.asarray(got))
print("JAX_PIPELINE_OK")
"""


@pytest.fixture(scope="module")
def outputs():
    return {"model": run_ranks(_pipelined, S, args=(False,), timeout_s=TIMEOUT_S, threads=1),
            "data": run_ranks(_pipelined, S, args=(True,), timeout_s=TIMEOUT_S, threads=1)}


@pytest.mark.parametrize("axis", ["model", "data"])
def test_pipeline_matches_sequential(outputs, axis):
    """Every rank returns the last stage's outputs (the reference's psum),
    within 1e-5 of the stages run one after another, the stages on either
    mesh axis."""
    want = _sequential(*_inputs())
    for got in outputs[axis]:
        assert got.shape == (M, MB, D)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert all(np.array_equal(g, outputs[axis][0]) for g in outputs[axis])


def test_pipeline_matches_reference(outputs, tmp_path):
    """The same stages, weights and microbatches through the JAX package's
    ``pipeline_forward`` (``shard_map`` + ``ppermute`` on 4 host devices):
    equal to 1e-5."""
    from conftest import run_python

    out = tmp_path / "jax.npy"
    assert "JAX_PIPELINE_OK" in run_python(JAX_PIPELINE.format(out=str(out)), devices=4,
                                           timeout=TIMEOUT_S)
    want = np.load(out)
    for got in outputs["model"]:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_stage_shardings_and_checks():
    """Each stacked leaf is sharded on its stage dim over the axis; a
    leading dim other than the stage count raises."""
    from repro_torch.distributed.sharding import AbstractMesh, P

    m = AbstractMesh((1, S), ("data", "model"))
    sh = stage_shardings({"w": torch.zeros(S, D, D), "b": torch.zeros(S, D)}, m)
    assert sh["w"].spec == P("model", None, None) and sh["b"].spec == P("model", None)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_forward(stage_fn, {"w": torch.zeros(S + 1, D, D)}, torch.zeros(M, MB, D), m,
                         "model")
