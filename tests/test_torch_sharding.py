"""The port's sharding rules, spec remap and logical axes against the JAX
package's, with no process group: ``spec_for`` is duck-typed over a mesh's
axis sizes, so abstract meshes stand in for devices in both packages.

The reference's ``tests/test_sharding.py`` cases run against the port;
a hypothesis property holds ``spec_for`` equal to the reference's on 2×2,
4×2 and 2×2×2 meshes for random names and dims under every rule set; the
resolver's three remap cases; ``Model.param_axes()`` and ``opt_axes``
equal the reference's ``model_axes_for`` for every configuration's smoke
form; DTensor placements and shard blocks follow JAX's row-major order.
"""

import jax
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.cmi import mesh_resharding_resolver as jax_resolver  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.distributed.steps import model_axes_for  # noqa: E402
from repro.optim.adamw import opt_axes as jax_opt_axes  # noqa: E402
from repro.utils import flatten_with_paths as jax_flatten  # noqa: E402
from repro.utils import unflatten_from_paths as jax_unflatten  # noqa: E402
from repro_torch.checkpoint.format import ShardingRecord  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.core.cmi import mesh_resharding_resolver  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    CACHE_RULES,
    DEFAULT_RULES,
    OPT_RULES,
    AbstractMesh,
    NamedSharding,
    P,
    data_pspec,
    placements_for,
    spec_for,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import opt_axes  # noqa: E402
from repro_torch.utils import flatten_with_paths, unflatten_from_paths  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
NAMES = ["embed", "heads", "kv_heads", "mlp", "moe_mlp", "experts", "vocab", "head_dim",
         "layers", "batch", "seq", "q_lora", None]


@pytest.fixture(scope="module")
def mesh22():
    return AbstractMesh((2, 2), ("data", "model"))


def test_heads_divisibility_fallback(mesh22):
    s1 = spec_for(("embed", "heads", "head_dim"), (64, 56, 128), mesh22, DEFAULT_RULES)
    assert s1 == P(None, "model", None)
    s2 = spec_for(("embed", "heads", "head_dim"), (64, 7, 128), mesh22, DEFAULT_RULES)
    assert s2 == P(None, None, None)


def test_experts_prefer_full_mesh(mesh22):
    s = spec_for(("experts", "embed", "moe_mlp"), (8, 64, 32), mesh22, DEFAULT_RULES)
    assert s == P(("data", "model"), None, None)
    s2 = spec_for(("experts", "embed", "moe_mlp"), (2, 64, 32), mesh22, DEFAULT_RULES)
    assert s2 == P("model", None, None)


def test_axis_conflict_not_reused(mesh22):
    s = spec_for(("experts", "embed", "moe_mlp"), (8, 64, 32), mesh22, OPT_RULES)
    assert s == P(("data", "model"), None, None)


def test_zero_style_opt_sharding(mesh22):
    assert spec_for(("embed", "mlp"), (64, 128), mesh22, DEFAULT_RULES) == P(None, "model")
    assert spec_for(("embed", "mlp"), (64, 128), mesh22, OPT_RULES) == P("data", "model")


def test_cache_rules_seq_sharded(mesh22):
    s = spec_for(("layers", "batch", "seq", "kv_heads", "head_dim"), (4, 8, 64, 8, 128),
                 mesh22, CACHE_RULES)
    assert s == P(None, "data", "model", None, None)


def test_data_pspec_batch1_fallback(mesh22):
    assert data_pspec(mesh22, 2, 8) == P("data", None)
    assert data_pspec(mesh22, 2, 1) == P(None, None)
    m3 = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert data_pspec(m3, 2, 8) == P(("pod", "data"), None)
    assert data_pspec(m3, 3, 2) == P("data", None, None)  # pod dropped first


def test_rule_tables_equal_reference():
    assert DEFAULT_RULES == jsh.DEFAULT_RULES
    assert OPT_RULES == jsh.OPT_RULES
    assert CACHE_RULES == jsh.CACHE_RULES


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@settings(max_examples=40, deadline=None)
@given(
    dims=st.lists(st.integers(1, 64), min_size=1, max_size=5),
    names=st.lists(st.sampled_from(NAMES), min_size=1, max_size=5),
    rules=st.sampled_from(["DEFAULT_RULES", "OPT_RULES", "CACHE_RULES"]),
)
def test_spec_for_equals_reference(mesh_name, dims, names, rules):
    """Property: the port's spec equals the reference's, entry for entry,
    on the same abstract mesh; every sharded dim divides and no axis is
    used twice."""
    sizes, axes = MESHES[mesh_name]
    names = tuple(names[: len(dims)])
    dims = tuple(dims[: len(names)] if len(dims) > len(names) else dims)
    got = spec_for(names, dims, AbstractMesh(sizes, axes), globals()[rules])
    want = jsh.spec_for(names, dims, jax.sharding.AbstractMesh(sizes, axes),
                        getattr(jsh, rules))
    assert tuple(got) == tuple(want)
    size = dict(zip(axes, sizes))
    used = []
    for dim, entry in zip(dims, got):
        if entry is None:
            continue
        ax = entry if isinstance(entry, tuple) else (entry,)
        assert dim % int(np.prod([size[a] for a in ax])) == 0
        used.extend(ax)
    assert len(used) == len(set(used))


def test_mesh_remap_resolver(mesh22):
    """A spec saved on a 4x4 mesh remaps onto 2x2 (elastic restore); an
    axis the new mesh lacks is dropped; a dim that no longer divides is
    replicated — the reference's three cases, each equal to its answer."""
    r = mesh_resharding_resolver(mesh22)
    jr = jax_resolver(jax.sharding.AbstractMesh((2, 2), ("data", "model")))
    cases = [
        (ShardingRecord([4, 4], ["data", "model"], ["model", None]), (64, 32), P("model", None)),
        (ShardingRecord([2, 2, 2], ["pod", "data", "model"], [["pod", "data"], None]),
         (64, 32), P("data", None)),
        (ShardingRecord([4], ["model"], ["model"]), (7,), P(None)),
    ]
    for rec, shape, want in cases:
        sh = r("w", shape, "float32", rec)
        assert isinstance(sh, NamedSharding) and sh.mesh is mesh22 and sh.spec == want
        from repro.checkpoint.format import ShardingRecord as JRec

        jsh_ = jr("w", shape, np.float32, JRec(rec.mesh_shape, rec.mesh_axes, rec.pspec))
        assert tuple(sh.spec) == tuple(jsh_.spec)
    assert r("w", (4,), "float32", None).spec == P()
    assert mesh_resharding_resolver(mesh22, default_replicated=False)("w", (4,), "f", None) is None
    assert mesh_resharding_resolver(None)("w", (4,), "float32", cases[0][0]) is None
    over = NamedSharding(mesh22, P("data"))
    assert mesh_resharding_resolver(mesh22, {"w": over})("w", (4,), "float32", None) is over


def _axes_flat(tree, flatten):
    return flatten(tree, is_leaf=lambda x: x is None or isinstance(x, tuple))[0]


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_axes_equal_reference(arch):
    """``Model.param_axes()`` is the reference's ``model_axes_for`` tree leaf
    for leaf (every parameter of every configuration's smoke form, built on
    the meta device), and ``opt_axes`` of it the reference's."""
    want, struct = model_axes_for(jax_smoke_config(arch))
    got = Model(get_smoke_config(arch)).param_axes()
    assert got == want
    assert _axes_flat(opt_axes(got), flatten_with_paths) == \
        _axes_flat(jax_opt_axes(want), jax_flatten)
    shapes = {k: s.shape for k, s in flatten_with_paths(Model(get_smoke_config(arch))
                                                        .param_specs())[0].items()}
    assert sorted(_axes_flat(got, flatten_with_paths)) == sorted(shapes)
    for path, axes in _axes_flat(got, flatten_with_paths).items():
        assert len(axes) == len(shapes[path]), path


def test_unflatten_from_paths_and_is_leaf_equal_reference():
    tree = {"b": [("x", None), ("y", "z")], "a": {"c": (), "d": ("e",)}}
    leaf = lambda x: x is None or isinstance(x, tuple)  # noqa: E731
    flat, treedef = flatten_with_paths(tree, is_leaf=leaf)
    jflat, jtreedef = jax_flatten(tree, is_leaf=leaf)
    assert list(flat.items()) == list(jflat.items())
    assert unflatten_from_paths(treedef, flat) == jax_unflatten(jtreedef, jflat)
    with pytest.raises(KeyError, match="missing leaf"):
        unflatten_from_paths(treedef, {k: v for k, v in flat.items() if k != "a/c"})


def test_placements_nest_in_mesh_order():
    """``Shard(d)`` on each mesh dim an entry of dim d names; a two-axis
    entry in mesh order nests as JAX's row-major ``P((a1, a2))``; the
    other order has no placement and raises."""
    from torch.distributed.tensor import Replicate, Shard

    m = AbstractMesh((2, 3), ("data", "model"))
    assert placements_for(P(None, "model"), m) == [Replicate(), Shard(1)]
    assert placements_for(P(("data", "model"), None), m) == [Shard(0), Shard(0)]
    assert placements_for(P("model", "data"), m) == [Shard(1), Shard(0)]
    assert placements_for(P(), m) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="not in mesh order"):
        placements_for(P(("model", "data")), m)
    with pytest.raises(ValueError, match="not in mesh"):
        placements_for(P("pod"), m)
    sh = NamedSharding(m, P(("data", "model"), "model"))
    with pytest.raises(ValueError, match="shards two dims"):
        sh.placements  # noqa: B018
    # the block at (i, j) of P(("data", "model")) is i * 3 + j, each a sixth
    sh = NamedSharding(m, P(("data", "model"), None))
    blocks = [sh.shard_index((12, 5), c) for c in sh.coords()]
    assert blocks == [((2 * k, 2 * k + 2), (0, 5)) for k in range(6)]
    sh = NamedSharding(m, P("model", "data"))
    assert sh.shard_index((6, 4), (1, 2)) == ((4, 6), (2, 4))
    assert NamedSharding(m, P()).shard_index((3,), (1, 1)) == ((0, 3),)
    assert sh.record() == ShardingRecord([2, 3], ["data", "model"], ["model", "data"])
    assert NamedSharding(m, P(("data", "model"))).record().pspec == [["data", "model"]]
    assert repr(P("a", None)) == "P('a', None)" and tuple(JP("a", None)) == tuple(P("a", None))
