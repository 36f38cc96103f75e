"""The sharded serve steps (``make_prefill_step``/``make_decode_step``) on
gloo process groups (CPU ranks), against the JAX package's unsharded
``Model.prefill``/``Model.decode`` on the same weights and inputs.

* On a 2×2 ``("data", "model")`` mesh, every smoke model family (dense
  GQA, MoE, the hybrid with a rolling window, the mLSTM, MLA, the
  encoder–decoder and the vision prefix), float32: the prefill's logits
  and the decode's within 1e-5 of each max (the two packages add float32
  sums in other orders, and each rank computes only its batch block), and
  every rank's cache shard after each step within 1e-5 of its block of the
  reference's cache under ``CACHE_RULES`` (batch over data, seq over
  model), so the decode wrote the new position into the shard that owns
  it. MoE routing groups are one per sequence, so a batch block routes as
  the whole batch does.
* Every family computes on its shards (the ``tp`` path,
  ``distributed/tp.py``): prefill keeps each rank's block of positions of
  the caches (GQA's k/v, hymba's rolled window slots, MLA's latent
  ``ckv``/``kr``, whisper's self k/v and its cross ``xk``/``xv`` over the
  encoder's frames) and the recurrent states (the SSD's, the mLSTM's)
  whole on the heads, each rank computing its heads' part; decode attends
  over each block where it lies (MLA's absorbed form scoring every head
  over the rank's block; the cross caches only read); the MoE experts lie
  over (data, model) and their slots move by all-to-all. They are held the
  same way on 1×4 too, where qwen3's, internvl2's, granite's and hymba's
  one q head a rank reads one kv head of the whole kv projection (hymba's
  one SSD head a rank beside it), deepseek's 4 MLA heads, whisper's 4
  heads and xlstm's 4 (its smoke config given 4 in both packages) split 4
  ways, and yi-34b's smoke config with 6 heads and 2 kv heads (here on
  2×2 and 1×4) keeps its attention whole on 1×4.
* On a 1×1 mesh both steps equal ``Model.prefill``/``decode`` without a
  mesh bit for bit.
* ``cache_axes`` and ``model_axes_for`` equal the reference's trees.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed.steps import cache_axes as jax_cache_axes
from repro.distributed.steps import model_axes_for as jax_model_axes_for
from repro.models import Model as JModel
from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.distributed.group import run_ranks
from repro_torch.distributed.steps import cache_axes, model_axes_for
from repro_torch.utils import flatten_with_paths

GROUP_TIMEOUT_S = 120
# (arch, prompt tokens, cache positions): hymba's prompt passes its smoke
# window of 32, so its attention cache rolls and decode writes slot 48 % 32
CASES = {"qwen3-1.7b": (12, 16), "granite-moe-1b-a400m": (12, 16), "hymba-1.5b": (48, 64),
         "xlstm-1.3b": (12, 16), "deepseek-v3-671b": (12, 16), "whisper-tiny": (12, 16),
         "internvl2-76b": (12, 16), "yi-34b": (12, 16)}
# replacements in both packages' smoke configs: yi's 6 heads do not divide
# 4; xlstm's 2 would not split 4 ways
OVERRIDES = {"yi-34b": {"n_heads": 6, "n_kv_heads": 2},
             "xlstm-1.3b": {"n_heads": 4, "n_kv_heads": 4}}
# the 1x4 cases (every family)
TP_ARCHS = ("qwen3-1.7b", "internvl2-76b", "yi-34b", "granite-moe-1b-a400m", "deepseek-v3-671b",
            "hymba-1.5b", "xlstm-1.3b", "whisper-tiny")
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")
BATCH = 4
DECODE_STEPS = 2
TOL = 1e-5


def _cfg(arch, smoke_config=get_smoke_config):
    return dataclasses.replace(smoke_config(arch).with_(dtype="float32"),
                               **OVERRIDES.get(arch, {}))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Inputs and the reference's prefill and decode outputs per arch."""
    cases, want = {}, {}
    for arch, (s, s_ctx) in CASES.items():
        jcfg = _cfg(arch, jax_smoke_config)
        jm = JModel(jcfg)
        params, _ = jm.init(jax.random.PRNGKey(2))
        rng = np.random.default_rng(5)
        batch = {"tokens": rng.integers(0, jcfg.vocab, (BATCH, s)).astype(np.int32)}
        if jcfg.encdec:
            batch["enc_frames"] = rng.standard_normal(
                (BATCH, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
        if jcfg.vision_prefix:
            batch["vis_embeds"] = rng.standard_normal(
                (BATCH, jcfg.vision_prefix, jcfg.d_model)).astype(np.float32)
        steps = rng.integers(0, jcfg.vocab, (DECODE_STEPS, BATCH, 1)).astype(np.int32)
        s_max = s_ctx + jcfg.vision_prefix
        logits, caches = jm.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()}, s_max)
        out = {"logits": np.asarray(logits), "prefill_caches": _np(caches), "decode": []}
        pos = s + jcfg.vision_prefix
        for i in range(DECODE_STEPS):
            lg, caches = jm.decode(params, caches, jnp.asarray(steps[i]), pos + i)
            out["decode"].append((np.asarray(lg), _np(caches)))
        cases[arch] = {"params": _np(params), "batch": batch, "steps": steps, "s_ctx": s_ctx,
                       "pos": pos}
        want[arch] = out
    path = tmp_path_factory.mktemp("serve") / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    return path, cases, want


def _serve_rank(rank: int, cases_path: str, mesh_shape: tuple, no_mesh: bool,
                archs: tuple = ()) -> dict:
    """Each arch's (or each of ``archs``') prefill and decode steps on this
    rank's mesh: the whole logits, this rank's cache blocks (with their
    index), the steps' path, and with ``no_mesh`` the unsharded ``Model``
    outputs too."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import place_tree, sharding_of
    from repro_torch.distributed.steps import make_decode_step, make_prefill_step
    from repro_torch.models import Model, params_from_numpy

    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
    coord = tuple(mesh.get_coordinate())
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)

    def blocks(caches):
        flat, _ = flatten_with_paths(caches)
        return {k: (sharding_of(v).shard_index(v.shape, coord), v.to_local().clone().numpy())
                for k, v in flat.items()}

    out = {}
    for arch, case in cases.items():
        if archs and arch not in archs:
            continue
        cfg = _cfg(arch)
        s_ctx = case["s_ctx"]
        pstep, p_sh, _ = make_prefill_step(cfg, mesh, InputShape("p", s_ctx, BATCH, "prefill"))
        dstep, _, c_sh = make_decode_step(
            cfg, mesh, InputShape("d", s_ctx + cfg.vision_prefix, BATCH, "decode"))
        whole = params_from_numpy(case["params"], cfg, "cpu")
        params = place_tree(whole, p_sh)
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        logits, caches = pstep(params, batch)
        got = {"logits": logits.full_tensor().numpy(), "prefill": blocks(caches), "decode": [],
               "paths": (pstep.path, dstep.path), "experts": pstep.experts}
        assert dstep.experts == pstep.experts
        assert [sharding_of(v).spec for v in flatten_with_paths(caches)[0].values()] == \
            [s.spec for s in flatten_with_paths(c_sh)[0].values()]
        for i, tok in enumerate(case["steps"]):
            lg, caches = dstep(params, caches, torch.from_numpy(tok), case["pos"] + i)
            got["decode"].append((lg.full_tensor().numpy(), blocks(caches)))
        if no_mesh:
            model = Model(cfg)
            want_l, want_c = model.prefill(whole, batch, s_ctx + cfg.vision_prefix)
            got["no_mesh"] = {"logits": want_l.numpy(),
                              "prefill": {k: v.clone().numpy() for k, v in
                                          flatten_with_paths(want_c)[0].items()},
                              "decode": []}
            for i, tok in enumerate(case["steps"]):
                lg, want_c = model.decode(whole, want_c, torch.from_numpy(tok), case["pos"] + i)
                got["no_mesh"]["decode"].append(
                    (lg.numpy(), {k: v.clone().numpy()
                                  for k, v in flatten_with_paths(want_c)[0].items()}))
        out[arch] = got
    return out


@pytest.fixture(scope="module")
def ranks_2x2(reference):
    path = reference[0]
    return run_ranks(_serve_rank, 4, args=(str(path), (2, 2), False),
                     timeout_s=GROUP_TIMEOUT_S, threads=2)


@pytest.fixture(scope="module")
def ranks_1x4(reference):
    return run_ranks(_serve_rank, 4, args=(str(reference[0]), (1, 4), False, TP_ARCHS),
                     timeout_s=GROUP_TIMEOUT_S, threads=2)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= TOL * max(float(np.abs(want).max()), 1e-12), (what, err)


def _cache_blocks_close(got_blocks, want_caches, what):
    want, _ = flatten_with_paths(want_caches)
    assert sorted(got_blocks) == sorted(want)
    for path, (index, local) in got_blocks.items():
        block = np.asarray(want[path])[tuple(slice(a, b) for a, b in index)]
        assert local.shape == block.shape, (what, path)
        _close(local, block, (what, path))


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_prefill_and_decode_equal_reference_on_2x2(reference, ranks_2x2, arch):
    """Logits within 1e-5 of each max; each rank's cache blocks (batch over
    data, seq over model) within 1e-5 of its block of the reference's
    caches after the prefill and after each decode step."""
    want = reference[2][arch]
    blocks = set()
    for r in ranks_2x2:
        got = r[arch]
        _close(got["logits"], want["logits"], "prefill logits")
        _cache_blocks_close(got["prefill"], want["prefill_caches"], "prefill")
        for i, ((lg, cb), (wl, wc)) in enumerate(zip(got["decode"], want["decode"])):
            _close(lg, wl, f"decode {i} logits")
            _cache_blocks_close(cb, wc, f"decode {i}")
        blocks.add(tuple(sorted((k, idx) for k, (idx, _) in got["prefill"].items())))
        assert got["experts"] == (["data", "model"] if arch in MOE_ARCHS else [])
        assert got["paths"] == ("tp", "tp")
    # each rank its own blocks; the mLSTM state has no seq dim, so the two
    # ranks of a data row hold the same block
    assert len(blocks) == (2 if arch == "xlstm-1.3b" else 4)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_prefill_and_decode_equal_reference_on_1x4(reference, ranks_1x4, arch):
    """On 1×4 (one data row, the model axis 4 ways) the ``tp`` path's
    logits within 1e-5 of each max and each rank's block of positions of
    every cache (all kv heads) within 1e-5 of its block of the reference's,
    after the prefill and after each decode step: four distinct blocks
    (one for xlstm, whose mLSTM state has no positions: every rank holds
    it whole)."""
    want = reference[2][arch]
    blocks = set()
    for r in ranks_1x4:
        got = r[arch]
        assert got["paths"] == ("tp", "tp")
        _close(got["logits"], want["logits"], "prefill logits")
        _cache_blocks_close(got["prefill"], want["prefill_caches"], "prefill")
        for i, ((lg, cb), (wl, wc)) in enumerate(zip(got["decode"], want["decode"])):
            _close(lg, wl, f"decode {i} logits")
            _cache_blocks_close(cb, wc, f"decode {i}")
        blocks.add(tuple(sorted((k, idx) for k, (idx, _) in got["prefill"].items())))
    assert len(blocks) == (1 if arch == "xlstm-1.3b" else 4)


def test_cache_placements_on_2x2(ranks_2x2):
    """qwen3's k cache (L, B, S, KV, Dh): batch over data, seq over model —
    four distinct blocks of 2 rows and 8 positions."""
    idx = sorted(r["qwen3-1.7b"]["prefill"]["g0/k"][0] for r in ranks_2x2)
    assert [(i[1], i[2]) for i in idx] == [((0, 2), (0, 8)), ((0, 2), (8, 16)),
                                           ((2, 4), (0, 8)), ((2, 4), (8, 16))]


def test_one_rank_mesh_equals_no_mesh_bitwise(reference):
    """On a 1×1 mesh the steps are ``Model.prefill``/``decode`` bit for bit:
    logits and every cache leaf, after the prefill and each decode step."""
    (got,) = run_ranks(_serve_rank, 1, args=(str(reference[0]), (1, 1), True),
                       timeout_s=GROUP_TIMEOUT_S, threads=2)
    for arch, g in got.items():
        nm = g["no_mesh"]
        assert g["logits"].tobytes() == nm["logits"].tobytes(), arch
        assert {k: v.tobytes() for k, (_, v) in g["prefill"].items()} == \
            {k: v.tobytes() for k, v in nm["prefill"].items()}, arch
        for (lg, cb), (wl, wc) in zip(g["decode"], nm["decode"]):
            assert lg.tobytes() == wl.tobytes(), arch
            assert {k: v.tobytes() for k, (_, v) in cb.items()} == \
                {k: v.tobytes() for k, v in wc.items()}, arch


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_equal_reference(arch):
    """The decode caches' logical axes, every mixer and the encoder–decoder,
    at full size."""
    assert cache_axes(get_config(arch)) == jax_cache_axes(jax_config(arch))


@pytest.mark.parametrize("arch", list_archs())
def test_model_axes_for_equal_reference(arch):
    """The parameters' logical axes and shapes (smoke widths)."""
    axes, specs = model_axes_for(get_smoke_config(arch))
    jaxes, jstruct = jax_model_axes_for(jax_smoke_config(arch))
    tup = lambda x: isinstance(x, tuple)  # noqa: E731
    assert flatten_with_paths(axes, is_leaf=tup)[0] == jax_flatten(jaxes, is_leaf=tup)[0]
    assert {k: v.shape for k, v in flatten_with_paths(specs)[0].items()} == \
        {k: tuple(v.shape) for k, v in jax_flatten(jstruct)[0].items()}
