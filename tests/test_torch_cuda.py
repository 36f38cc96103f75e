"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA card (as on a CPU-only
machine) and run on an H100 with ``PYTHONPATH=src python -m pytest -q -m
cuda tests/test_torch_cuda.py``. ``chip_smoke.py`` runs the same checks at
the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.serializer import _chunk_rows
from repro_torch.kernels.colocate import colocate_match, colocate_match_plain
from repro_torch.kernels.colocate.cases import TIE_CASES, tie_case, unit_vectors
from repro_torch.kernels.delta_encode import changed_blocks, changed_blocks_plain
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import WGMMA_HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import _forward as flash_attention_forward

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,dtype,chunk", [
    ((100, 37), torch.float32, 7 * 37 * 4), ((33,), torch.int8, 4), ((5, 4, 3), torch.float64, 96),
    ((257, 130), torch.bfloat16, 16 * 260), ((4099,), torch.bool, 1000), ((), torch.float32, 4),
    ((0,), torch.float32, 64), ((70001, 3), torch.float32, 1 << 16),
])
def test_delta_encode_kernel_equals_plain(dev, shape, dtype, chunk):
    gen = torch.Generator().manual_seed(1)
    base = torch.randn(shape, generator=gen) * 50
    old = (base > 0 if dtype == torch.bool else base.to(dtype)).to(dev)
    rows = _chunk_rows(tuple(shape), old.element_size(), chunk)
    for mutate in ([], [0], [1, -1]):
        new = old.clone()
        for r in mutate:
            if shape and shape[0] > abs(r):
                new[r] = ~new[r] if dtype == torch.bool else new[r] + 1
        before = changed_blocks.launches
        got = changed_blocks(old, new, rows)
        assert torch.equal(got, changed_blocks_plain(old, new, rows))
        assert changed_blocks.launches == before + (1 if old.numel() else 0)


@pytest.mark.parametrize("n,m", [(1000, 300), (513, 512), (100, 1), (1, 700), (3000, 2049)])
def test_colocate_kernel_equals_plain_bitwise(dev, n, m):
    rng = np.random.default_rng(n + m)
    u, los = (torch.from_numpy(unit_vectors(rng, k)).to(dev) for k in (n, m))
    ki, kc = colocate_match(u, los)
    pi, pc = colocate_match_plain(u, los)
    assert torch.equal(ki, pi)
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))


@pytest.mark.parametrize("label", [c[0] for c in TIE_CASES])
def test_colocate_kernel_tie_rule(dev, label):
    """K2's tie cases (``repro_torch.kernels.colocate.cases``), which its
    sub-tiles, tiles, blocks and deferred rescan could get wrong: ``idx``
    equal and ``cos`` bitwise, one launch each."""
    u, los = (torch.from_numpy(a).to(dev) for a in tie_case(label))
    before = colocate_match.launches
    ki, kc = colocate_match(u, los)
    assert colocate_match.launches == before + 1
    pi, pc = colocate_match_plain(u, los)
    assert torch.equal(ki, pi)
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))
    if los.shape[0] == 0:
        assert not ki.any() and bool((kc == float("-inf")).all())


# the six cases of tests/test_kernels.py's flash attention sweep, then the
# tensor-core kernel's edges (bf16 at D = 64 and 128): Sk not a multiple of
# its 64-key tile, Sq != Sk, a window across tile edges, B = 2, rows with no
# visible key, no key at all, a bf16 head dim it does not take, the MoE
# model's prefill shape at D = 64, and groups of 5 q heads a kv head with
# a window (hymba-1.5b's 25 q / 5 kv heads at D = 64): small, a window
# across tile edges, and hymba's prefill past its 2048-token window; then
# v's head dim Dv apart from D (a 10th entry; MLA's qk 192 / v 128 on both
# kernels, ragged and at deepseek-v3's prefill, and a CUDA-core (96, 64)),
# and whisper-tiny's shapes at D = 64, 6 heads: its non-causal encoder over
# 1,500 frames (23 full 64-key tiles and 28 keys), its non-causal cross
# attention of 2,048 tokens against them (no causal skip, rows past Sq
# clipped) and its decoder's causal self-attention over 2,048 tokens
_FLASH_CASES = [
    # (b, h, hkv, sq, sk, d, causal, window, dtype[, dv])
    (2, 4, 4, 128, 128, 64, True, 0, "float32"),
    (1, 8, 2, 257, 257, 64, True, 0, "float32"),
    (2, 4, 2, 200, 200, 128, True, 64, "float32"),
    (1, 4, 4, 96, 160, 64, False, 0, "bfloat16"),
    (1, 2, 1, 512, 512, 64, True, 0, "bfloat16"),
    (1, 4, 4, 64, 64, 128, True, 32, "bfloat16"),
    (1, 4, 2, 200, 200, 128, True, 0, "bfloat16"),
    (1, 4, 2, 1000, 1000, 64, True, 0, "bfloat16"),
    (1, 4, 4, 300, 1000, 128, False, 0, "bfloat16"),
    (1, 2, 1, 1000, 300, 64, True, 0, "bfloat16"),
    (1, 4, 2, 700, 700, 128, True, 300, "bfloat16"),
    (2, 8, 4, 384, 384, 128, True, 0, "bfloat16"),
    (1, 4, 2, 256, 64, 128, True, 32, "bfloat16"),
    (1, 2, 1, 100, 0, 128, True, 0, "bfloat16"),
    (1, 2, 2, 130, 130, 96, True, 0, "bfloat16"),
    (1, 16, 8, 2048, 2048, 64, True, 0, "bfloat16"),  # granite-moe-1b-a400m's prefill
    (2, 10, 2, 333, 333, 64, True, 100, "bfloat16"),
    (1, 5, 1, 700, 700, 64, True, 300, "bfloat16"),
    (1, 25, 5, 4096, 4096, 64, True, 2048, "bfloat16"),  # hymba-1.5b's prefill
    (1, 4, 4, 200, 200, 192, True, 0, "bfloat16", 128),
    (1, 4, 4, 300, 300, 192, True, 0, "float32", 128),
    (2, 2, 2, 130, 70, 192, False, 0, "bfloat16", 128),
    (1, 2, 1, 100, 100, 96, True, 0, "bfloat16", 64),
    (1, 128, 128, 2048, 2048, 192, True, 0, "bfloat16", 128),  # deepseek-v3's MLA prefill
    (4, 6, 6, 1500, 1500, 64, False, 0, "bfloat16"),  # whisper-tiny's encoder
    (4, 6, 6, 2048, 1500, 64, False, 0, "bfloat16"),  # whisper-tiny's cross attention
    (4, 6, 6, 2048, 2048, 64, True, 0, "bfloat16"),  # whisper-tiny's decoder
    (1, 6, 6, 100, 1500, 64, False, 0, "bfloat16"),
    (1, 64, 8, 2304, 2304, 128, True, 0, "bfloat16"),  # internvl2-76b's prefill: 256 + 2048, G 8
]


def _case(case):
    """(b, h, hkv, sq, sk, d, dv, causal, window, dtype name)."""
    b, h, hkv, sq, sk, d, causal, window, dt, *rest = case
    return b, h, hkv, sq, sk, d, rest[0] if rest else d, causal, window, dt


def _bshd(t):
    """The same values held as (B, S, H, D) storage: the model's layout."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("case", _FLASH_CASES, ids=[str(c) for c in _FLASH_CASES])
def test_flash_attention_kernel_equals_plain(dev, case):
    b, h, hkv, sq, sk, d, dv, causal, window, dt = _case(case)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    rng = np.random.default_rng(sq * 7 + d)
    dtype = getattr(torch, dt)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    q, k, v = rand(b, h, sq, d), rand(b, hkv, sk, d), rand(b, hkv, sk, dv)
    before, before_wgmma = flash_attention.launches, flash_attention.wgmma_launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    # bf16 at (D, Dv) = (64, 64), (128, 128) or (192, 128) goes through the
    # tensor-core kernel, all else not
    wgmma = dt == "bfloat16" and (d, dv) in WGMMA_HEAD_DIMS
    assert flash_attention.wgmma_launches == before_wgmma + wgmma
    assert got.dtype == dtype and got.shape == (b, h, sq, dv)
    # float32: sums in another order (2e-5); bfloat16: one rounding of the
    # output apart at most (2e-2), the tolerances of tests/test_kernels.py
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dt == "bfloat16":
        # and each output is the float32 answer rounded once to bf16: within
        # 2**-8 of its magnitude, plus the float32 tolerance
        ref32 = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                      window=window)
        assert ((got.float() - ref32).abs() <= 2.0 ** -8 * ref32.abs() + 2e-5).all()
    # a row that sees no key is exactly 0, in the kernel as in the plain version
    qpos, kpos = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    seen = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        seen &= kpos <= qpos
    if window > 0:
        seen &= kpos > qpos - window
    blind = ~seen.any(dim=1).to(dev)
    assert not got[:, :, blind].any() and not want[:, :, blind].any()
    # (B, S, H, D) storage read through strides gives the same answer
    torch.testing.assert_close(flash_attention(_bshd(q), _bshd(k), _bshd(v), causal=causal,
                                               window=window), got, atol=0, rtol=0)


@pytest.mark.parametrize("case", _FLASH_CASES, ids=[str(c) for c in _FLASH_CASES])
def test_flash_attention_kernel_lse_equals_plain(dev, case):
    """K3 asked for its row log-sum-exp (the training forward): the same
    output bits as without it, one more ``lse_launches``, and lse within
    1e-4 of the plain version's (scores summed in another order; the
    tensor-core kernel works in exp2/log2). A row that sees no key has +inf
    in both."""
    b, h, hkv, sq, sk, d, dv, causal, window, dt = _case(case)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(sq * 7 + d)
    dtype = getattr(torch, dt)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    q, k, v = rand(b, h, sq, d), rand(b, hkv, sk, d), rand(b, hkv, sk, dv)
    before = flash_attention.lse_launches
    got, lse = flash_attention_forward(q, k, v, causal, window, None, True)
    assert flash_attention.lse_launches == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert torch.equal(got, flash_attention(q, k, v, causal=causal, window=window))
    want, want_lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                           return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))


def _attention_f32(q, k, v, causal, window):
    """Plain float32 attention under autograd: the gradient's yardstick."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, sq, d)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2)) / d ** 0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    p = torch.softmax(torch.where(mask, s, float("-inf")), dim=-1)
    return torch.matmul(p, v.float()[:, :, None]).reshape(b, h, sq, v.shape[-1])


@pytest.mark.parametrize("case", [c for c in _FLASH_CASES if c[4] >= c[3] and c[4] > 0],
                         ids=[str(c) for c in _FLASH_CASES if c[4] >= c[3] and c[4] > 0])
def test_flash_attention_gradient_on_the_card(dev, case):
    """K3 under autograd on the card (the kernel's forward with lse, the
    plain backward) against float32 autograd of plain attention on the same
    values: 1e-4 in float32 (sums in another order); in bf16, where the
    output and the gradients round to bf16 once, 2e-2 of each gradient's
    largest magnitude. The backward matches :func:`flash_attention_backward_plain`
    fed the plain version's output and lse."""
    b, h, hkv, sq, sk, d, dv, causal, window, dt = _case(case)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(sq * 11 + d)
    dtype = getattr(torch, dt)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    q, k, v = rand(b, h, sq, d), rand(b, hkv, sk, d), rand(b, hkv, sk, dv)
    dout = rand(b, h, sq, dv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.lse_launches
    out = flash_attention(*leaves, causal=causal, window=window)
    assert flash_attention.lse_launches == before + 1
    got = torch.autograd.grad(out, leaves, dout)
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_attention_f32(*ref, causal, window), ref, dout.float())
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        if dt == "float32":
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            assert float((g.float() - w).abs().max()) <= 2e-2 * float(w.abs().max())
    po, plse = flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    plain = flash_attention_backward_plain(q, k, v, po, plse, dout, causal=causal, window=window)
    for g, w in zip(got, plain):
        torch.testing.assert_close(g.float(), w.float(), atol=1e-2 if dt == "bfloat16" else 1e-4,
                                   rtol=1e-2 if dt == "bfloat16" else 1e-4)


# ---------------------------------------------------------------------------
# the fabric on the card: torch workers with their own CUDA contexts
# ---------------------------------------------------------------------------


def test_cuda_worker_holds_resident_state_on_the_card(dev, tmp_path):
    """A worker spawned on ``cuda`` reports ``cuda:0`` and the state streamed
    to it lands there: a stage run on it in place launches K2 in the worker."""
    from repro_torch.core import DHP, NBS
    from repro_torch.core import colocation as co
    from repro_torch.fabric.supervisor import FabricSupervisor

    sup = FabricSupervisor(str(tmp_path / "s3"), device="cuda")
    try:
        h = sup.spawn("W", serve_only=True)
        nbs = NBS(tmp_path / "s3")
        nbs.add_node("A", device=dev)
        nbs.add_remote_node("W", h.address)
        assert nbs.call("W", "svc/ping")["device"] == "cuda:0"
        dhp = DHP(nbs, "A", chunk_bytes=1 << 16)
        state = co.stage_geometry(co.stage_read({}, device=dev, seed=0, n_scans=2,
                                                viirs_lines_per_scan=4,
                                                viirs_pixels_per_scan=400))
        ref = dhp.hop(state, "W")
        assert ref.via == "stream"
        nbs.call("W", "svc/kernel_launches", reset=True)
        r = nbs.call("W", "svc/run_stage", token=ref.token,
                     fn="repro_torch.core.colocation:stage_match")
        assert nbs.call("W", "svc/kernel_launches")["colocate"] == 1
        back, _ = nbs.node("W").fetch_stream(r["token"], device=dev)
        assert back["idx"].device.type == "cuda"
        want = co.stage_match(state)
        assert torch.equal(back["idx"], want["idx"])
    finally:
        sup.shutdown()


def test_delta_stream_hop_with_k1_hints_sends_only_changed_chunks(dev, tmp_path):
    from repro_torch.core import DHP, NBS
    from repro_torch.core.delta import device_changed_hints
    from repro_torch.fabric.supervisor import FabricSupervisor
    from repro_torch.kernels.delta_encode import ops as delta_ops

    sup = FabricSupervisor(str(tmp_path / "s3"), device="cuda")
    try:
        h = sup.spawn("W", serve_only=True)
        nbs = NBS(tmp_path / "s3")
        nbs.add_node("A", device=dev)
        wnode = nbs.add_remote_node("W", h.address)
        dhp = DHP(nbs, "A", chunk_bytes=1 << 16)
        gen = torch.Generator(device=dev).manual_seed(0)
        src = {"x": torch.randn(4096, 64, device=dev, generator=gen),
               "y": torch.randn(1000, device=dev, generator=gen)}
        dhp.hop(src, "W")
        full = dict(wnode.last_stream_receipt)
        new = {**src, "x": src["x"].clone()}
        new["x"][1000] += 1.0  # one row: one chunk of 256 rows
        before = delta_ops.changed_blocks.launches
        hints = device_changed_hints(src, new, chunk_bytes=1 << 16)
        assert delta_ops.changed_blocks.launches == before + 2  # K1, one a leaf
        ref = dhp.hop(new, "W", changed_hint=hints)
        delta = wnode.last_stream_receipt
        assert delta["chunks"] == full["chunks"] and delta["data_chunks"] == 1
        back, _ = wnode.fetch_stream(ref.token, device=dev)
        assert torch.equal(back["x"], new["x"]) and torch.equal(back["y"], new["y"])
    finally:
        sup.shutdown()


# ---------------------------------------------------------------------------
# the serving fleet and the chaos matrix on the card
# ---------------------------------------------------------------------------


def test_cuda_serving_workers_migrate_and_resume_with_k3_inside(dev, tmp_path):
    """Two serving workers on ``cuda`` (a smoke-width model): K3 runs once a
    layer of every admit inside the workers and never on adopt or resume; a
    warmed-then-handed-off request keeps its transcript with zero
    re-prefill, and so do the requests of a SIGKILLed worker resumed on the
    survivor — all equal to an in-process engine's on the same card."""
    from repro_torch.core.jobstore import JobStore
    from repro_torch.fabric.supervisor import FabricSupervisor
    from repro_torch.serve import ServeRouter, make_engine, run_reference, spawn_serve_worker

    spec = "model:qwen3-1.7b:smoke:seed=0"
    engine = make_engine(spec, device=dev)
    reqs = [{"id": f"c{i}", "prompt": [int(t) for t in np.random.default_rng(i).integers(
        0, engine.vocab, 40)], "max_new": 16} for i in range(4)]
    want = run_reference(engine, reqs)
    sup = FabricSupervisor(str(tmp_path / "s3"), str(tmp_path / "jobs"), device="cuda")
    router = ServeRouter(jobstore=JobStore(tmp_path / "jobs"))
    try:
        for name in ("s0", "s1"):
            h = spawn_serve_worker(sup, name, engine_spec=spec, publish_every=4)
            router.add_worker(name, h.address)
            router.call(name, "svc/kernel_launches", reset=True)
        for req in reqs:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        counts = {n: router.call(n, "svc/kernel_launches") for n in ("s0", "s1")}
        layers = engine.cfg.n_layers
        assert {n: c["flash_attention"] for n, c in counts.items()} == {
            "s0": 2 * layers, "s1": 2 * layers}
        # the tensor-core kernel serves head dims 64 and 128 (the smoke config's is 16)
        wgmma = engine.cfg.resolved_head_dim in (64, 128)
        assert all(c["flash_attention_wgmma"] == (c["flash_attention"] if wgmma else 0)
                   for c in counts.values())
        for _ in range(3):
            router.step()
        victim = next(r for r in sorted(router.pending()) if router.assignment[r] == "s0")
        router.warm(victim, "s1")
        router.step()
        event = router.migrate(victim, "s1", warm=False)
        assert event["mode"] == "stream" and event["warm"]
        for _ in range(3):
            router.step()
        assert sup.reclaim("s0", notice=False) < 0
        assert router.recover("s0", "s1")
        router.run_to_completion()
        assert {r["id"]: router.transcript(r["id"]) for r in reqs} == want
        status = router.call("s1", "svc/serve_status")["counters"]
        assert status["prefills"] == 2 and status["migrations_in"] == 1
        assert router.call("s1", "svc/kernel_launches") == counts["s1"]
    finally:
        router.close()
        sup.shutdown()


@pytest.mark.parametrize("cell_id", ["hop.before_restore:sigkill", "relay.mid_stream:kill_conn",
                                     "hop_stream.accept:sigkill"])
def test_chaos_tour_cell_on_cuda_workers(dev, cell_id):
    from repro_torch.chaos import matrix

    matrix.run_cell(next(c for c in matrix.CELLS if c["id"] == cell_id), device="cuda")


# ---------------------------------------------------------------------------
# the MoE family on the card
# ---------------------------------------------------------------------------


def test_moe_ffn_on_the_card_equals_cpu(dev):
    """granite's smoke MoE layer on the card (bf16) against the port's CPU
    path in float32 at the same bf16 values: outputs within 2e-2 of the
    largest magnitude, the same routing (inputs and router weights whose
    logits are exact in float32 on both devices, ties included) and the
    same (token, expert) assignments kept at a capacity factor that drops."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = get_smoke_config("granite-moe-1b-a400m").with_(capacity_factor=0.5)
    e, x_, f = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
    rng = np.random.default_rng(5)
    w = {"w_router": rng.integers(-8, 9, (e, x_)).astype(np.float32) / 64,
         "wg": rng.standard_normal((x_, e, f)).astype(np.float32) / np.sqrt(e),
         "wu": rng.standard_normal((x_, e, f)).astype(np.float32) / np.sqrt(e),
         "wd": rng.standard_normal((x_, f, e)).astype(np.float32) / np.sqrt(f)}
    own = np.zeros_like(w["wd"])
    own[np.arange(x_), :, np.arange(x_)] = 1.0 + np.abs(rng.standard_normal((x_, f)))
    x = (rng.integers(-2, 3, (2, 64, e)) / 4).astype(np.float32)
    for wd in (w["wd"], own):
        card = {k: torch.from_numpy(v).to(dev, torch.float32 if k == "w_router"
                                          else torch.bfloat16)
                for k, v in {**w, "wd": wd}.items()}
        host = {k: v.float().cpu() for k, v in card.items()}
        got = moe.moe_ffn(card, torch.from_numpy(x).to(dev, torch.bfloat16), cfg).float().cpu()
        want = moe.moe_ffn(host, torch.from_numpy(x), cfg.with_(dtype="float32"))
        assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    kept = lambda out: set(map(tuple, torch.nonzero(out[..., :x_]).tolist()))  # noqa: E731
    assert kept(got) == kept(want) and len(kept(want)) < x.shape[0] * x.shape[1] * cfg.top_k


def test_moe_serve_and_train_on_the_card(dev, tmp_path):
    """granite's smoke config on the card: ``launch.serve`` transcripts equal
    ``run_reference``'s; the Fig. 7 launcher (one process a run, so its
    deterministic settings precede its first CUDA call) reclaimed at step 2
    and resumed ends with every chunk digest of its final CMI equal to the
    uninterrupted run's."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.checkpoint import load_manifest
    from repro_torch.core import JobStore
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import make_engine, run_reference

    arch = "granite-moe-1b-a400m"
    got = launch_serve.main(["--arch", arch, "--smoke", "--device", "cuda", "--gen", "8",
                             "--prompt-len", "40", "--batch", "3"])["transcripts"]
    engine = make_engine(f"model:{arch}:smoke:seed=0", device=dev)
    reqs = launch_serve.build_requests(engine.vocab, batch=3, prompt_len=40, gen=8, seed=0)
    assert got == run_reference(engine, reqs)

    src = str(Path(__file__).resolve().parent.parent / "src")
    env = {**os.environ, "PYTHONPATH": src}
    digests, losses = {}, {}
    for name, extra in (("a", []), ("b", ["--preempt-at", "2"])):
        store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
        subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                        "--smoke", "--device", "cuda", "--steps", "4", "--publish-every", "2",
                        "--seq-len", "64", "--batch", "4", "--store", str(store),
                        "--metrics", str(metrics), *extra], env=env, check=True, timeout=600)
        js = JobStore(store)
        (job_id, _), = js.svc_list_jobs()
        man = load_manifest(js.cmi_root(job_id), js.read_job(job_id).cmi)
        digests[name] = {p: [c.hash for c in e.chunks] for p, e in man.arrays.items()}
        losses[name] = [r["loss"] for r in map(json.loads, metrics.read_text().splitlines())
                        if r["event"] == "step"]
    assert digests["a"] == digests["b"] and losses["a"] == losses["b"] and len(losses["a"]) == 4


def test_one_rank_cuda_mesh_equals_no_mesh(dev, tmp_path):
    """The Fig. 7 launcher on a 1×1 ``("data", "model")`` cuda mesh (an NCCL
    group of one) reclaimed at step 2 and resumed (``--remesh 1x1,1x1``):
    every step loss and every chunk digest of its final CMI equal the run
    without a mesh; the CMI records ``mesh_shape [1, 1]``."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.checkpoint import load_manifest
    from repro_torch.core import JobStore

    src = str(Path(__file__).resolve().parent.parent / "src")
    env = {**os.environ, "PYTHONPATH": src}
    digests, losses, records = {}, {}, {}
    for name, extra in (("none", []), ("mesh", ["--remesh", "1x1,1x1", "--preempt-at", "2"])):
        store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
        subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
                        "--smoke", "--device", "cuda", "--steps", "4", "--publish-every", "2",
                        "--seq-len", "64", "--batch", "4", "--store", str(store),
                        "--metrics", str(metrics), *extra], env=env, check=True, timeout=600)
        js = JobStore(store)
        (job_id, _), = js.svc_list_jobs()
        man = load_manifest(js.cmi_root(job_id), js.read_job(job_id).cmi)
        digests[name] = {p: [c.hash for c in e.chunks] for p, e in man.arrays.items()}
        records[name] = man.arrays["params/embed"].sharding
        losses[name] = [r["loss"] for r in map(json.loads, metrics.read_text().splitlines())
                        if r["event"] == "step"]
    assert digests["none"] == digests["mesh"] and losses["none"] == losses["mesh"]
    assert len(losses["none"]) == 4 and records["none"] is None
    assert records["mesh"].mesh_shape == [1, 1]


def test_one_rank_cuda_mesh_equals_no_mesh_deepseek(dev):
    """deepseek-v3's smoke model (MLA + MoE) on a 1×1 cuda mesh (an NCCL
    group of one, nothing split: the model's plain code): one train step's
    loss, gradient norm and every param after it, then the prefill's and
    a decode step's logits and caches, bit for bit the steps without a
    mesh on the same card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed.group import free_port, in_group
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.distributed.steps import (make_decode_step, make_init_fn,
                                               make_prefill_step, make_train_step)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import flatten_with_paths

    cfg = get_smoke_config("deepseek-v3-671b")
    gen = torch.Generator(dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    plain = make_init_fn(cfg, AdamWConfig(), seed=1, device=dev)()
    _, m0 = make_train_step(cfg, AdamWConfig())(plain, batch)
    model = Model(cfg)
    want_l, want_c = model.prefill(plain["params"], {"tokens": tokens}, 20)
    want_c = flatten_with_paths(want_c)
    want_d, _ = model.decode(plain["params"], want_c[1].unflatten(
        {k: v.clone() for k, v in want_c[0].items()}), tokens[:, :1], 16)
    with in_group(0, 1, free_port(), "cuda", 600):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        st = make_init_fn(cfg, AdamWConfig(), seed=1, mesh=mesh)()
        step = make_train_step(cfg, AdamWConfig(), mesh=mesh)
        _, m1 = step(st, batch)
        assert step.path == "tp" and step.experts == []
        for k, v in flatten_with_paths(plain["params"])[0].items():
            assert torch.equal(flatten_with_paths(st["params"])[0][k].to_local(), v), k
        assert float(m0["loss"]) == float(m1["loss"])
        assert float(m0["grad_norm"]) == float(m1["grad_norm"])
        pstep, p_sh, _ = make_prefill_step(cfg, mesh, InputShape("p", 20, 4, "prefill"))
        dstep, _, _ = make_decode_step(cfg, mesh, InputShape("d", 20, 4, "decode"))
        params = place_tree(plain["params"], p_sh)
        logits, caches = pstep(params, {"tokens": tokens})
        assert torch.equal(logits.to_local(), want_l)
        for k, c in flatten_with_paths(caches)[0].items():
            assert torch.equal(c.to_local(), want_c[0][k]), k
        d_logits, _ = dstep(params, caches, tokens[:, :1], 16)
        assert torch.equal(d_logits.to_local(), want_d)


# ---------------------------------------------------------------------------
# MLA on the card
# ---------------------------------------------------------------------------


def test_mla_layer_on_the_card_equals_cpu(dev):
    """One dense deepseek-v3 layer at full width (MLA, then the SwiGLU FFN;
    random weights from seed 20) over 96 tokens and one absorbed decode
    step on the card against the port's CPU path in float32 (which
    tests/test_torch_mla.py holds against the JAX package), from the same
    bf16 values: the outputs and the latent cache. bf16 on the card (K3's
    tensor-core kernel at qk 192 / v 128) within 2e-2 of each one's
    largest magnitude; float32 (its CUDA-core kernel, TF32 off) within
    1e-4 (``repro_torch.models.cases``, which chip_smoke.py runs at 256
    tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.models.cases import check_mla_layer_on_device

    got = check_mla_layer_on_device(dev, get_config("deepseek-v3-671b"), 96)
    assert set(got["bfloat16"]) == set(got["float32"]) == {"tol", "out", "decode_out", "ckv",
                                                           "kr"}


@pytest.mark.parametrize("dtype,with_lse", [("bfloat16", False), ("bfloat16", True),
                                            ("float32", False), ("float32", True)])
def test_k3_op_cuda_cpu_and_fake_implementations(dev, dtype, with_lse):
    """``repro_torch::flash_attention_fwd``: on CUDA tensors the launch (the
    counters move by one, the tensor-core one for bf16, the lse one with
    lse), within 2e-2 (bf16) or 2e-5 of the CPU implementation, which is
    the plain version and launches nothing; on fake CUDA tensors the fake
    implementation (shapes and dtypes, no launch); counted by its FLOP
    formula, 2 (D + Dv) a visible pair."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd, visible_pairs
    from repro_torch.launch.hlo_stats import count

    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen).to(dt) for s in
               ((2, 8, 200, 128), (2, 4, 200, 128), (2, 4, 200, 128)))
    counts = lambda: (flash_attention.launches, flash_attention.wgmma_launches,  # noqa: E731
                      flash_attention.lse_launches)
    args = (True, 0, 128 ** -0.5, with_lse)
    before = counts()
    cpu_out, cpu_lse = flash_attention_fwd(q, k, v, *args)
    assert counts() == before
    out, lse = flash_attention_fwd(*(t.to(dev) for t in (q, k, v)), *args)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + (dt == torch.bfloat16), before[2] + with_lse)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.cpu().float(), cpu_out.float(), atol=tol, rtol=tol)
    assert lse.shape == cpu_lse.shape == ((2, 8, 200) if with_lse else (0,))
    if with_lse:
        torch.testing.assert_close(lse.cpu(), cpu_lse, atol=1e-4, rtol=1e-4)
    on_card = [t.to(dev) for t in (q, k, v)]
    with FakeTensorMode() as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in on_card)
        (fout, flse), r = count(flash_attention_fwd, fq, fk, fv, *args)
        assert fout.device.type == "cuda" and (fout.shape, fout.dtype) == (out.shape, out.dtype)
        assert flse.shape == lse.shape
    assert counts() == (before[0] + 1, before[1] + (dt == torch.bfloat16), before[2] + with_lse)
    assert r["flops"] == 2 * 8 * visible_pairs(200, 200, True, 0) * 2 * 256


@pytest.mark.parametrize("name", ["qwen3_serve_16", "command_r_16", "deepseek_mla_16",
                                  "hymba_window_5", "whisper_cross_2"])
def test_k3_on_a_ranks_head_slice_is_bitwise_the_whole_call(dev, name):
    """K3 on each tensor-parallel rank's q heads and its view (or block)
    of the kv heads (qwen3's serve prefill sliced 16 ways: 1 q head,
    G_local 1; command-r's: 6 q heads a rank reading 1 kv head, G 12;
    deepseek-v3's MLA: 8 of 128 heads a rank at qk 192 / v 128; hymba's
    windowed attention on 5 ranks, 5 q heads and 1 kv head each; whisper's
    non-causal cross attention on 2, Sq 4096 against Sk 1500) equals
    those heads of the call over every head bit for bit; each view goes
    to the tensor-core kernel as it is, one launch a rank."""
    from repro_torch.kernels.flash_attention.cases import HEAD_SLICE_CASES, check_head_slices

    got = check_head_slices(dev, *HEAD_SLICE_CASES[name])
    assert got["bitwise"] and got["views_taken_as_is"], got
    assert got["rank_wgmma_launches"] == HEAD_SLICE_CASES[name][-1], got
