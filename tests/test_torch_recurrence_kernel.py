"""The chunked linear recurrence's CUDA kernels (``kernels/linear_recurrence``)
against the plain version (``models.ssm._recurrence``).

On the CPU: CPU tensors take the plain version and launch nothing; the
kernels' algorithm, step for step in float64 PyTorch (:func:`emulate`),
equals the plain version and its autograd gradients; and under
``FakeTensorMode`` the kernel path gives the plain version's shapes and
FLOP count (what the dry run reads).

On the card (marked ``cuda``, skipped without one; ``PYTHONPATH=src python
-m pytest -q -m cuda tests/test_torch_recurrence_kernel.py``): the kernels
against the plain version on the same card, at hymba's train and serve
shapes, the mLSTM's N 512 and P 513, a ragged S with an initial state and
full-width decays, bitwise repeatable; and against the JAX package's
``chunked_linear_recurrence`` itself at the mLSTM's N and P, ragged, with
an initial state: its outputs and ``jax.grad`` gradients are kept in
:data:`JAX_ANSWER` (the card has no JAX), which a CPU test recomputes with
JAX and holds equal. Tolerances are ``tests/test_torch_ssm.py``'s: 2e-4
forward (the products sum in another order), 1e-4 of each gradient's
largest magnitude.

To write :data:`JAX_ANSWER` again: ``PYTHONPATH=src python
tests/test_torch_recurrence_kernel.py``.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_recurrence import ops
from repro_torch.models import ssm

REC = dict(atol=2e-4, rtol=2e-4)
GRAD_REL = 1e-4
# the JAX package's answer at the mLSTM's N 512 and P 513: (B, S, H, N, P,
# chunk) and the seeds of the inputs (with an initial state) and cotangents
JAX_CASE = (1, 37, 1, 512, 513, 16)
JAX_SEEDS = (31, 32)
JAX_ANSWER = Path(__file__).parent / "data" / "linear_recurrence_jax_mlstm.npz"
JAX_KEYS = ("y", "final", "dq", "dk", "dv", "dlog_a", "dinit")


def _inputs(seed, b, s, h, n, p, *, decay=0.1, dtype=torch.float32, device="cpu", init=False):
    """q, k, v, log a and an initial state (or None), from numpy."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, h, p)).astype(np.float32)
    log_a = (-np.abs(rng.standard_normal((b, s, h))) * decay).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32) if init else None
    to = lambda x, dt=dtype: torch.from_numpy(x).to(device, dt)  # noqa: E731
    return (to(q), to(k), to(v), to(log_a, torch.float32),
            None if s0 is None else to(s0, torch.float32))


def _cotangents(seed, b, s, h, n, p, device="cpu"):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32)).to(device)
    w2 = torch.from_numpy(rng.standard_normal((b, h, n, p)).astype(np.float32)).to(device)
    return w, w2


def _grads(fn, ins, chunk, w, w2):
    """``(y, final, gradients of sum(y w) + sum(final w2) in every input)``."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in ins]
    y, final = fn(*leaves[:4], initial_state=leaves[4], chunk=chunk)
    loss = (y * w).sum() + (final * w2).sum()
    grads = torch.autograd.grad(loss, [t for t in leaves if t is not None])
    return y.detach(), final.detach(), grads


def _grad_close(got, want, rel=GRAD_REL):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= rel * max(float(want.abs().max()), 1e-12), (err, float(want.abs().max()))


def emulate(q, k, v, log_a, initial_state, chunk, dy, dfinal):
    """The kernels' algorithm in float64 PyTorch, step for step: each
    chunk's carry contribution, the carry in chunk order, the masked scores
    and outputs; then the state's gradient in reverse with dtot_c =
    <G_c+1, S_c+1>, dq, dk, dv, and d log a_t = dtot + sum_{t' >= t} (q_t' .
    dq_t' - k_t' . dk_t'). Returns ``(y, final, dq, dk, dv, d log a, d
    initial state)``."""
    b, s, h, n = q.shape
    p = v.shape[-1]
    cq = min(chunk, s)
    nc = -(-s // cq)
    pad = nc * cq - s

    def chunks(t):  # (B, S, H, X) -> (B, H, nc, Q, X), zeros past S
        t = F.pad(t.double(), (0, 0, 0, 0, 0, pad))
        return t.reshape(b, nc, cq, h, t.shape[-1]).permute(0, 3, 1, 2, 4)

    qc, kc, vc, dyc = (chunks(t) for t in (q, k, v, dy))
    la = F.pad(log_a.double(), (0, 0, 0, pad)).reshape(b, nc, cq, h).permute(0, 3, 1, 2)
    cum = torch.cumsum(la, -1)  # (B, H, nc, Q)
    tot = cum[..., -1]
    below = torch.ones((cq, cq), dtype=torch.bool).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~below, -math.inf))
    w_out = torch.exp(tot[..., None] - cum)  # exp(tot - cum_j)

    contrib = torch.einsum("bhcj,bhcjn,bhcjp->bhcnp", w_out, kc, vc)
    state = (torch.zeros((b, h, n, p), dtype=torch.float64) if initial_state is None
             else initial_state.double())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(tot[:, :, c])[..., None, None] + contrib[:, :, c]
    sin, final = torch.stack(entering, 2), state
    sc = torch.einsum("bhcin,bhcjn->bhcij", qc, kc) * decay
    y = (torch.einsum("bhcij,bhcjp->bhcip", sc, vc)
         + torch.exp(cum)[..., None] * torch.einsum("bhcin,bhcnp->bhcip", qc, sin))

    dcontrib = torch.einsum("bhci,bhcin,bhcip->bhcnp", torch.exp(cum), qc, dyc)
    g = dfinal.double()
    gout, dtot = [None] * nc, torch.zeros((b, h, nc), dtype=torch.float64)
    for c in reversed(range(nc)):
        after = final if c == nc - 1 else sin[:, :, c + 1]
        dtot[:, :, c] = (g * after).sum((-1, -2))
        gout[c] = g
        g = g * torch.exp(tot[:, :, c])[..., None, None] + dcontrib[:, :, c]
    gout = torch.stack(gout, 2)
    dp = torch.einsum("bhcip,bhcjp->bhcij", dyc, vc) * decay
    dq = (torch.einsum("bhcij,bhcjn->bhcin", dp, kc)
          + torch.exp(cum)[..., None] * torch.einsum("bhcip,bhcnp->bhcin", dyc, sin))
    dk = (torch.einsum("bhcij,bhcin->bhcjn", dp, qc)
          + w_out[..., None] * torch.einsum("bhcjp,bhcnp->bhcjn", vc, gout))
    dv = (torch.einsum("bhcij,bhcip->bhcjp", sc, dyc)
          + w_out[..., None] * torch.einsum("bhcjn,bhcnp->bhcjp", kc, gout))
    dcum = (qc * dq).sum(-1) - (kc * dk).sum(-1)
    dla = dtot[..., None] + torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))

    def unchunk(t):  # (B, H, nc, Q, X) -> (B, S, H, X)
        return t.permute(0, 2, 3, 1, 4).reshape(b, nc * cq, h, t.shape[-1])[:, :s]

    dla = dla.permute(0, 2, 3, 1).reshape(b, nc * cq, h)[:, :s]
    return unchunk(y), final, unchunk(dq), unchunk(dk), unchunk(dv), dla, g


def _jax_answer() -> dict:
    """The JAX package's ``chunked_linear_recurrence`` at :data:`JAX_CASE`:
    y, the final state and the gradients of sum(y w) + sum(final w2) in q,
    k, v, log a and the initial state (``jax.grad``), as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from repro.models import ssm as jssm

    b, s, h, n, p, chunk = JAX_CASE
    ins = [jnp.asarray(t.numpy()) for t in _inputs(JAX_SEEDS[0], b, s, h, n, p, init=True)]
    w, w2 = (jnp.asarray(t.numpy()) for t in _cotangents(JAX_SEEDS[1], b, s, h, n, p))

    def loss(q, k, v, log_a, init):
        y, final = jssm.chunked_linear_recurrence(q, k, v, log_a, chunk=chunk,
                                                  initial_state=init)
        return jnp.sum(y * w) + jnp.sum(final * w2), (y, final)

    (_, (y, final)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                                has_aux=True)(*ins)
    return dict(zip(JAX_KEYS, (np.asarray(x) for x in (y, final, *grads))))


def _against_jax_answer(y, final, grads) -> None:
    """``y``, ``final`` and the five gradients against :data:`JAX_ANSWER`."""
    want = np.load(JAX_ANSWER)
    np.testing.assert_allclose(y.double().cpu().numpy(), want["y"], **REC)
    np.testing.assert_allclose(final.double().cpu().numpy(), want["final"], **REC)
    for got, key in zip(grads, JAX_KEYS[2:]):
        _grad_close(got, torch.from_numpy(want[key]))


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_jax_answer_is_the_jax_packages():
    """:data:`JAX_ANSWER` is what the JAX package computes now (to within
    a twentieth of the tolerances it is used at: XLA's CPU products may sum
    in another order on another host), and its gradients are finite."""
    pytest.importorskip("jax")
    got, kept = _jax_answer(), np.load(JAX_ANSWER)
    assert sorted(kept.files) == sorted(JAX_KEYS)
    for key in JAX_KEYS:
        scale = float(np.abs(kept[key]).max())
        assert np.isfinite(kept[key]).all() and scale > 0, key
        np.testing.assert_allclose(got[key], kept[key], rtol=1e-5, atol=5e-6 * scale,
                                   err_msg=key)


def test_plain_equals_jax_answer_at_mlstm_widths():
    """The plain version (the CPU path) against :data:`JAX_ANSWER`: the
    mLSTM's N 512 and P 513, a ragged S, an initial state."""
    b, s, h, n, p, chunk = JAX_CASE
    ins = _inputs(JAX_SEEDS[0], b, s, h, n, p, init=True)
    w, w2 = _cotangents(JAX_SEEDS[1], b, s, h, n, p)
    _against_jax_answer(*_grads(ssm.chunked_linear_recurrence, ins, chunk, w, w2))


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors run ``_recurrence`` (the same bits) and leave the
    kernels' launch counts at 0, forward and backward."""
    ops.linear_recurrence.launches = ops.linear_recurrence.bwd_launches = 0
    ins = _inputs(1, 2, 37, 3, 4, 5, init=True)
    w, w2 = _cotangents(2, 2, 37, 3, 4, 5)
    y, final, grads = _grads(ssm.chunked_linear_recurrence, ins, 8, w, w2)
    y0, final0, grads0 = _grads(ssm._recurrence, ins, 8, w, w2)
    assert torch.equal(y, y0) and torch.equal(final, final0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert (ops.linear_recurrence.launches, ops.linear_recurrence.bwd_launches) == (0, 0)


@pytest.mark.parametrize("b,s,h,n,p,chunk,init,decay", [
    (2, 37, 3, 4, 5, 8, True, 0.1),     # ragged S, an initial state
    (1, 64, 2, 16, 64, 16, False, 0.5),  # hymba's N and P, whole chunks
    (2, 5, 2, 8, 9, 8, True, 0.1),      # one chunk shorter than the chunk
    (1, 48, 2, 6, 7, 16, False, 7.0),   # full-width decays (below -88 a chunk)
])
def test_kernel_algorithm_equals_plain(b, s, h, n, p, chunk, init, decay):
    """The kernels' decomposition (:func:`emulate`) against the plain
    version's outputs and autograd gradients. At full-width decays the
    plain gradients are finite too (the exponent is masked before exp)."""
    ins = _inputs(s + n, b, s, h, n, p, decay=decay, init=init)
    w, w2 = _cotangents(s, b, s, h, n, p)
    y0, final0, grads0 = _grads(ssm._recurrence, ins, chunk, w, w2)
    y, final, dq, dk, dv, dla, dinit = emulate(*ins, chunk, w, w2)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), **REC)
    np.testing.assert_allclose(final.numpy(), final0.numpy(), **REC)
    for got, want in zip((dq, dk, dv, dla) + ((dinit,) if init else ()), grads0):
        _grad_close(got, want)


def test_fake_tensors_give_shapes_and_the_plain_flops():
    """Under ``FakeTensorMode`` (the dry run) with CUDA fake tensors the
    kernel path runs no kernel, gives the plain version's shapes and
    dtypes, and ``torch.utils.flop_counter`` counts the forward operator
    as the plain forward's products and the backward operator as twice
    that, which is what autograd counts through the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, s, h, n, p, chunk = 2, 300, 3, 16, 64, 128
    cpu = _inputs(3, b, s, h, n, p)
    leaves = [t.requires_grad_(True) for t in cpu[:4]]
    with FlopCounterMode(display=False) as fc:
        y, final = ssm.chunked_linear_recurrence(*leaves, chunk=chunk)
    plain_fwd = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        (y.sum() + final.sum()).backward()
    plain_bwd = fc.get_total_flops()
    launches = ops.linear_recurrence.launches
    with FakeTensorMode():
        q, k = (torch.empty((b, s, h, n), device="cuda", dtype=torch.bfloat16) for _ in range(2))
        v = torch.empty((b, s, h, p), device="cuda", dtype=torch.bfloat16)
        log_a = torch.empty((b, s, h), device="cuda")
        with FlopCounterMode(display=False) as fc:
            fy, ffinal = ssm.chunked_linear_recurrence(q, k, v, log_a, chunk=chunk)
        fake_fwd = fc.get_total_flops()
        _, _, states, tot = ops.linear_recurrence_fwd(q, k, v, log_a, None, chunk)
        with FlopCounterMode(display=False) as fc:
            grads = ops.linear_recurrence_bwd(q, k, v, log_a, states, ffinal, tot, fy, ffinal,
                                              chunk)
        fake_bwd = fc.get_total_flops()
        assert fy.shape == y.shape and ffinal.shape == final.shape
        assert fy.dtype == ffinal.dtype == torch.float32 and fy.device.type == "cuda"
        assert states.shape == (b, h, -(-s // chunk), n, p) and tot.shape == (b, h, -(-s // chunk))
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape, log_a.shape, final.shape,
                                            states.shape]
    assert (fake_fwd, fake_bwd) == (plain_fwd, plain_bwd)
    assert ops.linear_recurrence.launches == launches


def test_kernel_path_refuses_what_it_does_not_take():
    """The wrapper raises for CPU tensors and for chunks over 128, before
    anything is built."""
    q, k, v, log_a, _ = _inputs(4, 1, 300, 2, 4, 5)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.linear_recurrence(q, k, v, log_a, chunk=16)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fq, fk = (torch.empty((1, 300, 2, 4), device="cuda") for _ in range(2))
        fv = torch.empty((1, 300, 2, 5), device="cuda")
        fla = torch.empty((1, 300, 2), device="cuda")
        with pytest.raises(ValueError, match="chunks up to 128"):
            ops.linear_recurrence(fq, fk, fv, fla, chunk=256)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (B, S, H, N, P, chunk, dtype, initial state, decay)
CARD_CASES = {
    "hymba_train": (2, 8192, 25, 16, 64, 128, torch.bfloat16, False, 0.1),
    "hymba_serve": (1, 32768, 25, 16, 64, 128, torch.bfloat16, False, 0.1),
    "mlstm": (1, 1000, 2, 512, 513, 128, torch.float32, True, 0.1),
    "ragged_with_state": (2, 1000, 3, 16, 64, 128, torch.float32, True, 0.3),
    "tiny": (2, 37, 3, 4, 5, 8, torch.float32, True, 0.1),
    # hymba's full width: -0.8 a token, about -100 a chunk (the reference's
    # backward overflows past -88)
    "full_width_decays": (1, 1024, 4, 16, 64, 128, torch.bfloat16, False, 1.0),
}


def _kernel_grads(ins, chunk, w, w2):
    """``(y, final, float32 gradients)`` straight from the two operators
    (before the autograd function casts each to its input's dtype)."""
    q, k, v, log_a, init = ins
    y, final, states, tot = ops.linear_recurrence_fwd(q, k, v, log_a, init, chunk)
    grads = ops.linear_recurrence_bwd(q, k, v, log_a, states, final, tot, w, w2, chunk)
    return y, final, grads[:4] + ((grads[4],) if init is not None else ())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_equal_plain_on_card(dev, case):
    """y, the final state and every float32 gradient against the plain
    version on the same card (its inputs widened to float32, as it widens
    them itself, so its gradients are not rounded to bf16 either); through
    autograd, one forward and one backward launch set, the same bits, and
    each gradient in its input's dtype; two runs bitwise equal."""
    b, s, h, n, p, chunk, dtype, init, decay = CARD_CASES[case]
    ins = _inputs(s + n, b, s, h, n, p, decay=decay, dtype=dtype, device=dev, init=init)
    w, w2 = _cotangents(s, b, s, h, n, p, device=dev)
    wide = [None if t is None else t.float() for t in ins]
    y0, final0, grads0 = _grads(ssm._recurrence, wide, chunk, w, w2)
    y, final, grads = _kernel_grads(ins, chunk, w, w2)
    torch.cuda.synchronize()
    assert y.dtype == final.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    torch.testing.assert_close(y, y0, **REC)
    torch.testing.assert_close(final, final0, **REC)
    for got, want in zip(grads, grads0):
        _grad_close(got, want)
    before = (ops.linear_recurrence.launches, ops.linear_recurrence.bwd_launches)
    ya, finala, gradsa = _grads(ssm.chunked_linear_recurrence, ins, chunk, w, w2)
    assert (ops.linear_recurrence.launches - before[0],
            ops.linear_recurrence.bwd_launches - before[1]) == (1, 1)
    assert torch.equal(ya, y) and torch.equal(finala, final)
    for got, want, t in zip(gradsa, grads, [t for t in ins if t is not None]):
        assert got.dtype == t.dtype and torch.equal(got, want.to(t.dtype))
    y2, final2, grads2 = _kernel_grads(ins, chunk, w, w2)
    assert torch.equal(y, y2) and torch.equal(final, final2)
    assert all(torch.equal(a, c) for a, c in zip(grads, grads2))


@pytest.mark.cuda
def test_kernels_equal_jax_answer_on_card(dev):
    """The kernels, forward and backward, against the JAX package's own
    answer (:data:`JAX_ANSWER`) from the same numpy inputs: the mLSTM's N
    512 and P 513, a ragged S (37 over chunks of 16), an initial state."""
    b, s, h, n, p, chunk = JAX_CASE
    ins = _inputs(JAX_SEEDS[0], b, s, h, n, p, device=dev, init=True)
    w, w2 = _cotangents(JAX_SEEDS[1], b, s, h, n, p, device=dev)
    y, final, grads = _kernel_grads(ins, chunk, w, w2)
    torch.cuda.synchronize()
    _against_jax_answer(y, final, grads)


@pytest.mark.cuda
def test_upper_triangle_weighs_nothing_on_card(dev):
    """One chunk at full-width decays: a value at the chunk's last position
    reaches no earlier output (its weight above the diagonal is exactly
    0), and an output gradient at position 0 reaches no later position's
    k or v; the forward without grad matches the forward with it."""
    b, s, h, n, p = 1, 128, 2, 16, 64
    q, k, v, log_a, _ = _inputs(5, b, s, h, n, p, decay=7.0, device=dev)
    v = torch.zeros_like(v)
    v[:, -1] = 1.0
    y, final = ops.linear_recurrence(q, k, v, log_a, chunk=128)
    assert torch.count_nonzero(y[:, :-1]) == 0 and torch.isfinite(y).all()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, log_a)]
    y, _ = ssm.chunked_linear_recurrence(*leaves, chunk=128)
    dy = torch.zeros_like(y)
    dy[:, 0] = 1.0
    dq, dk, dv, dla = torch.autograd.grad((y * dy).sum(), leaves)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv, dla))
    assert torch.count_nonzero(dk[:, 1:]) == 0 and torch.count_nonzero(dv[:, 1:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b"])
def test_recurrent_training_resumes_bitwise_on_card(dev, tmp_path, arch):
    """The smoke model trained 4 steps through the launcher on the card (its
    recurrence through the kernels, forward, recompute and backward), once
    straight and once preempted at step 2 and resumed: every step loss and
    every chunk digest of the final CMI equal."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.checkpoint import load_manifest
    from repro_torch.core import JobStore

    src = str(Path(__file__).resolve().parent.parent / "src")
    env = {**os.environ, "PYTHONPATH": src}
    digests, losses = {}, {}
    for name, extra in (("a", []), ("b", ["--preempt-at", "2"])):
        store, metrics = tmp_path / name, tmp_path / f"{name}.jsonl"
        subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                        "--smoke", "--device", "cuda", "--steps", "4", "--publish-every", "2",
                        "--seq-len", "72", "--batch", "4", "--store", str(store),
                        "--metrics", str(metrics), *extra], env=env, check=True, timeout=600)
        js = JobStore(store)
        (job_id, _), = js.svc_list_jobs()
        man = load_manifest(js.cmi_root(job_id), js.read_job(job_id).cmi)
        digests[name] = {p: [c.hash for c in e.chunks] for p, e in man.arrays.items()}
        losses[name] = [r["loss"] for r in map(json.loads, metrics.read_text().splitlines())
                        if r["event"] == "step"]
    assert digests["a"] == digests["b"] and losses["a"] == losses["b"] and len(losses["a"]) == 4
    assert all(math.isfinite(x) for x in losses["a"])


@pytest.mark.cuda
def test_launch_counter_counts_each_layer_once_on_card(dev):
    """hymba's smoke model on the card, its layers checkpointed as the
    benchmark runs them: a train step launches the forward twice a layer
    (the forward and the checkpoint's recomputation) and the backward once,
    and the spans' ``linear_recurrence.launches`` counts each layer's
    forward and backward once (a recomputation counts nothing); a prefill
    counts one forward a layer."""
    from repro_torch import spans
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import make_init_fn, make_train_step
    from repro_torch.distributed.steps import batch_to_device
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve.engine import ModelEngine

    cfg = get_smoke_config("hymba-1.5b")
    opt = AdamWConfig()
    state = make_init_fn(cfg, opt, seed=0, device=dev)()
    step = make_train_step(cfg, opt, peak_lr=1e-2, warmup=0, total_steps=4)
    b, _ = TokenPipeline(cfg, 72, 2, seed=3).batch_at({"data_step": 0, "seed": 3})
    batch = batch_to_device(b, dev)
    step(state, batch)  # the kernels built and warm
    before = (ops.linear_recurrence.launches, ops.linear_recurrence.bwd_launches)
    with spans.recording():
        step(state, batch)
    torch.cuda.synchronize()
    assert (ops.linear_recurrence.launches - before[0],
            ops.linear_recurrence.bwd_launches - before[1]) == (2 * cfg.n_layers, cfg.n_layers)
    assert spans.counters()["linear_recurrence.launches"] == 2 * cfg.n_layers
    bwd = [r for r in spans.records() if r.name == "linear_recurrence.bwd"]
    assert len(bwd) == cfg.n_layers and all(r.device_s > 0 for r in bwd)
    eng = ModelEngine("hymba-1.5b", smoke=True, seed=0, device=dev)
    prompt = (np.arange(40) * 7 % 200).astype(np.int32)
    with spans.recording():
        eng.prefill(prompt, 4)
    assert spans.counters()["linear_recurrence.launches"] == cfg.n_layers


if __name__ == "__main__":
    JAX_ANSWER.parent.mkdir(exist_ok=True)
    np.savez_compressed(JAX_ANSWER, **_jax_answer())
    print(f"wrote {JAX_ANSWER}")
