"""The port's recurrent mixers (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU.

Inputs are made with numpy from seeds and weights come from the reference's
own init, carried across as numpy arrays. Tolerances, with their reasons:
the chunked recurrence sums its products in another order and over whole
chunks at once, so 2e-4 (``tests/test_models.py``'s chunk-against-step
tolerance); the mixers in float32 1e-4; gradients 1e-4 of each gradient's
largest magnitude (``tests/test_torch_train.py``'s).

The reference exponentiates the whole Q×Q decay tile before masking it,
which overflows once a chunk's log-decays sum below about −88 and leaves
its gradients NaN (ROADMAP queue 3); the port masks the exponent first.
``test_recurrence_overflow_pinned`` holds both sides of that difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import ssm
from repro_torch.models.layers import rmsnorm

REC = dict(atol=2e-4, rtol=2e-4)
F32 = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grad_close(got, want, rel=1e-4):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


def _recurrence_inputs(seed, b, s, h, n, p, decay=0.1):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, h, p)).astype(np.float32)
    log_a = (-np.abs(rng.standard_normal((b, s, h))) * decay).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return q, k, v, log_a, s0


# ---------------------------------------------------------------------------
# the primitive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,with_state", [(37, 8, False), (37, 8, True), (64, 16, True),
                                                (5, 8, False), (16, 16, True)])
def test_chunked_recurrence_equals_reference(s, chunk, with_state):
    """Outputs and final state against the reference's scan over chunks,
    ragged S (padded to whole chunks) and an initial state included."""
    q, k, v, log_a, s0 = _recurrence_inputs(s, 2, s, 3, 4, 5)
    init = s0 if with_state else None
    jy, jstate = jssm.chunked_linear_recurrence(
        *(jnp.asarray(a) for a in (q, k, v, log_a)), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    y, state = ssm.chunked_linear_recurrence(
        *(_t(a) for a in (q, k, v, log_a)), chunk=chunk,
        initial_state=None if init is None else _t(init))
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (2, s, 3, 5) and state.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **REC)
    np.testing.assert_allclose(_np(state), np.asarray(jstate), **REC)


def test_recurrence_step_equals_reference():
    q, k, v, log_a, s0 = _recurrence_inputs(1, 2, 1, 3, 4, 5)
    a = np.exp(log_a[:, 0])
    jy, jstate = jssm.linear_recurrence_step(*(jnp.asarray(x) for x in (q[:, 0], k[:, 0],
                                                                      v[:, 0], a, s0)))
    y, state = ssm.linear_recurrence_step(*(_t(x) for x in (q[:, 0], k[:, 0], v[:, 0], a, s0)))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(state), np.asarray(jstate), **F32)


@pytest.mark.parametrize("chunk", [4, 8, 40])
def test_chunked_recurrence_equals_step_loop(chunk):
    """The port's chunk form against its own step-by-step recurrence from
    the same initial state (``tests/test_models.py``'s check of the
    reference)."""
    q, k, v, log_a, s0 = (_t(a) for a in _recurrence_inputs(2, 2, 37, 3, 4, 5))
    y_chunk, final = ssm.chunked_linear_recurrence(q, k, v, log_a, chunk=chunk, initial_state=s0)
    state, ys = s0, []
    for t in range(37):
        y, state = ssm.linear_recurrence_step(q[:, t], k[:, t], v[:, t], torch.exp(log_a[:, t]),
                                              state)
        ys.append(y)
    np.testing.assert_allclose(_np(y_chunk), _np(torch.stack(ys, 1)), **REC)
    np.testing.assert_allclose(_np(final), _np(state), **REC)


def _grads_both(q, k, v, log_a, chunk):
    """(outputs, gradients of sum(y * w) + sum(final * w2) in q, k, v,
    log_a) of the reference and of the port, from the same inputs."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal(v.shape).astype(np.float32)
    w2 = rng.standard_normal((v.shape[0], v.shape[2], q.shape[3], v.shape[3])).astype(np.float32)

    def jloss(*args):
        y, final = jssm.chunked_linear_recurrence(*args, chunk=chunk)
        return jnp.sum(y * w) + jnp.sum(final * w2), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, log_a)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v, log_a)]
    y, final = ssm.chunked_linear_recurrence(*leaves, chunk=chunk)
    tg = torch.autograd.grad((y * _t(w)).sum() + (final * _t(w2)).sum(), leaves)
    return np.asarray(jy), [np.asarray(g) for g in jg], _np(y), tg


def test_recurrence_overflow_pinned():
    """A chunk whose log-decays sum below −90 (−7 a token over 16 tokens):
    the reference's gradients in q, k and log a are not finite (its exp of
    the unmasked tile overflows and the backward multiplies 0 by inf), the
    port's forward equals the reference's and the port's gradients are
    finite."""
    q, k, v, _, _ = _recurrence_inputs(3, 1, 32, 2, 4, 5)
    log_a = np.full((1, 32, 2), -7.0, np.float32)
    assert log_a[0, :16, 0].sum() < -90
    jy, jg, y, tg = _grads_both(q, k, v, log_a, 16)
    assert all(not np.isfinite(jg[i]).all() for i in (0, 1, 3))  # q, k, log a
    np.testing.assert_allclose(y, jy, **REC)
    assert all(torch.isfinite(g).all() for g in tg)


@pytest.mark.parametrize("chunk", [8, 16])
def test_recurrence_gradients_equal_reference_at_moderate_decay(chunk):
    """Where the reference's gradients are finite, the port's equal them."""
    q, k, v, log_a, _ = _recurrence_inputs(4, 2, 37, 3, 4, 5, decay=0.5)
    _, jg, _, tg = _grads_both(q, k, v, log_a, chunk)
    assert all(np.isfinite(g).all() for g in jg)
    for got, want in zip(tg, jg):
        _grad_close(got, want)


# ---------------------------------------------------------------------------
# the mixers, on the smoke configs' layer 0 with the reference's weights
# ---------------------------------------------------------------------------


def _layer0(p):
    return {k: np.array(v)[0] for k, v in p.items()}


def _ssd_params():
    jcfg = jax_smoke_config("hymba-1.5b").with_(dtype="float32")
    p, _ = jssm.init_ssd(jax.random.PRNGKey(1), jcfg, 1)
    p = _layer0(p)
    rng = np.random.default_rng(11)  # gates away from their init's zeros
    p["dt_bias"] = rng.normal(0, 0.5, p["dt_bias"].shape).astype(np.float32)
    p["A_log"] = rng.normal(0, 0.5, p["A_log"].shape).astype(np.float32)
    p["D"] = rng.normal(1, 0.3, p["D"].shape).astype(np.float32)
    return jcfg, get_smoke_config("hymba-1.5b").with_(dtype="float32"), p


def _mlstm_params():
    jcfg = jax_smoke_config("xlstm-1.3b").with_(dtype="float32")
    p, _ = jssm.init_mlstm(jax.random.PRNGKey(2), jcfg, 1)
    p = _layer0(p)
    p["f_bias"] = np.random.default_rng(12).normal(2, 1, p["f_bias"].shape).astype(np.float32)
    return jcfg, get_smoke_config("xlstm-1.3b").with_(dtype="float32"), p


_MIXERS = {"ssd": (_ssd_params, jssm.ssd_train, ssm.ssd_train, jssm.ssd_decode, ssm.ssd_decode,
                   jssm.ssd_init_state),
           "mlstm": (_mlstm_params, jssm.mlstm_train, ssm.mlstm_train, jssm.mlstm_decode,
                     ssm.mlstm_decode, jssm.mlstm_init_state)}


@pytest.mark.parametrize("mixer", sorted(_MIXERS))
def test_mixer_train_equals_reference(mixer):
    """``ssd_train`` / ``mlstm_train`` at S = 40 over chunks of 16."""
    make, jtrain, train, *_ = _MIXERS[mixer]
    jcfg, cfg, p = make()
    x = np.random.default_rng(5).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want = jtrain({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    got = train({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    assert got.shape == (2, 40, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("mixer", sorted(_MIXERS))
def test_mixer_decode_equals_reference(mixer):
    """Four ``ssd_decode`` / ``mlstm_decode`` steps from the reference's
    zero state, outputs and states."""
    make, _, _, jdecode, decode, jinit = _MIXERS[mixer]
    jcfg, cfg, p = make()
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}
    jstate = jinit(jcfg, 2)
    state = _t(np.asarray(jstate))
    rng = np.random.default_rng(6)
    for _ in range(4):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = jdecode(jp, jnp.asarray(x), jstate, jcfg)
        y, state = decode(tp, _t(x), state, cfg)
        assert y.shape == (2, 1, cfg.d_model)
        np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
        np.testing.assert_allclose(_np(state), np.asarray(jstate), **F32)


def test_slstm_equals_reference():
    """The reference sLSTM (exponential gates with the stabiliser) over 50
    steps of large inputs, the reference's weights; and the port's init
    gives the reference's shapes and dtypes."""
    jp = jssm.init_slstm(jax.random.PRNGKey(0), 16, 8)
    x = (np.random.default_rng(8).standard_normal((2, 50, 16)) * 3.0).astype(np.float32)
    want = np.asarray(jssm.slstm_apply(jp, jnp.asarray(x)))
    got = ssm.slstm_apply({k: _t(v) for k, v in jp.items()}, _t(x))
    assert got.shape == (2, 50, 8) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), want, **F32)
    mine = ssm.init_slstm(torch.Generator().manual_seed(0), 16, 8)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in mine.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jp.items()}



def test_hymba_full_width_chunks_reach_the_overflow():
    """At hymba-1.5b's full width, with the reference's init (the port's
    draws from the same distribution), the SSD gates of rms-normalised
    inputs (dt ~0.78 on average) sum a 128-token chunk's log-decays to
    ~−100 on average, below −88.7, where float32's exp overflows: one such
    (chunk, head) makes the reference's gradients NaN in training; the
    port's masked tile does not (the test above)."""
    cfg = get_config("hymba-1.5b").with_(dtype="float32")
    p = {k: v[0] for k, v in ssm.init_ssd(torch.Generator().manual_seed(0), cfg, 1, "cpu").items()}
    x = torch.randn((4, cfg.chunk, cfg.d_model), generator=torch.Generator().manual_seed(1))
    _, log_a = ssm._ssd_gates(p, rmsnorm(x, torch.ones(cfg.d_model), cfg.norm_eps))
    assert cfg.chunk == 128 and float(log_a.sum(dim=1).mean()) < -88.7
