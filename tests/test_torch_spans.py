"""The port's spans (``repro_torch.spans``) on the CPU, at the registry's
small granite and hymba configurations with their layers checkpointed as
the benchmark's cells run them (``remat="nothing"``): every span under a
profiler, backward spans inside the step, nothing recorded and no autograd
node added with recording off, loss and gradients bitwise the same either
way, the MoE's slot counters against a count made by hand, and the
engine's prefill span. The ``cuda`` case reads device intervals on the
card."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.distributed import make_init_fn, make_train_step
from repro_torch.distributed.steps import batch_to_device
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod
from repro_torch.serve.engine import ModelEngine, is_done, transcript
from repro_torch.utils import flatten_with_paths

CPU = torch.device("cpu")
ARCHS = ["granite-moe-1b-a400m", "hymba-1.5b"]
# the spans a train step of each opens, beside train_step, adamw_update,
# loss_head, loss_head.bwd and recompute
LAYER_SPANS = {"granite-moe-1b-a400m": {"moe_dispatch", "moe_experts", "moe_combine",
                                        "moe.bwd"},
               "hymba-1.5b": {"linear_recurrence", "linear_recurrence.bwd"}}
STEP_SPANS = {"train_step", "adamw_update", "loss_head", "loss_head.bwd", "recompute"}
MARKERS = {"_MarkerBackward"}


def _cfg(arch):
    cfg = get_smoke_config(arch)
    assert cfg.remat == "nothing"
    return cfg


def _batch(cfg, seq_len=48, batch=2, step=0):
    b, _ = TokenPipeline(cfg, seq_len, batch, seed=3).batch_at({"data_step": step, "seed": 3})
    return batch_to_device(b, CPU)


def _step(arch):
    from repro_torch.optim import AdamWConfig

    cfg = _cfg(arch)
    opt = AdamWConfig()
    state = make_init_fn(cfg, opt, seed=0, device=CPU)()
    return cfg, state, make_train_step(cfg, opt, peak_lr=1e-2, warmup=0, total_steps=4)


def _end_the_stretch():
    """A span opened with recording off: the next profile starts a new
    stretch of the store."""
    with spans.span("off"):
        pass


def _ancestors(rec, by_id):
    out = []
    while rec.parent is not None:
        rec = by_id[rec.parent]
        out.append(rec.name)
    return out


def _loss_and_grads(cfg, params, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in flatten_with_paths(params)[0].items()}
    _, treedef = flatten_with_paths(params)
    loss = Model(cfg).loss(treedef.unflatten(leaves), batch)
    return loss, leaves


def _nodes(loss) -> Counter:
    seen, todo, names = set(), [loss.grad_fn], Counter()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names[type(fn).__name__] += 1
        todo += [nxt for nxt, _ in fn.next_functions]
    return names


@pytest.mark.parametrize("arch", ARCHS)
def test_every_span_under_a_profiler(arch):
    """A profiled step records every span of its layers; each ``.bwd`` span
    lies inside ``train_step``, in the store and in the profiler's tree;
    none is left for its parent to close."""
    cfg, state, step = _step(arch)
    _end_the_stretch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch(cfg))
    recs = spans.records()
    names = {r.name for r in recs}
    assert STEP_SPANS | LAYER_SPANS[arch] <= names, names
    assert spans.unclosed() == 0 and all(r.end_ns is not None for r in recs)
    by_id = {r.id: r for r in recs}
    bwd = [r for r in recs if r.name.endswith(".bwd")]
    assert bwd and all("train_step" in _ancestors(r, by_id) for r in bwd)
    assert all(r.device_s is None and r.host_s >= 0 for r in recs)  # no card here
    if arch == "granite-moe-1b-a400m":  # the layer's recomputation runs inside the MoE's backward
        assert any(by_id[r.parent].name == "moe.bwd" for r in recs if r.name == "recompute")
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    assert STEP_SPANS | LAYER_SPANS[arch] <= set(events)
    for name in {r.name for r in bwd}:
        for e in events[name]:
            up, anc = [], e.cpu_parent
            while anc is not None:
                up.append(anc.name)
                anc = anc.cpu_parent
            assert "train_step" in up, (name, up)


@pytest.mark.parametrize("arch", ARCHS)
def test_recording_off_adds_nothing(arch, monkeypatch):
    """With recording off a step keeps the store as it was and opens no
    record (so no CUDA event), and its loss's graph is the graph of the
    program with no backward spans at all. Recorded, the graph holds the
    same nodes and the two markers of each backward span."""
    cfg, state, step = _step(arch)
    batch = _batch(cfg)
    with spans.recording():
        loss_on, _ = _loss_and_grads(cfg, state["params"], batch)
    before = [r.id for r in spans.records()]
    assert before

    def no_record(name):
        raise AssertionError(f"span {name} recorded with recording off")

    with monkeypatch.context() as m:
        m.setattr(spans, "_open", no_record)
        loss_off, _ = _loss_and_grads(cfg, state["params"], batch)
        step(state, batch)
    assert [r.id for r in spans.records()] == before
    with monkeypatch.context() as m:  # the program without backward spans
        m.setattr(spans, "backward_span", lambda name, inputs, fn: fn(*inputs))
        loss_plain, _ = _loss_and_grads(cfg, state["params"], batch)
    on, off = _nodes(loss_on), _nodes(loss_off)
    assert off == _nodes(loss_plain) and not MARKERS & set(off)
    # each output passes through the marker, a layer's unused output too
    # (the recurrence's final state): its nodes are reached, and get no gradient
    assert MARKERS <= set(on) and not off - on


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_bitwise_with_recording_on_and_off(arch):
    cfg, state, step = _step(arch)
    batch = _batch(cfg)
    loss_off, leaves_off = _loss_and_grads(cfg, state["params"], batch)
    grads_off = torch.autograd.grad(loss_off, list(leaves_off.values()), allow_unused=True)
    with spans.recording():
        loss_on, leaves_on = _loss_and_grads(cfg, state["params"], batch)
        grads_on = torch.autograd.grad(loss_on, list(leaves_on.values()), allow_unused=True)
    assert spans.unclosed() == 0 and {"loss_head.bwd"} <= {r.name for r in spans.records()}
    assert torch.equal(loss_on, loss_off)
    for path, a, b in zip(leaves_off, grads_off, grads_on):
        assert (a is None and b is None) or torch.equal(a, b), path


@pytest.mark.parametrize("n_groups", [1, 2])
def test_moe_counters_match_the_assignments(n_groups):
    """``moe.slots`` is every slot the experts compute (X·G·C) and
    ``moe.filled`` those holding a token: the assignments ``_assign`` keeps."""
    cfg = _cfg("granite-moe-1b-a400m")
    gen = torch.Generator().manual_seed(5)
    p = {k: v[0] for k, v in moe_mod.init_moe(gen, cfg, 1, CPU).items()}
    x = torch.randn((4, 24, cfg.d_model), generator=gen).to(torch.bfloat16)
    with spans.recording():
        moe_mod.moe_ffn(p, x, cfg, n_groups=n_groups)
    got = spans.counters()
    t_g = x.shape[0] * x.shape[1] // n_groups
    cap = moe_mod.capacity(t_g, cfg)
    a = moe_mod._assign(x.reshape(n_groups, t_g, -1), p, cfg, cap)
    assert got == {"moe.slots": cfg.n_experts * n_groups * cap, "moe.filled": float(a.keep.sum())}
    assert got["moe.filled"] <= got["moe.slots"]


def test_moe_counters_skip_the_recomputation():
    """A train step counts each layer's slots once: as its forward alone
    does, not again when the checkpoint recomputes the layer."""
    cfg, state, step = _step("granite-moe-1b-a400m")
    batch = _batch(cfg)
    with spans.recording(), torch.no_grad():
        Model(cfg).loss(state["params"], batch, n_groups=1)  # as the step routes
    forward = spans.counters()
    with spans.recording():
        step(state, batch)
    assert spans.counters() == forward and forward["moe.slots"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_span_and_transcripts(arch):
    """The engine's prefill is one span holding its layers' spans; the
    transcripts are the same with recording on and off."""
    prompt = (np.arange(40) * 7 % 200).astype(np.int32)

    def serve(eng):
        state = eng.prefill(prompt, 6)
        while not is_done(state):
            state = eng.decode(state)
        return transcript(state)

    eng = ModelEngine(arch, smoke=True, seed=0, device=CPU)
    off = serve(eng)
    with spans.recording():
        on = serve(eng)
    recs = spans.records()
    pre = [r for r in recs if r.name == "prefill"]
    assert on == off and len(pre) == 1 and pre[0].parent is None
    inner = LAYER_SPANS[arch] - {"moe.bwd", "linear_recurrence.bwd"}
    assert inner <= {r.name for r in recs if r.parent == pre[0].id}
    assert not any(r.name.endswith(".bwd") for r in recs) and spans.unclosed() == 0


def test_the_store_keeps_the_latest_stretch():
    """Each stretch of recording starts a new store; a span decorator opens
    a fresh span each call; parents nest."""

    @spans.span("outer")
    def outer():
        with spans.span("inner"):
            spans.count("n", 2)
            spans.count("n", lambda: torch.tensor(3))

    with spans.recording():
        outer()
        outer()
    recs = spans.records()
    assert [r.name for r in recs] == ["outer", "inner"] * 2
    assert [r.parent for r in recs] == [None, recs[0].id, None, recs[2].id]
    assert spans.counters() == {"n": 10.0}
    outer()  # not recording: the stretch stays
    assert len(spans.records()) == 4
    with profile(activities=[ProfilerActivity.CPU]):
        outer()
    assert [r.name for r in spans.records()] == ["outer", "inner"]
    assert spans.counters() == {"n": 5.0}


def test_a_backward_span_left_open_is_closed_by_its_parent():
    """A backward that stops short of the layer's inputs never fires the
    close: the parent closes the span and counts it."""
    x = torch.randn(4, requires_grad=True)
    with spans.recording(), spans.span("parent"):
        mid = {}

        def layer(t):
            mid["h"] = t * 2
            return mid["h"].tanh()

        y = spans.backward_span("layer", (x,), layer)
        torch.autograd.grad(y.sum(), [mid["h"]])
    names = [(r.name, r.end_ns is not None) for r in spans.records()]
    assert names == [("parent", True), ("layer.bwd", True)] and spans.unclosed() == 1


@pytest.mark.cuda
def test_device_intervals_on_the_card():
    """On the card each span holds a device interval: a step's is positive
    and holds its backward spans'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.optim import AdamWConfig

    dev = torch.device("cuda")
    cfg = _cfg("granite-moe-1b-a400m")
    opt = AdamWConfig()
    state = make_init_fn(cfg, opt, seed=0, device=dev)()
    step = make_train_step(cfg, opt, peak_lr=1e-2, warmup=0, total_steps=4)
    b, _ = TokenPipeline(cfg, 64, 2, seed=3).batch_at({"data_step": 0, "seed": 3})
    batch = batch_to_device(b, dev)
    step(state, batch)  # the kernels built and warm
    with spans.recording():
        step(state, batch)
    torch.cuda.synchronize()
    recs = spans.records()
    whole = next(r for r in recs if r.name == "train_step")
    assert whole.device_s > 0 and spans.unclosed() == 0
    for r in recs:
        assert r.device_s is not None and 0 <= r.device_s <= whole.device_s, r.name
    assert sum(r.device_s for r in recs if r.name == "moe.bwd") > 0
