"""The port's dry run (``repro_torch.launch.dryrun``), always in a
subprocess: it joins a ``"fake"`` process group, which must never be made
in the pytest process, where other tests make gloo groups.

* Every smoke arch × {train, prefill, decode} on a fake 4×4 mesh (the
  shapes' batches at 256 positions), and qwen3-1.7b's prefill_32k at full
  width on the 16×16 production mesh: each cell ``ok``, with the
  reference's keys and the path its steps took (``tp``, every family's);
  long_500k is skipped for a full-attention arch. qwen3's smoke train
  cell with ``--seq-shard`` traces (its residual stream reduce-scattered
  and all-gathered along S), as does deepseek-v3's with
  ``--moe-buf-shard`` too (its expert slots moved by all-to-alls), and
  hymba's and xlstm's with ``--seq-shard``; whisper's with both flags
  counts what its cell without them counts.
* granite's and deepseek's smoke cells against the reference's GSPMD
  program on 1×1, 2×2 (with and without ``moe_buf_shard``), 1×4 and 4×1
  (see ``test_moe_flops_against_the_reference``); hymba's, xlstm's and
  whisper's train and prefill cells on 1×1, 2×2 and 1×4 (see
  ``test_mixer_flops_against_the_reference``).
* Against the reference (``repro.launch.dryrun.build_lowered`` and
  ``analyze_hlo`` on host meshes of 1 and 4 devices), qwen3's smoke
  prefill and decode at B 4, S 64. At 1×1 the port's FLOPs equal the
  reference's within 1 % once each side's attention is taken out by its
  stated formula: the port counts K3's visible (q, k) pairs, S (S + 1) / 2
  a row of the batch and head, 2 (D + Dv) each; the reference's
  ``blockwise_attention`` computes every pair of its q blocks against all
  S keys (one block here: S^2) and masks afterwards. Decode attends over
  the whole cache in both, so its counts compare as they are. At 2×2 both
  split the model axis too (the port's ``tp`` path, GSPMD's program): the
  port's per-device count, its attention taken out the same way (each
  device's batch block and q heads), is within 2 % of the reference's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import run_python
from repro_torch.configs import get_smoke_config, list_archs

REPO = Path(__file__).resolve().parent.parent
KEYS = {"arch", "shape", "mesh", "chips", "params", "active_params", "ok", "trace_s",
        "total_s", "cost", "hlo", "collectives", "memory"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "peak_memory_in_bytes"}
KINDS = ("train_4k", "prefill_32k", "decode_32k")


def _dryrun(out, *args, check=True):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
                           "--out", str(out), *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    if check:
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def _cells(out):
    return {p.name: json.loads(p.read_text()) for p in Path(out).glob("*.json")}


@pytest.fixture(scope="module")
def smoke_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    _dryrun(out, "--smoke", "--mesh", "4x4", "--seq-len", "256")
    return _cells(out)


@pytest.mark.parametrize("arch", list_archs())
def test_every_smoke_cell_traces_on_a_fake_4x4_mesh(smoke_cells, arch):
    """Train, prefill and decode each ``ok`` with the reference's keys, per
    device: FLOPs and bytes counted, all-gathers (a whole kv projection's
    heads, a decode step's q heads, the vocab's logits, the params'
    ``OPT_RULES`` blocks), the train step's gradients summed over data
    (all-reduces), and a peak of live memory above the arguments; the
    ``tp`` path and the experts' axes recorded."""
    for shape in KINDS:
        rec = smoke_cells[f"{arch}__{shape}__mesh4x4__smoke__s256.json"]
        assert rec["ok"], rec.get("traceback")
        assert KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
        cfg = get_smoke_config(arch)
        assert rec["path"] == "tp"
        assert rec["experts"] == (["model"] if cfg.moe else [])  # 8 experts: 16 do not divide
        assert (rec["mesh"], rec["chips"]) == ("4x4", 16)
        assert rec["cost"]["flops"] == rec["hlo"]["flops"] > 0
        assert rec["cost"]["bytes accessed"] == rec["hlo"]["bytes"] > 0
        assert rec["collectives"] == rec["hlo"]["collectives"]
        by = rec["collectives"]["by_kind"]
        assert by["all-gather"]["count"] > 0 and by["all-gather"]["bytes"] > 0
        if shape == "train_4k":
            assert by["all-reduce"]["count"] > 0
        mem = rec["memory"]
        assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"] > 0
    long = smoke_cells[f"{arch}__long_500k__mesh4x4__smoke__s256.json"]
    if get_smoke_config(arch).sub_quadratic:
        assert long["ok"], long.get("traceback")
    else:
        assert "long_500k needs sub-quadratic attention" in long["skipped"]


def test_full_width_prefill_cell_on_the_production_mesh(tmp_path):
    """qwen3-1.7b's prefill_32k on 16×16: 2 sequences of 32,768 tokens a
    device through all 28 layers on the ``tp`` path, each device its 1 q
    head of 16, its 384 of 6,144 FFN units and the one kv head its q head
    reads (8 kv heads do not split 16 ways): ~2.79e13 FLOPs (2 x 65,536 x
    28 x (2048 x 128 (q) + 2 x 2048 x 128 (k, v) + 128 x 2048 (o) + 3 x
    2048 x 384 (FFN)) of projections + 28 x 2 x 32,768 x 32,769 / 2 x 512
    of attention); no weight gathered."""
    _dryrun(tmp_path, "--arch", "qwen3-1.7b", "--shape", "prefill_32k")
    rec = _cells(tmp_path)["qwen3-1.7b__prefill_32k__pod1.json"]
    assert rec["ok"] and (rec["mesh"], rec["chips"]) == ("16x16", 256)
    assert rec["path"] == "tp"
    attention = 1 * 28 * 2 * (32768 * 32769 // 2) * 512
    projections = 2 * 65536 * 28 * (2048 * 128 + 2 * 2048 * 128 + 128 * 2048 + 3 * 2048 * 384)
    assert rec["hlo"]["flops"] > attention
    assert abs(rec["hlo"]["flops"] - (attention + projections)) / rec["hlo"]["flops"] < 0.02
    # the KV cache a device: 2 sequences, 28 layers, k and v, 32,768 / 16
    # positions of its model rank, 8 heads of 128, bf16
    assert rec["memory"]["output_size_in_bytes"] >= 2 * 28 * 2 * 2048 * 8 * 128 * 2


def test_seq_shard_refused(tmp_path):
    """(Named when the hybrid, mLSTM and encoder–decoder families refused
    the flags, until ROADMAP items 4f and 4g.) Their smoke train cells take
    them on a fake 2×2 mesh: hymba's and xlstm's with ``--seq-shard``
    (``__seqshard``) ``ok`` on the ``tp`` path, the residual stream
    leaving each layer reduce-scattered along S; whisper's with
    ``--seq-shard --moe-buf-shard`` (``__seqshard__moebuf``) counts the
    FLOPs and collectives of its cell without them (the reference's
    encoder–decoder constrains no stream and has no MoE buffer)."""
    common = ("--smoke", "--mesh", "2x2", "--seq-len", "64", "--shape", "train_4k")
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        _dryrun(tmp_path, *common, "--arch", arch, "--seq-shard")
    _dryrun(tmp_path, *common, "--arch", "whisper-tiny")
    _dryrun(tmp_path, *common, "--arch", "whisper-tiny", "--seq-shard", "--moe-buf-shard")
    cells = _cells(tmp_path)
    for arch in ("hymba-1.5b", "xlstm-1.3b"):
        rec = cells[f"{arch}__train_4k__mesh2x2__smoke__s64__seqshard.json"]
        assert rec["ok"] and rec["path"] == "tp" and rec["seq_shard"], rec.get("traceback")
        n_layers = get_smoke_config(arch).n_layers
        assert rec["collectives"]["by_kind"]["reduce-scatter"]["count"] >= n_layers
    plain = cells["whisper-tiny__train_4k__mesh2x2__smoke__s64.json"]
    rec = cells["whisper-tiny__train_4k__mesh2x2__smoke__s64__seqshard__moebuf.json"]
    assert rec["ok"] and rec["path"] == "tp", rec.get("traceback")
    assert rec["seq_shard"] and rec["moe_buf_shard"] and not plain["seq_shard"]
    assert rec["cost"]["flops"] == plain["cost"]["flops"]
    assert rec["collectives"] == plain["collectives"]


def test_moe_buf_shard_train_cell_on_a_fake_2x4_mesh(tmp_path):
    """deepseek-v3's smoke train cell with ``--moe-buf-shard --seq-shard``
    on a fake 2×4 mesh: ``ok`` on the ``tp`` path, its file named
    ``__seqshard__moebuf``, its 8 experts over (data, model) and their slots
    moved by all-to-alls (two a MoE layer in the forward, again in its
    recompute, and the backward's two), where the cell without the flag
    moves none and gathers each column's expert weights; both compute the
    same products."""
    for flags in ((), ("--moe-buf-shard",)):
        _dryrun(tmp_path, "--smoke", "--mesh", "2x4", "--seq-len", "256", "--arch",
                "deepseek-v3-671b", "--shape", "train_4k", "--seq-shard", *flags)
    cells = _cells(tmp_path)
    plain = cells["deepseek-v3-671b__train_4k__mesh2x4__smoke__s256__seqshard.json"]
    rec = cells["deepseek-v3-671b__train_4k__mesh2x4__smoke__s256__seqshard__moebuf.json"]
    assert rec["ok"] and rec["path"] == "tp" and rec["seq_shard"], rec.get("traceback")
    assert rec["moe_buf_shard"] and not plain["moe_buf_shard"]
    assert rec["experts"] == plain["experts"] == ["data", "model"]
    n_moe = get_smoke_config("deepseek-v3-671b").n_layers - 1
    assert rec["collectives"]["by_kind"]["all-to-all"]["count"] == 6 * n_moe
    assert "all-to-all" not in plain["collectives"]["by_kind"]
    assert rec["cost"]["flops"] == pytest.approx(plain["cost"]["flops"], rel=1e-9)


def test_seq_shard_train_cell_on_a_fake_4x4_mesh(tmp_path):
    """qwen3's smoke train cell with ``--seq-shard`` on a fake 4×4 mesh:
    ``ok`` on the ``tp`` path, its file named ``__seqshard``; the residual
    stream leaves each layer's attention and FFN reduce-scattered along S
    (two a layer and the loss's all-gather), and its per-device FLOPs are
    those of the cell without it (the same products, split another way)."""
    _dryrun(tmp_path, "--smoke", "--mesh", "4x4", "--seq-len", "256", "--arch", "qwen3-1.7b",
            "--shape", "train_4k")
    _dryrun(tmp_path, "--smoke", "--mesh", "4x4", "--seq-len", "256", "--arch", "qwen3-1.7b",
            "--shape", "train_4k", "--seq-shard")
    cells = _cells(tmp_path)
    plain = cells["qwen3-1.7b__train_4k__mesh4x4__smoke__s256.json"]
    rec = cells["qwen3-1.7b__train_4k__mesh4x4__smoke__s256__seqshard.json"]
    assert rec["ok"] and rec["path"] == "tp" and rec["seq_shard"], rec.get("traceback")
    assert "reduce-scatter" not in plain["collectives"]["by_kind"]
    n_layers = get_smoke_config("qwen3-1.7b").n_layers
    # forward, its recomputation in the backward, and the backward's all-gathers
    assert rec["collectives"]["by_kind"]["reduce-scatter"]["count"] >= 2 * n_layers
    assert rec["cost"]["flops"] == pytest.approx(plain["cost"]["flops"], rel=1e-9)


S, B = 64, 4

PORT = r"""
import json
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import join_fake_group, trace_cell
from repro_torch.launch.mesh import make_mesh

cfg = get_smoke_config("qwen3-1.7b")
out = {}
for dims in ((1, 1), (2, 2)):
    join_fake_group(dims[0] * dims[1])
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    for kind in ("prefill", "decode"):
        rec = trace_cell(cfg, InputShape(kind, __S__, __B__, kind), mesh, "cpu")
        out[f"{kind}_{dims[0]}x{dims[1]}"] = rec["hlo"]["flops"]
print("FLOPS", json.dumps(out))
"""

REFERENCE = r"""
import json
from repro.launch.dryrun import build_lowered  # sets 512 host devices before jax starts
import jax
from repro.configs import get_smoke_config
from repro.configs.base import InputShape
from repro.launch.hlo_stats import analyze_hlo

cfg = get_smoke_config("qwen3-1.7b")
out = {}
for dims in ((1, 1), (2, 2)):
    mesh = jax.make_mesh(dims, ("data", "model"))
    for kind in ("prefill", "decode"):
        lowered = build_lowered(cfg, InputShape(kind, __S__, __B__, kind), mesh)
        out[f"{kind}_{dims[0]}x{dims[1]}"] = analyze_hlo(lowered.compile().as_text())["flops"]
print("FLOPS", json.dumps(out))
"""


def _flops(stdout):
    return json.loads(next(ln for ln in stdout.splitlines() if ln.startswith("FLOPS"))[6:])


def test_flops_against_the_reference():
    port, ref = (_flops(run_python(code.replace("__S__", str(S)).replace("__B__", str(B)),
                                   timeout=240)) for code in (PORT, REFERENCE))
    cfg = get_smoke_config("qwen3-1.7b")
    per_pair = 2 * 2 * cfg.resolved_head_dim * cfg.n_heads * B * cfg.n_layers  # 2 (D + Dv)
    port_attention = per_pair * S * (S + 1) // 2
    ref_attention = per_pair * S * S
    rest = port["prefill_1x1"] - port_attention
    assert abs(rest - (ref["prefill_1x1"] - ref_attention)) / rest < 0.01, (port, ref)
    assert abs(port["decode_1x1"] - ref["decode_1x1"]) / ref["decode_1x1"] < 0.01, (port, ref)
    # 2x2: each device its batch block (B / 2) and its q heads (H / 2)
    rest = port["prefill_2x2"] - port_attention / 4
    assert abs(rest - (ref["prefill_2x2"] - ref_attention / 4)) / rest < 0.02, (port, ref)
    assert abs(port["decode_2x2"] - ref["decode_2x2"]) / ref["decode_2x2"] < 0.02, (port, ref)
    for kind in ("prefill", "decode"):
        assert abs(ref[f"{kind}_2x2"] * 4 / ref[f"{kind}_1x1"] - 1) < 0.01, ref


# ---------------------------------------------------------------------------
# the MoE family on its shards: per-device FLOPs against GSPMD's program
# ---------------------------------------------------------------------------

# (arch, kind, mesh, moe_buf_shard): the smoke cells of granite-moe-1b-a400m
# (GQA + MoE) and deepseek-v3-671b (MLA + MoE) at S 64, B 8
MOE_CELLS = ([("granite-moe-1b-a400m", k, m, False)
              for k in ("train", "prefill") for m in ((1, 1), (2, 2), (1, 4), (4, 1))]
             + [("granite-moe-1b-a400m", "train", (2, 2), True)]
             + [("deepseek-v3-671b", k, m, False) for k in ("train", "prefill")
                for m in ((1, 1), (2, 2))]
             + [("deepseek-v3-671b", "train", (2, 2), True)])

SHARDED_PORT = r"""
import json
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import join_fake_group, trace_cell
from repro_torch.launch.mesh import make_mesh

out = {}
for arch, kind, dims, flag in __CELLS__:
    join_fake_group(dims[0] * dims[1])
    mesh = make_mesh(tuple(dims), ("data", "model"), "cpu")
    rec = trace_cell(get_smoke_config(arch), InputShape(kind, __S__, __B__, kind), mesh, "cpu",
                     moe_buf_shard=flag)
    out[f"{arch} {kind} {dims[0]}x{dims[1]} {int(flag)}"] = {
        "flops": rec["hlo"]["flops"], "path": rec["path"], "experts": rec["experts"],
        "all_to_all": rec["hlo"]["collectives"]["by_kind"].get("all-to-all", {}).get("count", 0),
        "mm": rec["flops_by_op"].get("aten.mm", 0)}
print("FLOPS", json.dumps(out))
"""

# The reference's compiled program on meshes with Auto axes (jax.make_mesh's
# default Explicit axes refuse its moe_buf constraint), its dots' FLOPs
# split by the einsum their metadata names: attention (blockwise
# attention's einsums, and the dots XLA left without a name: its rewritten
# attention and recurrence loops'), the chunked recurrence's einsums, the
# loss's unembedding, the expert products over all X experts (a device's
# whole group through every expert) and the rest.
SHARDED_REFERENCE = r"""
import collections, json, re
from repro.launch.dryrun import build_lowered  # sets 512 host devices before jax starts
import jax
from repro.configs import get_smoke_config
from repro.configs.base import InputShape
from repro.launch.hlo_stats import analyze_hlo, parse_hlo


def parts(text, n_experts):
    comps, entry = parse_hlo(text)
    label = {}
    for line in text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%([\w.\-]+)\s*=.* dot\(", line)
        if m:
            on = re.search(r'op_name="([^"]*)"', line)
            label[m.group(1)] = on.group(1) if on else ""
    mult = collections.Counter()

    def walk(c, k):
        mult[c] += k
        for callee, n, _ in comps[c].calls:
            if callee in comps:
                walk(callee, k * n)

    walk(entry, 1)
    out = collections.Counter()
    for name, c in comps.items():
        for o in c.ops if mult[name] else ():
            if o.op != "dot":
                continue
            lhs = c.defs[o.refs[0]]
            k = 1
            for i in re.search(r"lhs_contracting_dims=\{([\d,]*)\}", o.rhs).group(1).split(","):
                k *= lhs.out_dims[int(i)] if i else 1
            n = 1
            for d in o.out_dims:
                n *= d
            on = label.get(o.name, "")
            if not on or "bqkgd" in on or "bkgqt" in on:
                part = "attention"
            elif "...e,ve->...v" in on:
                part = "loss"
            elif any(e in on for e in ("bihn,bjhn", "bhij,bjhp", "bihn,bhnp", "bjhn,bjhp")):
                part = "recurrence"
            elif ("xce," in on or "xcf," in on) and o.out_dims[0] == n_experts:
                part = "experts_whole"
            else:
                part = "rest"
            out[part] += 2 * n * k * mult[name]
    return dict(out)


out = {}
for arch, kind, dims, flag in __CELLS__:
    cfg = get_smoke_config(arch)
    mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    text = build_lowered(cfg, InputShape(kind, __S__, __B__, kind), mesh,
                         opts={"moe_buf_shard": flag}).compile().as_text()
    out[f"{arch} {kind} {dims[0]}x{dims[1]} {int(flag)}"] = {
        "flops": analyze_hlo(text)["flops"], **parts(text, cfg.n_experts)}
print("FLOPS", json.dumps(out))
"""


# (arch, kind, mesh, moe_buf_shard) at S 64, B 8: hymba's 4 q / 2 kv heads
# and its SSD's 4, xlstm's 2 mLSTM heads, whisper's 4 (encoder 64 frames),
# each split 2 and (but xlstm's, whole) 4 ways, their MLPs and vocabs too
MIXER_CELLS = [(a, k, m, False) for a in ("hymba-1.5b", "xlstm-1.3b", "whisper-tiny")
               for k in ("train", "prefill") for m in ((1, 1), (2, 2), (1, 4))]


@pytest.fixture(scope="module")
def sharded_flops():
    """``(port, reference)``: each of :data:`MOE_CELLS`' and
    :data:`MIXER_CELLS`' per-device counts, the port's trace
    (:data:`SHARDED_PORT`) and GSPMD's program (:data:`SHARDED_REFERENCE`)
    at S 64, B 8, the two subprocesses at once."""
    from concurrent.futures import ThreadPoolExecutor

    cells = repr([(a, k, list(m), f) for a, k, m, f in MOE_CELLS + MIXER_CELLS])
    codes = [code.replace("__CELLS__", cells).replace("__S__", str(S))
             .replace("__B__", str(2 * B)) for code in (SHARDED_PORT, SHARDED_REFERENCE)]
    with ThreadPoolExecutor(2) as pool:
        outs = list(pool.map(lambda code: run_python(code, timeout=600), codes))
    return tuple(_flops(out) for out in outs)


def _port_terms(arch, kind, dims):
    """The port's attention (K3's visible pairs, twice in a train step with
    the remat recompute, and its backward operator's 2 (4 D + 3 Dv) a
    visible pair), its
    loss's unembedding (4 passes of a train step: forward, the chunk's
    recompute, the two gradients) and the whole weights' gradients GSPMD
    splits over the model ranks (see the test)."""
    cfg = get_smoke_config(arch)
    d_, m_ = dims
    s, b = S, 2 * B // d_
    h = cfg.n_heads // m_
    d = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.mla else cfg.resolved_head_dim
    dv = cfg.v_head_dim if cfg.mla else cfg.resolved_head_dim
    pairs = s * (s + 1) // 2
    per = b * h * cfg.n_layers
    if kind == "prefill":
        return per * 2 * (d + dv) * pairs, 0, 0
    attention = per * (2 * 2 * (d + dv) * pairs + 2 * (4 * d + 3 * dv) * pairs)
    loss = 4 * 2 * b * s * cfg.d_model * cfg.vocab // m_
    t, e = b * s, cfg.d_model
    if cfg.mla:  # wq_a and wkv_a, every layer
        split = cfg.n_layers * 2 * t * e * (cfg.q_lora_rank + cfg.kv_lora_rank + cfg.qk_rope_dim)
        share = m_
    else:  # wk and wv where several ranks' q heads read one kv head
        share = m_ // cfg.n_kv_heads if m_ > cfg.n_kv_heads else 1
        split = cfg.n_layers * 2 * 2 * t * e * cfg.resolved_head_dim * max(1, cfg.n_kv_heads // m_)
    return attention, loss, split * (1 - 1 / share)


@pytest.mark.parametrize("arch,kind,dims,flag", MOE_CELLS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_moe_flops_against_the_reference(sharded_flops, arch, kind, dims, flag):
    """granite's and deepseek's smoke cells on the ``tp`` path: the port's
    per-device FLOPs (its fake-group trace) within 2 % of the reference's
    compiled program on the same mesh (``analyze_hlo``), each side's
    attention taken out by its own count, as ``test_flops_against_the_reference``
    does (the port's K3 counts visible pairs, twice in a train step, and
    its backward operator 2 (4 D + 3 Dv) a visible pair; blockwise
    attention computes every pair, 4 to 4.5 times in a train step by XLA's
    rewrites). In a train
    step three more differences of schedule are taken out, each counted
    on its own side:

    * the loss: the port's chunked unembedding runs 4 passes (forward,
      the chunk's recompute, two gradients), the reference's 3 (XLA
      shares the forward with the recompute);
    * on 2×2 GSPMD's backward gathers every expert weight and recomputes
      and differentiates each device's group through all X experts (its
      dots over X experts: twice a device's expert-parallel share, the
      model ranks repeating each other; with ``moe_buf_shard`` one such
      dot of nine remains); the port keeps the forward's expert-parallel
      program, so the reference is held less that repeated half;
    * GSPMD computes the gradient of a whole weight that the model ranks
      use on their own parts of the work (MLA's ``wq_a`` and ``wkv_a``; ``wk``
      and ``wv`` where two ranks' q heads read one kv head) as its share of
      the rows on each rank after summing the activation gradient; the port
      computes each rank's partial gradient whole and all-reduces it
      (Megatron's f), so it is held less the other ranks' share.

    Every cell records the ``tp`` path and the experts' axes; the
    expert-parallel cells over data move tokens by all-to-alls (prefill,
    and train with ``moe_buf_shard``)."""
    port, ref = sharded_flops
    key = f"{arch} {kind} {dims[0]}x{dims[1]} {int(flag)}"
    p, r = port[key], ref[key]
    assert p["path"] == "tp" and p["experts"] == ([] if dims == (1, 1) else ["data", "model"]), p
    if dims[0] > 1 and (kind == "prefill" or flag):
        assert p["all_to_all"] > 0, p
    attention, loss, split = _port_terms(arch, kind, dims)
    mine = p["flops"] - attention - loss - split
    theirs = r["flops"] - r.get("attention", 0) - (r.get("loss", 0) if kind == "train" else 0)
    theirs -= r.get("experts_whole", 0) * (1 - 1 / dims[1])
    assert abs(mine - theirs) / theirs < 0.02, (key, mine, theirs, p, r)


# ---------------------------------------------------------------------------
# the hybrid, mLSTM and encoder-decoder families on their shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,dims,flag", MIXER_CELLS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_mixer_flops_against_the_reference(sharded_flops, arch, kind, dims, flag):
    """hymba's, xlstm's and whisper's smoke cells on the ``tp`` path: the
    port's per-device FLOPs within 2 % of the reference's compiled program
    on the same mesh once each side's attention and chunked recurrence are
    taken out by its own count, as ``test_moe_flops_against_the_reference``
    takes out attention: the port's K3 ops (forward and backward) and its
    batched products (the recurrence's einsums, every chunk at once), the
    reference's attention and recurrence einsums and the dots
    XLA left unnamed. The recurrence's schedule differs: the reference
    checkpoints each chunk inside its scan (a train step recomputes it
    within the layer's own recompute), the port computes every chunk at
    once and recomputes the layer. What is left, the projections, the MLPs
    and the loss, is split as GSPMD splits it, less the two differences
    of schedule ``test_moe_flops_against_the_reference`` names (the
    loss's fourth pass, and the gradient of a whole kv projection two
    ranks' q heads read: hymba's 2 kv heads on 1×4) and a third: where a
    mixer's heads stay whole (xlstm's 2 on 1×4, as its 4 and hymba's 25
    on 16), both run its forward whole on every model rank, but GSPMD
    splits its recompute by the projections' output columns and its
    weights' gradients by their rows over the model ranks (about half
    the port's per-device count here), while the port repeats them whole
    on every rank: that cell is held to the reference's whole program
    (its 1×1 count) and GSPMD's own count is below it."""
    port, ref = sharded_flops
    key = f"{arch} {kind} {dims[0]}x{dims[1]} {int(flag)}"
    p, r = port[key], ref[key]
    assert p["path"] == "tp" and p["experts"] == [], p
    _, loss, split = _port_terms(arch, kind, dims)
    mine = p["mm"] - loss - (split if arch == "hymba-1.5b" else 0)
    theirs = r.get("rest", 0) + (r.get("loss", 0) if kind == "prefill" else 0)
    cfg = get_smoke_config(arch)
    if kind == "train" and cfg.n_heads % dims[1]:  # the heads stay whole
        assert r["rest"] < 0.6 * mine, (key, mine, r)
        theirs = ref[f"{arch} train 1x1 0"]["rest"]
    assert abs(mine - theirs) / theirs < 0.02, (key, mine, theirs, p, r)
    if kind == "prefill" and dims[1] > 1 and not cfg.mlstm:  # each rank's cache block
        assert p["all_to_all"] > 0, p
