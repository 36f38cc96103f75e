"""The port's dry run (``repro_torch.launch.dryrun``), always in a
subprocess: it joins a ``"fake"`` process group, which must never be made
in the pytest process, where other tests make gloo groups.

* Every smoke arch × {train, prefill, decode} on a fake 4×4 mesh (the
  shapes' batches at 256 positions), and qwen3-1.7b's prefill_32k at full
  width on the 16×16 production mesh: each cell ``ok``, with the
  reference's keys and the path its steps took (``tp`` for the dense and
  vlm families, ``gathered`` for the others); long_500k is skipped for a
  full-attention arch. qwen3's smoke train cell with ``--seq-shard``
  traces (its residual stream reduce-scattered and all-gathered along S);
  ``--seq-shard`` raises for deepseek-v3 (MoE and MLA, still gathered).
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
    device: FLOPs and bytes counted, the weights gathered (all-gathers),
    the train step's gradients summed over data (all-reduces), and a peak
    of live memory above the arguments."""
    for shape in KINDS:
        rec = smoke_cells[f"{arch}__{shape}__mesh4x4__smoke__s256.json"]
        assert rec["ok"], rec.get("traceback")
        assert KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
        cfg = get_smoke_config(arch)
        assert rec["path"] == ("tp" if cfg.family in ("dense", "vlm") else "gathered")
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
    head of 16, its 384 of 6,144 FFN units and the whole k/v projection (8
    kv heads do not split 16 ways): ~4.14e13 FLOPs (2 x 65,536 x 28 x
    (2048 x 128 (q) + 2 x 2048 x 1024 (k, v) + 128 x 2048 (o) + 3 x 2048
    x 384 (FFN)) of projections + 28 x 2 x 32,768 x 32,769 / 2 x 512 of
    attention); no weight gathered."""
    _dryrun(tmp_path, "--arch", "qwen3-1.7b", "--shape", "prefill_32k")
    rec = _cells(tmp_path)["qwen3-1.7b__prefill_32k__pod1.json"]
    assert rec["ok"] and (rec["mesh"], rec["chips"]) == ("16x16", 256)
    assert rec["path"] == "tp"
    attention = 1 * 28 * 2 * (32768 * 32769 // 2) * 512
    projections = 2 * 65536 * 28 * (2048 * 128 + 2 * 2048 * 1024 + 128 * 2048 + 3 * 2048 * 384)
    assert rec["hlo"]["flops"] > attention
    assert abs(rec["hlo"]["flops"] - (attention + projections)) / rec["hlo"]["flops"] < 0.02
    # the KV cache a device: 2 sequences, 28 layers, k and v, 32,768 / 16
    # positions of its model rank, 8 heads of 128, bf16
    assert rec["memory"]["output_size_in_bytes"] >= 2 * 28 * 2 * 2048 * 8 * 128 * 2


def test_seq_shard_refused(tmp_path):
    """deepseek-v3's steps gather their weights (its experts and MLA heads
    wait for ROADMAP items 4d and 4e), so ``--seq-shard`` is refused."""
    proc = _dryrun(tmp_path, "--arch", "deepseek-v3-671b", "--shape", "train_4k",
                   "--seq-shard", check=False)
    assert proc.returncode != 0 and "NotImplementedError" in proc.stderr
    assert "tensor-parallel compute" in proc.stderr and "item 4d" in proc.stderr


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
