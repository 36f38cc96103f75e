"""``repro_torch.launch.hlo_stats``: the per-device counts the dry run
stands on, against the JAX package's ``analyze_hlo`` where both count the
same program (``tests/test_hlo_stats.py``'s cases).

The reference recovers a scanned loop's trip count from the HLO; the port
sees every op of a Python loop, so a loop of 8 matmuls counts 8 and the
unrolled form equals the ``unbind`` sweep over a stacked weight. A layer
reads its slice of the stack through a view, so the sweep costs O(1)
passes over the stack in bytes, not O(L). Collectives on a 2-rank gloo
group count once a call with their payload (output) bytes, in-place
``c10d`` ops and functional ones alike, the tensor-parallel steps' own
(``distributed/tp.py``) among them. K3's formula counts 2 (D + Dv) a
visible (q, k) pair, batch row and head (a rank's own heads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.hlo_stats import analyze_hlo
from repro_torch.distributed.group import run_ranks
from repro_torch.kernels.flash_attention.ops import _visible, flash_attention, visible_pairs
from repro_torch.launch.hlo_stats import StepCounter, count

N = 256
ONE = 2 * N**3


def _jax_hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _loop(x, ws=None):
    for i in range(8):
        x = x @ (x if ws is None else ws[i])
    return x


def test_matmul_loop_counts_eight_and_equals_reference():
    """8 matmuls in a Python loop: 8x one matmul's FLOPs, as the
    reference counts its scanned loop (trip count 8)."""
    x = torch.randn(N, N)
    _, r = count(_loop, x)
    assert r["flops"] == 8 * ONE
    a = jax.ShapeDtypeStruct((N, N), jnp.float32)
    ref = analyze_hlo(_jax_hlo(
        lambda v: jax.lax.scan(lambda c, _: (c @ c, None), v, None, length=8)[0], a))
    assert abs(ref["flops"] - r["flops"]) / r["flops"] < 0.01


def test_unrolled_equals_unbind_sweep():
    """Eight separate weights against the ``unbind`` sweep over their (8,
    N, N) stack: equal FLOPs and equal bytes."""
    ws = torch.randn(8, N, N) / N
    x = torch.randn(N, N)
    _, sep = count(_loop, x, [w.clone() for w in ws])
    _, swept = count(_loop, x, ws.unbind(0))
    assert sep["flops"] == swept["flops"] == 8 * ONE
    assert sep["bytes"] == swept["bytes"]


def test_stacked_sweep_bytes_amortized():
    """A tanh(x @ w_i) sweep over a stacked (L, d, d) weight costs a
    handful of passes over the stack, never ~L, and L matmuls' FLOPs: the
    reference's bound on the same program."""
    L, d = 16, 128
    ws = torch.randn(L, d, d)
    x0 = torch.randn(4, d)

    def sweep(x, w):
        for wi in w.unbind(0):
            x = torch.tanh(x @ wi)
        return x

    _, r = count(sweep, x0, ws)
    wbytes = L * d * d * 4
    assert r["bytes"] < 6 * wbytes
    assert r["flops"] == L * 2 * 4 * d * d
    ref = analyze_hlo(_jax_hlo(
        lambda x, w: jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)[0],
        jax.ShapeDtypeStruct((4, d), jnp.float32), jax.ShapeDtypeStruct((L, d, d), jnp.float32)))
    assert ref["bytes"] < 6 * wbytes
    assert abs(ref["flops"] - r["flops"]) / r["flops"] < 0.01


def test_fake_tensors_count_as_real_ones():
    """The dry run counts fake tensors: the same numbers as real ones."""
    ws = torch.randn(8, N, N)
    x = torch.randn(N, N)
    _, real = count(_loop, x, ws.unbind(0))
    with FakeTensorMode() as fm:
        fx, fws = fm.from_tensor(x), fm.from_tensor(ws)
        _, fake = count(_loop, fx, fws.unbind(0))
    assert fake == real


def test_memory_peak_arguments_outputs():
    """Live storages: the argument held from the start, two 1 MiB
    temporaries alive together at the peak, the output the second one."""
    x = torch.zeros(256, 1024)  # 1 MiB

    def step(t):
        y = t * 2
        z = y + 1
        del y
        return z

    c = StepCounter()
    c.hold((x,))
    with c:
        out = step(x)
    mib = 1 << 20
    assert c.memory(out) == {"argument_size_in_bytes": mib, "output_size_in_bytes": mib,
                             "temp_size_in_bytes": mib, "peak_memory_in_bytes": 3 * mib}
    assert c.live_bytes == 2 * mib  # y freed


# (b, h, hkv, sq, sk, d, dv, causal, window)
K3_CASES = [
    (1, 4, 2, 64, 64, 32, 32, True, 0),
    (2, 4, 4, 70, 70, 16, 16, True, 24),
    (1, 2, 1, 40, 96, 32, 32, False, 0),
    (1, 2, 2, 96, 40, 32, 32, True, 0),
    (1, 2, 2, 50, 50, 48, 32, True, 0),
    (3, 2, 1, 33, 33, 16, 16, False, 8),
]


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_flop_formula(case):
    """K3 counts B H visible_pairs 2 (D + Dv) under both counters, the
    visible pairs those the plain version's mask keeps (causal, windowed,
    Sq != Sk both ways, Dv != D); fake tensors count the same."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, sk, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, sk, dv)).astype(np.float32))
    pairs = int(_visible(sq, sk, causal, window, "cpu").sum())
    assert visible_pairs(sq, sk, causal, window) == pairs
    want = b * h * pairs * 2 * (d + dv)
    _, r = count(flash_attention, q, k, v, causal=causal, window=window)
    assert r["flops"] == want
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, k, v, causal=causal, window=window)
    assert fc.get_total_flops() == want
    with FakeTensorMode() as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in (q, k, v))
        out, rf = count(flash_attention, fq, fk, fv, causal=causal, window=window)
    assert rf["flops"] == want and tuple(out.shape) == (b, h, sq, dv)


def _collectives_rank(rank: int) -> dict:
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    x = torch.full((1024,), float(rank + 1))  # 4 KiB
    dt = distribute_tensor(torch.arange(64.0).reshape(8, 8), mesh, [Shard(0)])
    c = StepCounter()
    with c:
        for _ in range(3):
            dist.all_reduce(x)
        g = funcol.all_gather_tensor(x, 0, mesh)  # 8 KiB out
        rs = funcol.reduce_scatter_tensor(x, "sum", 0, mesh)  # 2 KiB out
        a2a = funcol.all_to_all_single(x, None, None, mesh)  # 4 KiB out
        if rank == 0:
            dist.send(x[:256], dst=1)  # 1 KiB
        else:
            dist.recv(x[:256], src=0)
        full = dt.redistribute(mesh, [Replicate()]).to_local()  # 256 B gathered
    return {"result": c.result(), "ok": [float(x[0]), tuple(g.shape), tuple(rs.shape),
                                         tuple(a2a.shape), tuple(full.shape)]}


def test_collectives_counted_per_call_with_payload():
    """On a 2-rank gloo group: three in-place all-reduces of 4 KiB, a
    functional all-gather (8 KiB out) and DTensor's gather of an 8 x 8
    float32 (256 B), a reduce-scatter (2 KiB out), an all-to-all (4 KiB),
    and a 1 KiB send/recv as a collective-permute."""
    ranks = run_ranks(_collectives_rank, 2, timeout_s=120, threads=1)
    kib = 1024
    for r in ranks:
        by = r["result"]["collectives"]["by_kind"]
        assert by["all-reduce"] == {"count": 3, "bytes": 3 * 4 * kib}
        assert by["all-gather"] == {"count": 2, "bytes": 8 * kib + 256}
        assert by["reduce-scatter"] == {"count": 1, "bytes": 2 * kib}
        assert by["all-to-all"] == {"count": 1, "bytes": 4 * kib}
        assert by["collective-permute"] == {"count": 1, "bytes": 1 * kib}
        assert r["result"]["collectives"]["total_count"] == 8
        assert r["ok"][1:] == [(2048,), (512,), (1024,), (8, 8)]
    assert ranks[0]["ok"][0] == 12.0  # 1 + 2, doubled by each all-reduce after the first


def _tp_collectives_rank(rank: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tp

    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    plan = tp.Plan(group=mesh.get_group("model"), size=2, rank=rank, vocab=True, heads=True,
                   kv_heads=True, mlp=True)
    x = torch.full((2, 8, 64), float(rank + 1))  # 4 KiB
    w = torch.ones(64, requires_grad=True)
    c = StepCounter()
    with c:
        s = plan.all_reduce(x)  # 4 KiB
        m = plan.all_reduce(x, "max")  # 4 KiB
        g = plan.all_gather(x, 1)  # 8 KiB out
        rs = plan.reduce_scatter(x, 1)  # 2 KiB out
        y = plan.gather_seq(x * plan.copy_to(w))  # forward: an 8 KiB all-gather
        y.sum().backward()  # a 4 KiB reduce-scatter, then the 256 B all-reduce of w's gradient
        q = torch.randn(1, 3, 16, 8)
        kv = torch.randn(1, 1, 16, 8)
        _, k3 = count(flash_attention, q, kv, kv, causal=True)
    return {"result": c.result(), "k3": k3["flops"],
            "values": [float(s[0, 0, 0]), float(m[0, 0, 0]), tuple(g.shape),
                       float(g[0, 8, 0]), tuple(rs.shape), float(rs[0, 0, 0]),
                       float(w.grad[0])]}


def test_tensor_parallel_collectives_counted():
    """``distributed/tp.py``'s collectives on a 2-rank gloo model axis, each
    counted once a call with its payload (output) bytes: sum and max
    all-reduces, an all-gather and a reduce-scatter along a middle dim, and
    under autograd the sequence gather (forward all-gather, backward
    reduce-scatter) and ``copy_to``'s backward all-reduce; K3 on a rank's 3
    q heads and 1 kv head counts its own heads' pairs."""
    kib = 1024
    for rank, r in enumerate(run_ranks(_tp_collectives_rank, 2, timeout_s=120, threads=1)):
        by = r["result"]["collectives"]["by_kind"]
        assert by["all-reduce"] == {"count": 3, "bytes": 8 * kib + 256}
        assert by["all-gather"] == {"count": 2, "bytes": 16 * kib}
        assert by["reduce-scatter"] == {"count": 2, "bytes": 6 * kib}
        assert r["values"][:5] == [3.0, 2.0, (2, 16, 64), 2.0, (2, 4, 64)]
        assert r["values"][5] == 3.0
        # each element of x * w reaches the sum twice (both ranks' gathers),
        # so w's gradient, summed over both ranks, is 2 * (1 + 2) * 2 * 8
        assert r["values"][6] == 2 * 3 * 16
        assert r["k3"] == 3 * visible_pairs(16, 16, True, 0) * 2 * 16


def _experts_collectives_rank(rank: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import tp

    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    placed = tp.Experts(axes=("data", "model"), rows=2, group=mesh.get_group("data"))
    x = torch.full((2, 4, 64), float(rank + 1), requires_grad=True)  # 2 KiB, 2 blocks
    w = torch.full((3, 8), float(rank + 1), requires_grad=True)  # 96 B
    c = StepCounter()
    with c:
        y = placed.all_to_all(x)  # block d' from row d'
        g = placed.gather(w)  # the rows' w in row order
        (y * torch.tensor([1.0, 2.0])[:, None, None]).sum().backward()
        g.sum().backward()
    return {"result": c.result(),
            "values": [float(y[0, 0, 0]), float(y[1, 0, 0]), float(x.grad[0, 0, 0]),
                       float(x.grad[1, 0, 0]), tuple(g.shape), float(g[3, 0]),
                       float(w.grad[0, 0])]}


def test_expert_collectives_counted():
    """The MoE experts' collectives on a 2-row data axis (gloo), each
    counted by kind with its payload (output) bytes: the dispatch's
    all-to-all of 2 KiB (block ``d'`` to row ``d'``) and, in its backward,
    the reverse one; the column's weight gather (192 B) and its backward
    reduce-scatter (96 B), each row's gradient the rows' sum."""
    for rank, r in enumerate(run_ranks(_experts_collectives_rank, 2, timeout_s=120, threads=1)):
        by = r["result"]["collectives"]["by_kind"]
        assert by["all-to-all"] == {"count": 2, "bytes": 2 * 2048}
        assert by["all-gather"] == {"count": 1, "bytes": 192}
        assert by["reduce-scatter"] == {"count": 1, "bytes": 96}
        # y's block d' came from row d'; x's block d' went to row d', whose
        # gradient there weighs its block r by r + 1
        assert r["values"] == [1.0, 2.0, rank + 1.0, rank + 1.0, (6, 8), 2.0, 2.0]
