"""The port's stream half of the chunk engine, held against the JAX package.

For the same trees (float32, float64, bfloat16, integer, bool, 0-d and
empty leaves) made with numpy from a seed, ``repro_torch``'s
``state_stream_meta`` equals the reference's JSON and its chunk grid (path,
slice, blake2b digest, CRC) equals the reference's ``iter_state_chunks``,
because the two packages speak one wire. Chunks cross between the packages
in both directions, over a socket pair, bit-identically. The rest ports the
in-process cases of ``tests/test_stream.py``: assembler roundtrip, delta,
``changed_hint``, CRC and coverage rejection, compressed and dup frames.
"""

import json
import os
import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.fabric import stream as jstream
from repro.fabric import wire as jwire
from repro_torch.checkpoint.serializer import (
    StateAssembler,
    StreamStateError,
    assemble_state_chunks,
    bslice_key,
    iter_state_chunks,
    state_stream_meta,
)
from repro_torch.core.delta import device_changed_hints
from repro_torch.fabric import stream, wire
from repro_torch.utils import flatten_with_paths, from_numpy_tree


def _np_tree(seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((300, 40)).astype(np.float32),
        "d": rng.standard_normal((37, 5)),
        "bf": rng.standard_normal((130, 24)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "nested": {"b": np.arange(17, dtype=np.int64), "z": np.float64(2.5) * np.ones(()),
                   "i": rng.integers(-9, 9, (64, 3)).astype(np.int32)},
        "mask": rng.standard_normal(333) > 0,
        "empty": np.zeros((0, 4), np.float32),
        "scalars": {"n": 3, "s": "hi", "t": (1, [2, None])},
    }


def _bytes(x) -> bytes:
    """Raw bytes of a tensor (bf16 through its int16 view) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _assert_same_tree(got, want):
    g, _ = flatten_with_paths(got)
    w, _ = flatten_with_paths(want)
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            assert tuple(g[k].shape) == tuple(v.shape), k
            assert _bytes(g[k]) == _bytes(v), k
        else:
            assert g[k] == v, k


def _grid(chunks) -> list:
    return [(c.path, bslice_key(c.slice), c.hash, c.crc32, c.nbytes, c.ref) for c in chunks]


# ---------------------------------------------------------------------------
# one wire: the meta and the chunk grid equal the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 11])
def test_stream_meta_equals_reference_json(seed):
    tree = _np_tree(seed)
    mine = state_stream_meta(from_numpy_tree(tree, "cpu"))
    ref = jser.state_stream_meta(tree)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert mine["arrays"]["bf"]["dtype"] == "bfloat16"
    assert mine["arrays"]["mask"]["dtype"] == "bool"


@pytest.mark.parametrize("chunk_bytes", [64, 4096, 1 << 20])
def test_chunk_grid_equals_reference(chunk_bytes):
    tree = _np_tree()
    mine = list(iter_state_chunks(from_numpy_tree(tree, "cpu"), chunk_bytes=chunk_bytes))
    ref = list(jser.iter_state_chunks(tree, chunk_bytes=chunk_bytes))
    assert _grid(mine) == _grid(ref)
    assert [bytes(c.data) for c in mine] == [bytes(c.data) for c in ref]


def test_delta_grid_equals_reference():
    """Against one baseline, the port and the reference ref the same chunks."""
    tree = _np_tree()
    baseline = {(c.path, bslice_key(c.slice)): c.hash
                for c in jser.iter_state_chunks(tree, chunk_bytes=4096)}
    tree2 = {**tree, "w": tree["w"].copy(), "bf": tree["bf"].copy()}
    tree2["w"][:30] += 1.0
    tree2["bf"][-3:] = tree2["bf"][-3:] * 2
    mine = list(iter_state_chunks(from_numpy_tree(tree2, "cpu"), chunk_bytes=4096,
                                  baseline=baseline))
    ref = list(jser.iter_state_chunks(tree2, chunk_bytes=4096, baseline=baseline))
    assert _grid(mine) == _grid(ref)
    assert 0 < sum(not c.ref for c in mine) < len(mine) / 2


def _pump(sender, receiver, state, *, codec=None, dedup=False, chunk_bytes=4096,
          meta_fn=None, arm=None):
    """``sender.pump_state_chunks`` -> ``receiver.receive_state_stream`` over
    a socket pair (each side the package's own module)."""
    a, b = socket.socketpair()
    reader = receiver.wire.FrameReader(b)
    stats = {}

    def send():
        try:
            _grid_, n, n_data, sent = sender.pump_state_chunks(
                a, state, chunk_bytes=chunk_bytes, codec=codec, dedup=dedup)
            stats.update(chunks=n, data=n_data, sent_bytes=sent)
        finally:
            a.close()

    t = threading.Thread(target=send)
    t.start()
    try:
        kwargs = {"meta": meta_fn(state), "step": 3}
        where = {"device": "cpu"} if receiver is stream else {}  # the port's default is the card
        if arm is not None:
            from repro_torch.chaos import faults

            with faults.arm(arm):
                return receiver.receive_state_stream(reader, kwargs, **where), stats
        return receiver.receive_state_stream(reader, kwargs, **where), stats
    finally:
        t.join()
        b.close()


@pytest.mark.parametrize("codec,dedup", [(None, False), ("zlib", True)])
def test_reference_sender_to_port_receiver_bit_identical(codec, dedup):
    tree = _np_tree()
    (got, step, grid, counters), stats = _pump(
        jstream, stream, tree, codec=codec, dedup=dedup, meta_fn=jser.state_stream_meta)
    assert step == 3 and counters["chunks"] == stats["chunks"] == len(grid)
    # the receiver counts the payload chunks and bytes the sender counted
    assert (counters["data_chunks"], counters["bytes"]) == (stats["data"], stats["sent_bytes"])
    assert got["bf"].dtype == torch.bfloat16 and got["mask"].dtype == torch.bool
    assert got["nested"]["z"].shape == () and tuple(got["empty"].shape) == (0, 4)
    _assert_same_tree(got, tree)


@pytest.mark.parametrize("codec,dedup", [(None, False), ("zlib", True)])
def test_port_sender_to_reference_receiver_bit_identical(codec, dedup):
    tree = _np_tree()
    state = from_numpy_tree(tree, "cpu")
    (got, step, grid, _), stats = _pump(
        stream, jstream, state, codec=codec, dedup=dedup, meta_fn=state_stream_meta)
    assert step == 3 and stats["chunks"] == len(grid)
    assert got["bf"].dtype == ml_dtypes.bfloat16
    _assert_same_tree(got, tree)


# ---------------------------------------------------------------------------
# the chunk engine's receiving half (tests/test_stream.py, ported)
# ---------------------------------------------------------------------------


def _tree():
    return from_numpy_tree(_np_tree(), "cpu")


def test_iter_assemble_roundtrip_bit_identical():
    tree = _tree()
    meta = state_stream_meta(tree)
    chunks = list(iter_state_chunks(tree, chunk_bytes=4096))
    assert [c.seq for c in chunks] == list(range(len(chunks)))  # ordered
    out, grid = assemble_state_chunks(meta, chunks)
    _assert_same_tree(out, tree)
    assert out["scalars"] == {"n": 3, "s": "hi", "t": (1, [2, None])}
    assert len(grid) == len(chunks)


def test_delta_stream_sends_only_changed_chunks():
    tree = _tree()
    first = list(iter_state_chunks(tree, chunk_bytes=4096))
    baseline_state, grid = assemble_state_chunks(state_stream_meta(tree), first)
    sender_grid = {(c.path, bslice_key(c.slice)): c.hash for c in first}

    tree2 = {**tree, "w": tree["w"].clone()}
    tree2["w"][:30] += 1.0  # rows 0-29: two 4 KiB chunks of 25 rows
    second = list(iter_state_chunks(tree2, chunk_bytes=4096, baseline=sender_grid))
    data = [c for c in second if not c.ref]
    refs = [c for c in second if c.ref]
    assert refs and len(data) < len(second) / 2
    assert all(c.data is None for c in refs)

    out, _ = assemble_state_chunks(
        state_stream_meta(tree2), second, baseline=baseline_state, baseline_grid=grid
    )
    _assert_same_tree(out, tree2)


def test_changed_hint_skips_hashing_entirely():
    """K1's hints (its plain version on the CPU) excuse unchanged chunks from
    the host copy and the hash: they ride as refs with the baseline's hash."""
    tree = _tree()
    first = list(iter_state_chunks(tree, chunk_bytes=4096))
    sender_grid = {(c.path, bslice_key(c.slice)): c.hash for c in first}
    n_w = sum(1 for c in first if c.path == "w")
    tree2 = {**tree, "w": tree["w"].clone()}
    tree2["w"][:5] += 1.0
    hints = device_changed_hints(tree, tree2, chunk_bytes=4096)
    assert hints["w"].tolist() == [True] + [False] * (n_w - 1)
    chunks = list(iter_state_chunks(tree2, chunk_bytes=4096, baseline=sender_grid,
                                    changed_hint=hints))
    hinted_refs = [c for c in chunks if c.ref and c.crc32 is None]
    assert len(hinted_refs) == len(chunks) - 1  # every unchanged chunk, all leaves
    assert all(sender_grid[(c.path, bslice_key(c.slice))] == c.hash for c in hinted_refs)
    baseline_state, grid = assemble_state_chunks(state_stream_meta(tree), first)
    out, _ = assemble_state_chunks(state_stream_meta(tree2), chunks,
                                   baseline=baseline_state, baseline_grid=grid)
    _assert_same_tree(out, tree2)


def test_assembler_rejects_bad_crc_and_partial_coverage():
    tree = {"x": torch.arange(100, dtype=torch.float32)}
    meta = state_stream_meta(tree)
    chunks = list(iter_state_chunks(tree, chunk_bytes=64))
    asm = StateAssembler(meta)
    ch = chunks[0]
    with pytest.raises(StreamStateError, match="CRC"):
        asm.put(ch.path, ch.slice, b"\x00" * ch.nbytes, crc32=ch.crc32, hash=ch.hash)
    # drop one chunk -> finish() must refuse the torn state
    asm2 = StateAssembler(meta)
    for ch in chunks[:-1]:
        asm2.put(ch.path, ch.slice, ch.data, crc32=ch.crc32, hash=ch.hash, ref=ch.ref)
    with pytest.raises(StreamStateError, match="cover"):
        asm2.finish()


def test_assembler_ref_without_baseline_fails():
    tree = {"x": torch.arange(100, dtype=torch.float32)}
    chunks = list(iter_state_chunks(tree, chunk_bytes=64))
    asm = StateAssembler(state_stream_meta(tree))
    with pytest.raises(StreamStateError, match="baseline"):
        asm.put(chunks[0].path, chunks[0].slice, ref=True, hash=chunks[0].hash)


def test_assembler_ref_with_mismatched_baseline_hash_fails():
    tree = {"x": torch.arange(100, dtype=torch.float32)}
    chunks = list(iter_state_chunks(tree, chunk_bytes=64))
    base, grid = assemble_state_chunks(state_stream_meta(tree), chunks)
    asm = StateAssembler(state_stream_meta(tree), baseline=base, baseline_grid=grid)
    with pytest.raises(StreamStateError, match="baseline hash"):
        asm.put(chunks[0].path, chunks[0].slice, ref=True, hash="0" * 32)


def test_dup_chunks_resolve_across_dtypes_and_from_the_baseline():
    """A dup names bytes by digest: they may sit in another leaf of another
    dtype, or in the baseline; the assembler copies them after the upload."""
    row = torch.arange(256, dtype=torch.float32)
    tree = {"a": row.clone().reshape(1, 256), "b": row.clone().view(torch.int32).reshape(1, 256)}
    chunks = list(iter_state_chunks(tree, chunk_bytes=1024, have_digest=set().__contains__))
    assert not any(c.dup for c in chunks)
    held = {chunks[0].hash}
    dedup = list(iter_state_chunks(tree, chunk_bytes=1024, have_digest=held.__contains__))
    assert [c.dup for c in dedup] == [True, True]  # both leaves: the same bytes
    base, grid = assemble_state_chunks(state_stream_meta(tree), chunks)
    out, _ = assemble_state_chunks(state_stream_meta(tree), dedup, baseline=base,
                                   baseline_grid=grid)
    _assert_same_tree(out, tree)


def test_compressed_dedup_stream_roundtrip_bit_identical():
    """Repeated-content chunks ride as payload-free dup frames and the rest
    compresses: the wire carries a fraction of the state, bit-identically."""
    row = torch.arange(512, dtype=torch.float64)
    state = {"w": row.repeat(32, 1), "n": 5}  # 32 identical 4 KiB chunks
    (got, step, grid, counters), stats = _pump(
        stream, stream, state, codec="zlib", dedup=True, meta_fn=state_stream_meta)
    assert step == 3
    assert torch.equal(got["w"], state["w"]) and got["n"] == 5
    assert counters["chunks"] == stats["chunks"] == len(grid)
    assert stats["data"] == 1  # one unique digest; 31 dup frames
    assert stats["sent_bytes"] < state["w"].numel() * state["w"].element_size() / 8  # compressed remainder


def test_incompressible_chunks_fall_back_to_raw_frames():
    state = {"w": torch.frombuffer(bytearray(os.urandom(16384)), dtype=torch.uint8)}
    (got, _, _, _), stats = _pump(stream, stream, state, codec="zlib",
                                  meta_fn=state_stream_meta)
    assert torch.equal(got["w"], state["w"])
    # urandom does not shrink: every frame went raw (no "z" inflation)
    assert stats["sent_bytes"] == state["w"].numel()


def test_garbled_compressed_frame_is_a_wire_error():
    """A flipped byte in a compressed payload surfaces as WireError('corrupt
    ...'), never a naked codec exception."""
    state = {"w": torch.arange(512, dtype=torch.float64).repeat(8, 1)}
    with pytest.raises(wire.WireError, match="corrupt"):
        _pump(stream, stream, state, codec="zlib", meta_fn=state_stream_meta,
              arm={"point": "wire.bulk.decompress", "action": "garble"})


def test_dup_frame_without_held_digest_is_rejected():
    asm = StateAssembler(state_stream_meta({"x": torch.arange(8, dtype=torch.int64)}))
    with pytest.raises(StreamStateError, match="digest not held"):
        asm.put("x", [[0, 8]], dup=True, hash="deadbeef")


def test_codec_ladder_matches_reference(monkeypatch):
    monkeypatch.delenv(wire.COMPRESSION_ENV, raising=False)
    assert wire.available_codecs() == jwire.available_codecs()
    assert wire.speakable_codecs() == jwire.speakable_codecs()
    assert "zlib" not in wire.available_codecs()
    monkeypatch.setenv(wire.COMPRESSION_ENV, "off")
    assert wire.available_codecs() == ()
