"""Streaming hop transport: pipeline a CMI node→node, bypassing the disk.

The paper's §Q5 leaves hop transport open; the store-mediated cross-process
``dhp.hop`` serializes, fsyncs, COMMITs and re-reads. For a
*transient* migration that durability is pure overhead, so this module
streams the state over the fabric socket instead:

    sender                                   receiver (NodeServer)
    ------                                   ---------------------
    svc/hop_stream control request  ───────▶ validate, look up baseline
                 ◀─────── accept {baseline_ok}
    iter_state_chunks(tree):                 StateAssembler:
      block → host (device tensors)            bulk frame → target_view →
      hash pool (bounded window)                 recv_into host buffer
      bulk frame per chunk  ──────────────▶    eos → upload to the node's
      (ref frames carry no payload)              device; ref chunks copied
    eos bulk frame  ──────────────────────▶      from the cached baseline there
                 ◀─────── final {token, step, …}

The wire is the JAX package's (``repro/fabric/stream.py``): the same frames,
meta and chunk grid, so either package's sender streams to either package's
receiver. A tensor leaf on the card is copied to the host block by block as
it is sent; a block a device change hint proves unchanged is neither copied
nor hashed.

Pipelining: the sender's hash pool stays ``window`` chunks ahead of the
socket write, and the kernel socket buffer overlaps sender serialization
with receiver deserialization — serialize → hash → send → receive →
scatter all run concurrently on different chunks.

Delta hops: the receiver caches each received state's chunk-hash grid with
its resident token. A later hop naming that token as ``baseline`` sends
only chunks whose hash changed (the sender compares against the grid it
kept from its own last send; device ``changed_hint`` bitmaps from
``core/delta.py`` can skip even the hashing). Unchanged chunks are resolved
from the receiver's cached baseline state — the §Q3 incremental idea
applied to the wire instead of the disk.

Failure model: ANY stream failure (connection drop, CRC mismatch, receiver
death, baseline divergence) raises on the sender, and ``dhp.hop`` falls
back transparently to the store-mediated path. The receiver discards
partial state on error — a half-streamed hop can never become resident.
``publish`` never uses this path: durability stays with the disk protocol.

Two more sessions ride the same chunk engine (remote itineraries):

* ``svc/relay`` — a *worker-initiated* hop: the NodeServer holding a
  resident state acts as the sender above, streaming straight to another
  worker's ``svc/hop_stream``. The driver sees only the receipt; neither
  the driver nor the disk is in the data path.
* ``svc/fetch_stream`` — the reverse direction: the server pumps a resident
  state's chunks back down the requesting connection
  (:func:`fetch_state_stream` is the client half). The server drops its
  resident copy only after the client acks full assembly, so a torn fetch
  leaves the state fetchable via the store path.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Mapping

from repro_torch.chaos import faults
from repro_torch.checkpoint.serializer import (
    StateAssembler,
    StreamStateError,
    bslice_key,
    iter_state_chunks,
    state_stream_meta,
)
from repro_torch.fabric import wire
from repro_torch.utils import logger, resolve_device

HOP_STREAM_SVC = "svc/hop_stream"
FETCH_STREAM_SVC = "svc/fetch_stream"

# Test hook: seconds to sleep between chunk sends (fault-injection windows).
_CHUNK_PAUSE_ENV = "REPRO_STREAM_CHUNK_PAUSE_S"


class StreamHopError(ConnectionError):
    """Streaming hop failed; caller should fall back to the store path."""


# ---------------------------------------------------------------------------
# sender
# ---------------------------------------------------------------------------


def pump_state_chunks(
    sock,
    state: Any,
    *,
    chunk_bytes: int = 16 << 20,
    baseline: Mapping[tuple, str] | None = None,
    changed_hint: Mapping[str, Any] | None = None,
    hash_threads: int = 0,
    pause_s: float = 0.0,
    fault_point: str | None = None,
    codec: str | None = None,
    dedup: bool = False,
) -> tuple[dict, int, int, int]:
    """Send every chunk of ``state`` as bulk frames followed by eos.

    The shared sending half of hop streams, relays, and streamed fetches.
    Returns ``(sent_grid, n_chunks, n_data, sent_bytes)``; ``sent_bytes``
    counts payload bytes as they went down the socket (post-compression).
    ``fault_point`` names the chaos point fired once per chunk sent (the
    three protocols sharing this pump each label their own mid-stream state).

    ``codec`` (negotiated — the receiver must speak it) compresses payloads
    on the hash-pool threads, per-frame ``"z"`` marker, raw fallback when a
    chunk does not shrink. ``dedup`` (receiver must understand ``dup``
    frames) sends repeated-content chunks once: later occurrences go as
    payload-free digest references the assembler resolves by hash.
    """
    sent_grid: dict[tuple, str] = {}
    n_chunks = n_data = sent_bytes = 0
    sent_digests: set[str] = set()
    comp = None
    if codec is not None:
        def comp(buf, _c=codec):
            data = wire.compress_payload(_c, buf)
            n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
            return (_c, data) if len(data) < n else None
    for ch in iter_state_chunks(
        state,
        chunk_bytes=chunk_bytes,
        baseline=baseline,
        changed_hint=changed_hint,
        hash_threads=hash_threads,
        have_digest=sent_digests.__contains__ if dedup else None,
        compress=comp,
    ):
        header = {
            "path": ch.path,
            "slice": ch.slice,
            "hash": ch.hash,
            "crc32": ch.crc32,
            "ref": ch.ref,
        }
        if ch.dup:
            header["dup"] = True
            payload = b""
        elif ch.ref:
            payload = b""
        elif ch.codec is not None:
            header["z"] = ch.codec
            payload = ch.cdata
        else:
            payload = ch.data
        wire.send_bulk(sock, header, payload)
        if fault_point is not None:
            faults.fire(fault_point, sock=sock)
        sent_grid[(ch.path, bslice_key(ch.slice))] = ch.hash
        if ch.hash is not None:
            sent_digests.add(ch.hash)
        n_chunks += 1
        if not ch.ref and not ch.dup:
            n_data += 1
            sent_bytes += payload.nbytes if isinstance(payload, memoryview) else len(payload)
        if pause_s:
            time.sleep(pause_s)
    wire.send_bulk(sock, {"eos": True, "chunks": n_chunks})
    return sent_grid, n_chunks, n_data, sent_bytes


def send_state_stream(
    address,
    state: Any,
    *,
    src: str = "?",
    step: int = 0,
    chunk_bytes: int = 16 << 20,
    baseline_token: str | None = None,
    baseline_grid: Mapping[tuple, str] | None = None,
    changed_hint: Mapping[str, Any] | None = None,
    hash_threads: int = 0,
    timeout_s: float = 300.0,
    fail_after_chunks: int | None = None,
    fault_point: str = "hop_stream.mid_stream",
) -> tuple[dict, dict]:
    """Stream ``state`` to the NodeServer at ``address``.

    Returns ``(receipt, sent_grid)`` — the receipt names the resident token
    on the receiver; ``sent_grid`` maps ``(path, bslice_key)`` to the hash
    of every chunk in this state, which the caller should retain as the
    baseline grid for the next delta hop to the same destination.

    Raises :class:`StreamHopError` on any transport/validation failure; the
    destination is guaranteed not to hold partial state in that case.
    """
    pause_s = float(os.environ.get(_CHUNK_PAUSE_ENV, "0") or 0)
    try:
        sock = wire.connect(address)
    except OSError as e:
        raise StreamHopError(f"cannot reach {tuple(address)}: {e}") from e
    sent_grid: dict[tuple, str] = {}
    try:
        sock.settimeout(timeout_s)
        reader = wire.FrameReader(sock)
        meta = state_stream_meta(state)
        my_codecs = list(wire.available_codecs())
        req_kwargs = {
            "src": src,
            "step": int(step),
            "meta": meta,
            "baseline": baseline_token,
            "codecs": my_codecs,  # compression offer; reply names the peer's
        }
        if fail_after_chunks is not None:  # fault-injection (tests)
            req_kwargs["fail_after_chunks"] = int(fail_after_chunks)
        wire.send_msg(sock, {"id": 1, "svc": HOP_STREAM_SVC, "kwargs": req_kwargs})
        accept = reader.recv_msg()
        if not (isinstance(accept, dict) and accept.get("ok")):
            raise StreamHopError(f"stream rejected: {accept!r}")
        res = accept.get("result") or {}
        baseline_ok = bool(res.get("baseline_ok"))
        use_baseline = baseline_grid if (baseline_ok and baseline_grid) else None
        if baseline_token is not None and not baseline_ok:
            logger.info("hop_stream: receiver dropped baseline %s; full stream", baseline_token)
        # per-connect negotiation: pre-codec receivers reply without "codecs"
        # (or with an empty list) and the stream degrades to raw frames; same
        # for digest-dedup "dup" frames, gated on the receiver saying dup_ok
        codec = wire.negotiate_codec(my_codecs, res.get("codecs"))
        sent_grid, n_chunks, n_data, sent_bytes = pump_state_chunks(
            sock,
            state,
            chunk_bytes=chunk_bytes,
            baseline=use_baseline,
            changed_hint=changed_hint if use_baseline else None,
            hash_threads=hash_threads,
            pause_s=pause_s,
            fault_point=fault_point,
            codec=codec,
            dedup=bool(res.get("dup_ok")),
        )
        final = reader.recv_msg()
        if not (isinstance(final, dict) and final.get("ok")):
            raise StreamHopError(f"stream failed on receiver: {final!r}")
        receipt = dict(final.get("result") or {})
        receipt.setdefault("chunks", n_chunks)
        receipt["data_chunks"] = n_data
        receipt["ref_chunks"] = n_chunks - n_data
        receipt["sent_bytes"] = sent_bytes
        logger.info(
            "hop_stream %s -> %s: %d chunks (%d streamed, %d ref'd), %.1f MiB on the wire",
            src, receipt.get("node", "?"), n_chunks, n_data, n_chunks - n_data,
            sent_bytes / 2**20,
        )
        return receipt, sent_grid
    except StreamHopError:
        raise
    except (OSError, wire.WireError, StreamStateError) as e:
        raise StreamHopError(f"stream to {tuple(address)} failed: {e}") from e
    finally:
        try:
            sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# receiver (runs inside NodeServer's connection thread)
# ---------------------------------------------------------------------------


def receive_state_stream(
    reader: wire.FrameReader,
    kwargs: Mapping[str, Any],
    *,
    baseline_lookup: Callable[[str], tuple[Any, Mapping[tuple, str]] | None] | None = None,
    fail_after_chunks: int | None = None,
    device=None,
) -> tuple[Any, int, dict[tuple, str], dict]:
    """Consume one stream session's bulk frames off ``reader``.

    Returns ``(state, step, hash_grid, counters)``; the state's tensors are on
    ``device`` (``None``: the card, raising where there is none), and
    ``counters`` holds the session's ``chunks``, the ``data_chunks`` that
    carried a payload (not a baseline ref or a digest dup) and the payload
    ``bytes`` read off the wire. Raises on any validation
    failure — the caller (NodeServer) reports the error and drops the
    connection; nothing becomes resident.

    ``baseline_lookup`` resolves a baseline token to ``(state, grid)`` from
    the server's resident cache. ``fail_after_chunks`` is a fault-injection
    hook (tests): abort the session after N chunks as a dying receiver would.
    """
    meta = kwargs["meta"]
    step = int(kwargs.get("step", 0))
    baseline = None
    baseline_grid: Mapping[tuple, str] | None = None
    token = kwargs.get("baseline")
    if token is not None and baseline_lookup is not None:
        hit = baseline_lookup(token)
        if hit is not None:
            baseline, baseline_grid = hit
    asm = StateAssembler(meta, baseline=baseline, baseline_grid=baseline_grid,
                         device=resolve_device(device))
    n = data = nbytes = 0
    while True:
        kind, header, payload_len = reader.read_frame_header()
        if kind != "bulk":
            raise wire.WireError(f"expected bulk frame mid-stream, got {header!r}")
        if header.get("eos"):
            if payload_len:
                reader.read_payload(payload_len)
            if int(header.get("chunks", n)) != n:
                raise StreamStateError(
                    f"stream truncated: got {n} chunks, sender counted {header.get('chunks')}"
                )
            break
        bslice = header["slice"]
        nbytes += payload_len
        if header.get("ref") or header.get("dup"):
            if payload_len:
                reader.read_payload(payload_len)
            asm.put(header["path"], bslice, ref=bool(header.get("ref")),
                    dup=bool(header.get("dup")), hash=header.get("hash"))
        elif header.get("z"):
            data += 1
            # compressed payload: decompress (chaos point + corruption →
            # WireError inside), then CRC-check the DECOMPRESSED bytes
            view = wire.read_bulk_payload(reader, header, payload_len)
            dest = asm.target_view(header["path"], bslice)
            if dest is not None and dest.nbytes == view.nbytes:
                dest[:] = view
                asm.put(header["path"], bslice, dest, hash=header.get("hash"),
                        crc32=header.get("crc32"), inplace=True)
            else:
                asm.put(header["path"], bslice, view, hash=header.get("hash"),
                        crc32=header.get("crc32"))
        else:
            data += 1
            dest = asm.target_view(header["path"], bslice)
            if dest is not None and dest.nbytes == payload_len:
                view = reader.read_payload(payload_len, into=dest)
                asm.put(header["path"], bslice, view, hash=header.get("hash"),
                        crc32=header.get("crc32"), inplace=True)
            else:
                view = reader.read_payload(payload_len)
                asm.put(header["path"], bslice, view, hash=header.get("hash"),
                        crc32=header.get("crc32"))
        n += 1
        if fail_after_chunks is not None and n >= fail_after_chunks:
            raise StreamStateError(f"fault injection: aborting after {n} chunks")
    state = asm.finish()
    return state, step, asm.grid, {"chunks": n, "data_chunks": data, "bytes": nbytes}


# ---------------------------------------------------------------------------
# streamed fetch (client side; the server half lives in NodeServer)
# ---------------------------------------------------------------------------


def fetch_state_stream(
    address,
    token: str,
    *,
    drop: bool = True,
    chunk_bytes: int = 16 << 20,
    timeout_s: float = 300.0,
    device=None,
) -> tuple[Any, int, dict]:
    """Fetch a resident state back over the fabric socket — no store.

    Opens a dedicated connection, asks the server to pump the state's chunks
    as bulk frames, assembles them, then acks; with ``drop`` the server
    discards its resident copy only after that ack, so a torn fetch leaves
    the state recoverable via the store-mediated ``svc/fetch``.

    Returns ``(state, step, counters)``, the state's tensors on ``device``
    (``None``: the card, raising where there is none) and ``counters`` the
    session's, as :func:`receive_state_stream` counts them. Raises
    :class:`StreamHopError` on any transport/validation failure.
    """
    try:
        sock = wire.connect(address)
    except OSError as e:
        raise StreamHopError(f"cannot reach {tuple(address)}: {e}") from e
    try:
        sock.settimeout(timeout_s)
        reader = wire.FrameReader(sock)
        wire.send_msg(sock, {
            "id": 1, "svc": FETCH_STREAM_SVC,
            "kwargs": {"token": token, "drop": bool(drop),
                       "chunk_bytes": int(chunk_bytes),
                       # we are the receiver here: advertise what we can
                       # decompress and that we resolve dup (digest) frames
                       "codecs": list(wire.speakable_codecs()),
                       "dup_ok": True},
        })
        accept = reader.recv_msg()
        if not (isinstance(accept, dict) and accept.get("ok")):
            raise StreamHopError(f"fetch stream rejected: {accept!r}")
        res = accept.get("result") or {}
        state, step, _grid, counters = receive_state_stream(
            reader, {"meta": res["meta"], "step": res.get("step", 0)}, device=device,
        )
        # Only now may the server drop its copy: the state is fully here.
        faults.fire("fetch_stream.before_ack", sock=sock)
        wire.send_msg(sock, {"id": 1, "ack": True})
        try:
            final = reader.recv_msg()
            if not (isinstance(final, dict) and final.get("ok")):
                logger.warning("fetch stream final status: %r", final)
        except (OSError, wire.WireError):
            pass  # state already assembled; drop confirmation is best-effort
        logger.info(
            "fetch_stream %s from %s: %d chunks", token, tuple(address), counters["chunks"],
        )
        return state, step, counters
    except StreamHopError:
        raise
    except (OSError, wire.WireError, StreamStateError, KeyError) as e:
        raise StreamHopError(f"fetch stream from {tuple(address)} failed: {e}") from e
    finally:
        try:
            sock.close()
        except OSError:
            pass


def is_stream_request(req: Any) -> bool:
    return isinstance(req, dict) and req.get("svc") == HOP_STREAM_SVC


def is_fetch_request(req: Any) -> bool:
    return isinstance(req, dict) and req.get("svc") == FETCH_STREAM_SVC


def fresh_token() -> str:
    return f"res-{uuid.uuid4().hex[:12]}"
