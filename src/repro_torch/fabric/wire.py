"""Wire protocol for the NavP fabric: length-prefixed frames over sockets.

Control frame layout (everything big-endian)::

    +----------------+-------+----------------------+
    | u32 body length| codec | body (length-1 bytes)|
    +----------------+-------+----------------------+

``codec`` is one byte: ``J`` for JSON (UTF-8), ``M`` for msgpack. Each frame
carries its own codec marker, so a msgpack-capable worker can talk to a
JSON-only client in the same conversation. msgpack is used when importable
(it handles ``bytes`` natively and is ~3x smaller for numeric payloads);
otherwise JSON with a ``{"__bytes__": <base64>}`` escape.

Control payloads are *control-plane* data — service names, CMI names, job
records, small numeric summaries.

Bulk frame layout (codec byte ``B``) — the data plane for streaming hops::

    +----------------+-----+--------------+----------------+--------+---------+
    | u32 body length| 'B' | header codec | u32 header len | header | payload |
    +----------------+-----+--------------+----------------+--------+---------+

The header is a small control-codec dict (chunk slice, hash, crc); the
payload is raw array bytes, sent verbatim (no JSON/base64 round-trip, no
msgpack re-framing) and received with ``recv_into`` — straight into the
destination buffer when the receiver can supply one. This is what lets a
``dhp.hop`` stream its CMI node→node without store-mediating (paper §Q5).

Receiving is done through :class:`FrameReader`, which owns one reusable
buffer per connection: control bodies and bulk headers are read with
``recv_into`` into that buffer (no per-frame ``bytes`` accumulation), and
bulk payloads can be read directly into caller-provided memory.
"""

from __future__ import annotations

import base64
import json
import os
import random
import socket
import struct
import time
import zlib
from typing import Any

from repro_torch.chaos import faults

try:  # optional, baked into some images
    import msgpack  # type: ignore

    _HAVE_MSGPACK = True
except Exception:  # pragma: no cover - exercised only without msgpack
    msgpack = None
    _HAVE_MSGPACK = False

try:  # optional: best bulk-payload codec when the image carries it
    import zstandard as _zstd  # type: ignore
except Exception:
    _zstd = None
try:  # optional: fast fallback codec
    import lz4.frame as _lz4f  # type: ignore
except Exception:
    _lz4f = None

_LEN = struct.Struct(">I")
CODEC_JSON = b"J"
CODEC_MSGPACK = b"M"
CODEC_BULK = b"B"
# Anything past this is a corrupt length prefix. Bulk frames carry one chunk
# (~chunk_bytes) each, so even the data plane stays well under the cap.
MAX_FRAME = 256 << 20


class WireError(ConnectionError):
    """Framing/transport failure (peer died, short read, corrupt frame)."""


class RemoteError(RuntimeError):
    """A service raised on the remote side; carries the remote traceback."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback


def _json_default(obj: Any) -> Any:
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return {"__bytes__": base64.b64encode(bytes(obj)).decode("ascii")}
    # numpy scalars (np.int64 step counters etc.) degrade to python scalars
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(f"not wire-serializable: {type(obj)!r}")


def _json_object_hook(d: dict) -> Any:
    if set(d) == {"__bytes__"}:
        return base64.b64decode(d["__bytes__"])
    return d


def _encode_obj(obj: Any, *, prefer_msgpack: bool = True) -> tuple[bytes, bytes]:
    """Serialize ``obj`` to ``(codec byte, body bytes)`` without framing."""
    if _HAVE_MSGPACK and prefer_msgpack:
        return CODEC_MSGPACK, msgpack.packb(obj, use_bin_type=True, default=_json_default)
    return CODEC_JSON, json.dumps(obj, default=_json_default).encode("utf-8")


def encode(obj: Any, *, prefer_msgpack: bool = True) -> bytes:
    """Serialize ``obj`` into a framed message (length + codec + body)."""
    codec, body = _encode_obj(obj, prefer_msgpack=prefer_msgpack)
    if len(body) + 1 > MAX_FRAME:
        raise WireError(f"frame too large: {len(body)} bytes")
    return _LEN.pack(len(body) + 1) + codec + body


def decode_body(codec: bytes, body) -> Any:
    try:
        if codec == CODEC_MSGPACK:
            if not _HAVE_MSGPACK:
                raise WireError("peer sent msgpack but msgpack is unavailable")
            return msgpack.unpackb(body, raw=False)
        if codec == CODEC_JSON:
            text = bytes(body) if isinstance(body, memoryview) else body
            return json.loads(text.decode("utf-8"), object_hook=_json_object_hook)
    except WireError:
        raise
    except Exception as e:
        # corrupt/truncated body must surface as a transport error, not kill
        # a server connection thread with a raw JSONDecodeError
        raise WireError(f"undecodable {codec!r} frame: {e}") from e
    raise WireError(f"unknown codec byte {codec!r}")


def send_msg(sock: socket.socket, obj: Any) -> None:
    sock.sendall(encode(obj))


_BULK_HDR = struct.Struct(">cI")  # header codec byte + header length


def send_bulk(sock: socket.socket, header: Any, payload=b"") -> None:
    """Send one bulk frame: small control-codec ``header`` + raw ``payload``.

    ``payload`` may be ``bytes`` or a ``memoryview``; it is written to the
    socket verbatim (two ``sendall`` calls, no copy of the payload).
    """
    # chaos point: a garble here corrupts the payload AFTER its crc32 was
    # computed into the header, so the receiver's integrity check must trip
    garbled = faults.fire("wire.send_bulk", sock=sock, data=payload)
    if garbled is not None:
        payload = garbled
    hcodec, hbody = _encode_obj(header)
    n_payload = payload.nbytes if isinstance(payload, memoryview) else len(payload)
    length = 1 + _BULK_HDR.size + len(hbody) + n_payload
    if length > MAX_FRAME:
        raise WireError(f"bulk frame too large: {length} bytes")
    sock.sendall(_LEN.pack(length) + CODEC_BULK + _BULK_HDR.pack(hcodec, len(hbody)) + hbody)
    if n_payload:
        sock.sendall(payload)


class FrameReader:
    """Per-connection receiver with one reusable ``recv_into`` buffer.

    Control frames and bulk headers are read into the internal buffer (grown
    geometrically, never shrunk — no per-frame ``bytes`` allocation on the
    steady state). Bulk payloads are exposed in two steps so the caller can
    direct them into their final destination::

        kind, obj, payload_len = reader.read_frame_header()
        if kind == "bulk":
            view = reader.read_payload(payload_len, into=dest_memoryview)

    With ``into=None`` the payload lands in the reusable buffer and the
    returned memoryview is only valid until the next read.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray(64 << 10)

    def _recv_into(self, view: memoryview) -> None:
        pos, n = 0, view.nbytes
        while pos < n:
            got = self.sock.recv_into(view[pos:])
            if not got:
                raise WireError("connection closed mid-frame")
            pos += got

    def _scratch(self, n: int) -> memoryview:
        if len(self._buf) < n:
            self._buf = bytearray(max(n, 2 * len(self._buf)))
        view = memoryview(self._buf)[:n]
        self._recv_into(view)
        return view

    def read_frame_header(self):
        """Read one frame's prefix.

        Returns ``("msg", obj, 0)`` for a fully-consumed control frame, or
        ``("bulk", header_obj, payload_len)`` with the payload still on the
        socket — the caller MUST follow with :meth:`read_payload`.
        """
        faults.fire("wire.recv_frame", sock=self.sock)
        head = memoryview(self._buf)[: _LEN.size]
        self._recv_into(head)
        (length,) = _LEN.unpack(head)
        if length == 0 or length > MAX_FRAME:
            raise WireError(f"bad frame length {length}")
        codec = self._scratch(1)[0:1].tobytes()
        if codec != CODEC_BULK:
            body = self._scratch(length - 1)
            return "msg", decode_body(codec, body), 0
        bh = self._scratch(_BULK_HDR.size)
        hcodec, hlen = _BULK_HDR.unpack(bh)
        if 1 + _BULK_HDR.size + hlen > length:
            raise WireError(f"bulk header overruns frame ({hlen} > {length})")
        header = decode_body(hcodec, self._scratch(hlen))
        return "bulk", header, length - 1 - _BULK_HDR.size - hlen

    def read_payload(self, n: int, into: memoryview | None = None) -> memoryview:
        """Read ``n`` payload bytes — into ``into`` when given (its size must
        be exactly ``n``), else into the reusable scratch buffer."""
        if into is not None:
            if into.nbytes != n:
                raise WireError(f"payload target is {into.nbytes} bytes, need {n}")
            self._recv_into(into)
            return into
        return self._scratch(n)

    def recv_msg(self) -> Any:
        """Read one control frame (bulk frames are a protocol error here)."""
        kind, obj, payload_len = self.read_frame_header()
        if kind != "msg":
            raise WireError("unexpected bulk frame on control channel")
        return obj


def recv_msg(sock: socket.socket) -> Any:
    return FrameReader(sock).recv_msg()


# ---------------------------------------------------------------------------
# bulk payload compression
# ---------------------------------------------------------------------------
#
# A bulk frame may carry a compressed payload; the header then has a ``"z"``
# key naming the codec — the per-frame marker idiom the control plane already
# uses for its codec byte. Codecs are negotiated at connect time (each side
# advertises ``available_codecs()``; the sender picks the first common one)
# and every frame stays individually self-describing, so a sender is free to
# ship any frame raw (e.g. when compression did not shrink it).
#
# The chunk CRC in the header is always computed over the UNCOMPRESSED bytes:
# integrity checks run after decompression, and a flipped byte in a
# compressed payload surfaces as a WireError from :func:`decompress_payload`
# (or a CRC mismatch downstream) — never as a codec exception escaping the
# frame reader.

# env switch: "off"/"raw"/"0"/"none" disables compression entirely (the CI
# leg proving raw-fallback negotiation); a codec name restricts to that codec.
COMPRESSION_ENV = "REPRO_STREAM_COMPRESSION"


def available_codecs() -> tuple[str, ...]:
    """Codecs this process offers for bulk payloads, best first; () = raw.

    The default ladder holds only the *fast* codecs (zstd, lz4 — present
    when their packages import): their per-byte cost is far below socket
    throughput, so offering them is always safe. Stdlib zlib is deliberately
    NOT offered by default — it is slower than a local socket and would tax
    every hop — but naming it (``REPRO_STREAM_COMPRESSION=zlib``) opts in
    for thin-pipe deployments with no zstd/lz4 wheel. ``off``/``raw``/``0``/
    ``none`` disables compression entirely.
    """
    mode = os.environ.get(COMPRESSION_ENV, "").strip().lower()
    if mode in ("off", "raw", "0", "none"):
        return ()
    speakable = []
    if _zstd is not None:
        speakable.append("zstd")
    if _lz4f is not None:
        speakable.append("lz4")
    speakable.append("zlib")  # stdlib: always speakable, never default
    if mode:
        return (mode,) if mode in speakable else ()
    return tuple(c for c in speakable if c != "zlib")


def speakable_codecs() -> tuple[str, ...]:
    """Codecs this process can *decompress* — what a receiver advertises.

    Distinct from :func:`available_codecs` (the sender's offer policy):
    decoding zlib is cheap relative to any transport, so a receiver always
    lists it even though senders only offer it on explicit opt-in. ``off``
    still disables both directions.
    """
    mode = os.environ.get(COMPRESSION_ENV, "").strip().lower()
    if mode in ("off", "raw", "0", "none"):
        return ()
    out = []
    if _zstd is not None:
        out.append("zstd")
    if _lz4f is not None:
        out.append("lz4")
    out.append("zlib")
    if mode:
        return (mode,) if mode in out else ()
    return tuple(out)


def negotiate_codec(mine, theirs) -> str | None:
    """First codec of ``mine`` the peer also speaks (``None`` = raw)."""
    theirs = set(theirs or ())
    for c in mine or ():
        if c in theirs:
            return c
    return None


def compress_payload(codec: str, buf) -> bytes:
    """Compress one bulk payload; speed-leaning levels (the socket writer
    must stay saturated — this runs on the sender's hash-pool threads)."""
    if codec == "zstd":
        return _zstd.ZstdCompressor(level=1).compress(bytes(buf))
    if codec == "lz4":
        return _lz4f.compress(bytes(buf))
    if codec == "zlib":
        return zlib.compress(buf, 1)
    raise WireError(f"unknown compression codec {codec!r}")


def decompress_payload(codec: str, buf) -> bytes:
    """Inverse of :func:`compress_payload`; corrupt input is a WireError."""
    try:
        if codec == "zstd":
            if _zstd is None:
                raise WireError("peer sent zstd but zstandard is unavailable")
            return _zstd.ZstdDecompressor().decompress(bytes(buf))
        if codec == "lz4":
            if _lz4f is None:
                raise WireError("peer sent lz4 but lz4 is unavailable")
            return _lz4f.decompress(bytes(buf))
        if codec == "zlib":
            return zlib.decompress(buf)
    except WireError:
        raise
    except Exception as e:
        # a flipped byte in a compressed payload must surface as frame
        # corruption, not a codec exception escaping the frame reader
        raise WireError(f"corrupt {codec} bulk payload: {e}") from e
    raise WireError(f"unknown compression codec {codec!r}")


def read_bulk_payload(reader: FrameReader, header, payload_len: int,
                      into: memoryview | None = None) -> memoryview:
    """Read one bulk payload, honoring the header's ``"z"`` codec marker.

    Uncompressed payloads keep the zero-copy ``recv_into`` path. Compressed
    ones land in the reader's scratch buffer, pass the chaos point
    (``wire.bulk.decompress`` — a garble here models wire corruption of the
    compressed bytes), and are decompressed; downstream CRC checks then run
    on the *decompressed* bytes.
    """
    codec = header.get("z") if isinstance(header, dict) else None
    if not codec:
        return reader.read_payload(payload_len, into=into)
    raw = reader.read_payload(payload_len)
    garbled = faults.fire("wire.bulk.decompress", sock=reader.sock, data=raw)
    if garbled is not None:
        raw = garbled
    data = decompress_payload(codec, raw)
    if into is not None:
        if into.nbytes != len(data):
            raise WireError(
                f"decompressed payload is {len(data)} bytes, need {into.nbytes}"
            )
        into[:] = data
        return into
    return memoryview(data)


# ---------------------------------------------------------------------------
# addresses
# ---------------------------------------------------------------------------


# A dead/blackholed TCP host must fail fast, not block for the OS default
# (minutes of SYN retries). Every fabric connect goes through this cap.
DEFAULT_CONNECT_TIMEOUT_S = 5.0

# per-process seeded jitter for reconnect backoff: deterministic enough for
# navlint, different per process so a fleet reconnecting after one reclaim
# doesn't stampede the replacement in lockstep
_jitter = random.Random(os.getpid())


def configure_stream_socket(sock: socket.socket) -> socket.socket:
    """Apply the fabric's TCP socket policy (no-op for unix sockets).

    * ``TCP_NODELAY``: control frames are tiny and strictly request/response;
      Nagle's 40ms coalescing delay would stack once per hop round-trip.
    * ``SO_KEEPALIVE``: a worker that vanishes without a FIN (host gone,
      spot instance reclaimed at the hypervisor) must eventually surface as
      a dead connection instead of a silent forever-block.

    Called on BOTH ends: ``connect`` applies it to client sockets, and every
    server accept loop (NodeServer, registry, agent) applies it to accepted
    connections — accepted sockets do not reliably inherit listener options.
    """
    if sock.family in (socket.AF_INET, getattr(socket, "AF_INET6", socket.AF_INET)):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    return sock


def connect(
    address,
    *,
    timeout: float = DEFAULT_CONNECT_TIMEOUT_S,
    attempts: int = 1,
    backoff_s: float = 0.05,
    max_backoff_s: float = 1.0,
) -> socket.socket:
    """Open a client socket to a fabric address.

    ``("unix", path)`` or ``("tcp", host, port)``.

    ``timeout`` bounds each connection *attempt* (the returned socket is put
    back into blocking mode). With ``attempts > 1``, failed attempts retry
    under bounded exponential backoff with jitter — the building block
    ``FabricClient._reconnect`` and the registry client lean on.
    """
    kind = address[0]
    if kind not in ("unix", "tcp"):
        raise ValueError(f"unknown address kind {kind!r}")
    delay = backoff_s
    last: OSError | None = None
    for attempt in range(max(1, int(attempts))):
        if attempt:
            time.sleep(delay * _jitter.uniform(0.5, 1.0))
            delay = min(delay * 2.0, max_backoff_s)
        try:
            if kind == "unix":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(timeout)
                try:
                    sock.connect(address[1])
                except OSError:
                    sock.close()
                    raise
            else:
                sock = socket.create_connection(
                    (address[1], int(address[2])), timeout=timeout
                )
            sock.settimeout(None)  # callers own their own deadlines post-connect
            return configure_stream_socket(sock)
        except OSError as e:
            last = e
    raise last if last is not None else OSError(f"connect to {address} failed")


def listen(address) -> tuple[socket.socket, tuple]:
    """Bind+listen on a fabric address; returns (socket, resolved address).

    ``("tcp", host, 0)`` resolves the ephemeral port in the returned address.
    """
    kind = address[0]
    if kind == "unix":
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(address[1])
        except OSError as e:
            import errno
            import os

            if e.errno != errno.EADDRINUSE:
                raise
            # Path exists: either a stale socket from a SIGKILLed
            # predecessor (replacement re-binding in place) or a LIVE
            # server. Probe before unlinking — stealing a live server's
            # path would split-brain the node.
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(address[1])
            except OSError:
                pass  # nobody answering: stale, safe to reclaim
            else:
                raise  # live server on this path; surface EADDRINUSE
            finally:
                probe.close()
            os.unlink(address[1])
            sock.bind(address[1])
        sock.listen(16)
        return sock, ("unix", address[1])
    if kind == "tcp":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((address[1], int(address[2])))
        sock.listen(16)
        host, port = sock.getsockname()[:2]
        return sock, ("tcp", host, port)
    raise ValueError(f"unknown address kind {kind!r}")
