"""Chunked CMI save/restore with delta references — the port of the JAX
package's ``checkpoint/serializer.py``; the on-disk format is shared.

Save path
---------
Each tensor (CPU or CUDA) or numpy leaf is one shard covering the whole
array (``ShardingRecord`` ``None``); a :class:`HostShards` snapshot keeps
the shards it was given. A DTensor is gathered to rank 0 first
(:func:`dtensor_to_host`): one host copy per *distinct* shard index, with
its mesh's sharding record, as the reference writes a sharded
``jax.Array`` (replicas are written once). Each shard is split into ~``chunk_bytes`` axis-0
row blocks and each block is hashed. When a ``parent`` CMI is given, blocks
whose (path, slice, hash) match the parent are recorded as *references*
into the parent instead of being rewritten — the paper's §Q3 incremental
checkpointing. A CUDA leaf is copied to the host block by block, so a block
that a device change hint (``core/delta.device_changed_hints``) proves
unchanged never leaves the card.

Shared chunk engine
-------------------
:func:`iter_state_chunks` walks the tree in the JAX package's enumeration
order (arrays sorted by path, axis-0 row blocks in order), hashes + CRCs
blocks on a bounded-window thread pool and yields :class:`StateChunk`
items; ``save_checkpoint`` consumes it into the striped writers (manifest
v3) or the content-addressed object store (``cas=True``, manifest v4).
Chunk placement is round-robin over the written chunk index, so manifests
are byte-deterministic and equal to the JAX package's for equal bytes.

Stream half
-----------
:func:`state_stream_meta` describes a tree for a streaming receiver and
:class:`StateAssembler` rebuilds it chunk by chunk (``repro_torch.fabric.
stream``). The meta's dtype names and the chunk grid equal the JAX
package's on the same tree, so a JAX sender and a torch receiver (and the
other way round) speak one wire. The assembler fills host buffers and hands
back tensors on the device it was given; chunks that refer to a baseline
held on that device are copied there, device to device, after the upload.

Restore path
------------
``load_checkpoint`` plans coalesced byte-range reads per (owner CMI, data
file), runs them on a thread pool with CRC validation per chunk, and
allocates each array on the device its resolver names (host CPU tensors
when there is none). A CMI saved with a sharding record (by either
package, on a mesh) restores onto one device all the same, or, given
``shardings``, as DTensors on a ``DeviceMesh``: each rank reads only the
chunks that meet its own shard.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.checkpoint.atomic import COMMIT_FILE, CommitScope, is_committed
from repro_torch.checkpoint.cas import ObjectStore, ObjectWriterPool, object_ref
from repro_torch.checkpoint.format import (
    ArrayEntry,
    ChunkEntry,
    Manifest,
    ShardingRecord,
    decode_structure,
    dtype_itemsize,
    dtype_to_str,
    encode_structure,
    storage_dtype,
    storage_to_tensor,
    tensor_to_storage,
)
from repro_torch.utils import content_hash, crc32_of, flatten_with_paths, logger

DATA_FILE = "data-0.bin"  # shard 0; also the only file in seed-format CMIs

# Coalesced restore runs are read into one buffer; cap to bound memory.
_MAX_RUN_BYTES = 64 << 20

# (path, shape, manifest dtype, saved sharding record) -> target device
DeviceResolver = Callable[
    [str, tuple[int, ...], str, ShardingRecord | None], "torch.device | None"
]


def data_file_name(i: int) -> str:
    return f"data-{i}.bin"


def default_writers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _default_io_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


@dataclass
class SaveOptions:
    chunk_bytes: int = 16 << 20
    parent: str | None = None  # name of parent CMI (sibling dir) for delta
    # Optional precomputed per-chunk change bitmaps (from the on-device
    # delta_encode kernel): {array_path: bool ndarray over axis-0 chunk grid}.
    # Chunks marked unchanged are ref'd to the parent without hashing.
    changed_hint: dict[str, np.ndarray] = field(default_factory=dict)
    # Number of striped data files / writer threads. 0 = min(8, cpu_count).
    # 1 = sequential single-file save (seed-compatible layout).
    writers: int = 0
    # Content-addressed save (manifest v4): chunks become digest-named
    # objects under <store_root>/objects/ and only digests absent from the
    # store are written — O(changed) publish, cross-CMI dedup. The durable
    # publish paths (DHP.publish / svc/publish_resident) turn this on;
    # transit CMIs and direct callers keep the v3 striped layout.
    cas: bool = False

    def resolved_writers(self) -> int:
        return self.writers if self.writers > 0 else default_writers()



class HostShards:
    """Host-side snapshot of a device tensor.

    Produced by ``repro_torch.core.cmi.snapshot_to_host`` so the
    device→host copy happens synchronously at the publish point, while
    serialization + disk I/O run in a background thread (paper §Q5).
    ``dtype`` is the manifest dtype name; shard arrays hold its bytes in the
    storage dtype (``format.storage_dtype``).
    """

    def __init__(
        self,
        shape: tuple[int, ...],
        dtype: str,
        shards: list[tuple[tuple[tuple[int, int], ...], np.ndarray]],
        record: "ShardingRecord | None",
    ):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = shards
        self.record = record


def _is_array_leaf(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor, HostShards))


def leaf_dtype(x: Any) -> str:
    """Manifest dtype name of an array leaf."""
    return x.dtype if isinstance(x, HostShards) else dtype_to_str(x.dtype)


def _is_dtensor(x: Any) -> bool:
    # by name: importing torch.distributed.tensor would cost every process
    # that never holds one (the fabric's workers)
    return type(x).__name__ == "DTensor" and isinstance(x, torch.Tensor)


def dtensor_to_host(t: Any) -> "HostShards | None":
    """A DTensor's host snapshot, on rank 0: one copy per distinct shard
    index (JAX's ``addressable_shards`` indices), sorted, and the mesh's
    sharding record. A collective over the default group: every rank calls
    it, each shard's lowest rank sends it to rank 0 (unless it is rank 0),
    and the others get ``None``."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import mesh_coordinate, sharding_of

    sh = sharding_of(t)
    shape = tuple(int(n) for n in t.shape)
    grid = sh.mesh.mesh
    owners: dict[tuple, int] = {}
    for coord in sh.coords():
        idx, r = sh.shard_index(shape, coord), int(grid[coord])
        owners[idx] = min(r, owners.get(idx, r))
    me = dist.get_rank() if dist.is_initialized() else 0
    local = t.to_local()
    dtype = dtype_to_str(t.dtype)
    shards = []
    for idx in sorted(owners):
        owner = owners[idx]
        if owner == me == 0:
            host = tensor_to_storage(local)
            shards.append((idx, host.copy() if local.device.type == "cpu" else host))
        elif me == 0:
            bshape = tuple(b - a for a, b in idx)
            n = int(np.prod(bshape, dtype=np.int64)) * dtype_itemsize(dtype)
            buf = torch.empty(n, dtype=torch.uint8, device=local.device)
            dist.recv(buf, src=owner)
            host = buf.cpu().numpy().view(storage_dtype(dtype)).reshape(bshape)
            shards.append((idx, host))
        elif owner == me:
            if sh.shard_index(shape, mesh_coordinate(sh.mesh)) != idx:
                raise AssertionError("a rank owns a shard it does not hold")
            dist.send(local.contiguous().reshape(-1).view(torch.uint8), dst=0)
    if me != 0:
        return None
    return HostShards(shape, dtype, shards, sh.record())


def _unique_shards(x: Any) -> list[tuple[tuple[tuple[int, int], ...], Any]]:
    """Return [(full-array slice, data)]: one shard per tensor or ndarray.

    Tensor data stays where it lives (a CUDA tensor stays on the card);
    :func:`_byte_view` brings each block to the host as it is needed. A
    DTensor on a one-rank mesh is snapshot here; on a larger mesh every
    rank must call :func:`dtensor_to_host` (``core.cmi.snapshot_to_host``)
    first.
    """
    if isinstance(x, HostShards):
        return x.shards
    if _is_dtensor(x):
        if x.device_mesh.size() != 1:
            raise ValueError("a DTensor on a mesh of several ranks: snapshot_to_host(state) "
                             "on every rank first, and save rank 0's snapshot")
        return dtensor_to_host(x).shards
    full = tuple((0, int(d)) for d in x.shape)
    if isinstance(x, torch.Tensor):
        return [(full, x.detach().contiguous())]
    return [(full, _contig(x))]


def _contig(x: np.ndarray) -> np.ndarray:
    # np.ascontiguousarray promotes 0-d to 1-d; keep the true rank.
    return np.ascontiguousarray(x).reshape(x.shape)


def _byte_view(block: Any):
    """Flat host byte view of a block — zero-copy when C-contiguous.

    A tensor block is first brought to the host in its storage dtype
    (``format.tensor_to_storage``: a copy for CUDA, a view for CPU).
    """
    if isinstance(block, torch.Tensor):
        block = tensor_to_storage(block)
    if not block.flags.c_contiguous:
        return block.tobytes()
    try:
        return memoryview(block).cast("B")
    except (ValueError, TypeError):
        return memoryview(block.reshape(-1).view(np.uint8))


def _sharding_record(x: Any) -> ShardingRecord | None:
    if isinstance(x, HostShards):
        return x.record
    if _is_dtensor(x):
        from repro_torch.distributed.sharding import sharding_of

        return sharding_of(x).record()
    return None


# ---------------------------------------------------------------------------
# write engine
# ---------------------------------------------------------------------------


class _ChunkWriter:
    """Sequential single-file writer (the ``writers=1`` baseline path)."""

    def __init__(self, path: Path, file_name: str = DATA_FILE):
        self.file_name = file_name
        self.f = open(path, "wb")
        self.offset = 0

    def append(self, buf, cent: ChunkEntry) -> tuple[str, int, int]:
        off = self.offset
        n = _nbytes(buf)
        self.f.write(buf)
        self.offset += n
        return self.file_name, off, n

    def close(self) -> None:
        self.f.flush()
        os.fsync(self.f.fileno())
        self.f.close()

    @property
    def data_files(self) -> list[str]:
        return [self.file_name]


def _nbytes(buf) -> int:
    return buf.nbytes if isinstance(buf, memoryview) else len(buf)


# Writer threads gather queued chunks into vectored writes up to this size
# (and at most IOV_MAX-safe item counts): one syscall — and on network
# filesystems one round trip — per batch instead of per chunk.
_WRITE_BATCH_BYTES = 8 << 20
_WRITE_BATCH_ITEMS = 512


def _writev_all(fd: int, bufs: list) -> None:
    """``os.writev`` with short-write handling."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b) for b in bufs]
    while bufs:
        n = os.writev(fd, bufs)
        while bufs and n >= bufs[0].nbytes:
            n -= bufs[0].nbytes
            bufs.pop(0)
        if n and bufs:
            bufs[0] = bufs[0][n:]


class _WriterThread:
    """Drains one queue of (file idx, buf) items for the shard files it
    owns, in submit order.

    Writer threads are pure I/O: chunks are gathered into vectored writes
    (one ``writev`` per file per batch) with no CPU work between syscalls —
    hashing and CRC both live on the scheduler's hash pool, so the write
    stream never stalls behind checksum work on latency-bound filesystems.
    Each thread fsyncs its own files before exiting, so shard fsyncs run
    concurrently rather than serially at close. On error the thread keeps
    draining (discarding) its queue so the scheduler can never deadlock on a
    full queue; the error re-raises at ``close()`` which aborts the commit.
    """

    def __init__(self, index: int, files: dict[int, Any]):
        self.files = files  # file idx -> raw file object (owned by this thread)
        self.error: Exception | None = None
        self.q: queue.Queue = queue.Queue(maxsize=32)
        self.thread = threading.Thread(
            target=self._run, name=f"cmi-writer-{index}", daemon=True
        )
        self.thread.start()

    def _run(self) -> None:
        done = False
        while not done:
            item = self.q.get()
            if item is None:
                break
            batch = [item]
            nb = _nbytes(item[1])
            while nb < _WRITE_BATCH_BYTES and len(batch) < _WRITE_BATCH_ITEMS:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    done = True
                    break
                batch.append(nxt)
                nb += _nbytes(nxt[1])
            if self.error is not None:
                continue  # drain only; commit already doomed
            try:
                by_file: dict[int, list] = {}
                for fidx, buf in batch:
                    by_file.setdefault(fidx, []).append(buf)
                for fidx, bufs in by_file.items():
                    _writev_all(self.files[fidx].fileno(), bufs)
            except Exception as e:  # surfaced at close()
                self.error = e
        if self.error is None:
            try:
                for f in self.files.values():
                    os.fsync(f.fileno())
            except Exception as e:
                self.error = e

    def submit(self, fidx: int, buf) -> None:
        if self.error is not None:
            raise self.error
        self.q.put((fidx, buf))

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()
        for f in self.files.values():
            f.close()
        if self.error is not None:
            raise self.error


class _StripedWriterPool:
    """Round-robin chunk striping over W shard files.

    The thread count is ``min(W, max(2, cpu_count))`` — on small hosts many
    stripe files share a writer thread (per-file append order is preserved:
    the scheduler feeds each thread in enumeration order), while on large
    hosts each file gets its own thread. Offsets are assigned at submit time
    on the scheduler thread, so file placement is deterministic regardless
    of thread timing.
    """

    def __init__(self, scope: CommitScope, writers: int):
        self.names = [data_file_name(i) for i in range(writers)]
        self.offsets = [0] * writers
        files = [open(scope.path(n), "wb", buffering=0) for n in self.names]
        # On high-latency filesystems more threads hide round trips even on
        # few cores; REPRO_CMI_WRITER_THREADS overrides the heuristic.
        nthreads = int(os.environ.get("REPRO_CMI_WRITER_THREADS", "0"))
        if nthreads <= 0:
            nthreads = min(writers, max(2, os.cpu_count() or 1))
        nthreads = min(writers, nthreads)
        self.threads = [
            _WriterThread(t, {i: files[i] for i in range(writers) if i % nthreads == t})
            for t in range(nthreads)
        ]
        self._next = 0

    def append(self, buf, cent: ChunkEntry) -> tuple[str, int, int]:
        n = _nbytes(buf)
        i = self._next % len(self.names)
        self._next += 1
        off = self.offsets[i]
        self.offsets[i] += n
        self.threads[i % len(self.threads)].submit(i, buf)
        return self.names[i], off, n

    def close(self) -> None:
        first: Exception | None = None
        for t in self.threads:
            try:
                t.close()
            except Exception as e:
                first = first or e
        if first is not None:
            raise first

    @property
    def data_files(self) -> list[str]:
        return list(self.names)


def _hash_and_crc(buf) -> tuple[str, int]:
    return content_hash(buf), crc32_of(buf)


class _ChunkSink:
    """Writes finalized chunks (hash/CRC precomputed by the shared chunk
    engine) through the striped writer pool, maintaining save stats.

    Pure plumbing: the hashing pipeline lives in :func:`iter_state_chunks`,
    which stays a bounded window ahead of this sink, so CPU (hash chunk k+1)
    still overlaps disk (write chunk k) exactly as before the refactor.
    """

    def __init__(self, scope: CommitScope, writers: int, stats: dict, parent: str | None):
        self.stats = stats
        self.parent = parent
        if writers > 1:
            self.engine: Any = _StripedWriterPool(scope, writers)
        else:
            self.engine = _ChunkWriter(scope.path(DATA_FILE))

    def put_ref(self, chunks: list, bslice, pchunk: ChunkEntry, h: str | None = None) -> None:
        cent = ChunkEntry(
            slice=[list(s) for s in bslice],
            file=pchunk.file,
            offset=pchunk.offset,
            nbytes=pchunk.nbytes,
            crc32=pchunk.crc32,
            hash=h if h is not None else pchunk.hash,
            ref=pchunk.ref or self.parent,
        )
        self.stats["ref_bytes"] += cent.nbytes
        self.stats["ref_chunks"] += 1
        self.stats["chunks"] += 1
        chunks.append(cent)

    def put_data(self, chunks: list, bslice, buf, h: str, crc: int) -> None:
        cent = ChunkEntry(
            slice=[list(s) for s in bslice],
            file="",
            offset=0,
            nbytes=0,
            crc32=crc,
            hash=h,
        )
        cent.file, cent.offset, cent.nbytes = self.engine.append(buf, cent)
        self.stats["written_bytes"] += cent.nbytes
        self.stats["chunks"] += 1
        chunks.append(cent)

    def close(self) -> None:
        self.engine.close()

    @property
    def data_files(self) -> list[str]:
        return self.engine.data_files


def _chunk_rows(shard_shape: tuple[int, ...], itemsize: int, chunk_bytes: int) -> int:
    """Rows of the shard's axis 0 per chunk (whole shard if 0-d/1 row)."""
    if not shard_shape:
        return 1
    row_bytes = itemsize * int(np.prod(shard_shape[1:], dtype=np.int64)) if len(shard_shape) > 1 else itemsize
    return max(1, chunk_bytes // max(1, row_bytes))


# ---------------------------------------------------------------------------
# shared chunk engine (save-to-disk and stream-to-socket both consume this)
# ---------------------------------------------------------------------------


def bslice_key(bslice) -> tuple:
    """Canonical hashable key for a chunk's full-array slice."""
    return tuple((int(a), int(b)) for a, b in bslice)


def _block_nbytes(bslice, itemsize: int) -> int:
    n = 1
    for a, b in bslice:
        n *= b - a
    return n * itemsize


@dataclass
class StateChunk:
    """One chunk produced by :func:`iter_state_chunks`.

    ``data`` is a byte buffer (``memoryview``/``bytes``) for chunks that must
    travel, or ``None`` for *reference* chunks whose content matched the
    ``baseline`` grid — the consumer resolves those against its own copy of
    the baseline (a delta parent's data file, or a streaming receiver's
    cached state). ``crc32`` is ``None`` when hashing was skipped entirely
    (device changed-hint said "unchanged").

    ``dup`` marks digest-first dedup hits: the ``have_digest`` oracle said
    the consumer already holds these exact bytes under this hash (a CAS
    store object, or an earlier chunk of the same stream), so ``data`` is
    ``None`` even though the chunk is not a positional baseline reference —
    the consumer resolves it by digest, not by (path, slice).

    ``codec``/``cdata`` carry an optional compressed rendition produced on
    the hash pool (only when it actually came out smaller); the wire sender
    ships ``cdata`` with a per-frame codec marker while ``data`` stays the
    raw bytes for CRC/identity purposes.
    """

    seq: int
    path: str
    slice: list[list[int]]
    data: Any
    nbytes: int
    hash: str
    crc32: int | None
    ref: bool
    dup: bool = False
    codec: str | None = None
    cdata: Any = None


def _iter_array_blocks(x: Any, chunk_bytes: int):
    """Yield ``(bslice, block)`` for one array leaf in the engine's canonical
    order: unique shards sorted by slice, then axis-0 row blocks in order."""
    itemsize = dtype_itemsize(leaf_dtype(x))
    for sl, data in _unique_shards(x):
        rows = _chunk_rows(tuple(data.shape), itemsize, chunk_bytes)
        n0 = data.shape[0] if data.ndim else 1
        for r0 in range(0, n0, rows):
            r1 = min(n0, r0 + rows)
            if data.ndim:
                block = data[r0:r1]
                bslice = [[sl[0][0] + r0, sl[0][0] + r1]] + [[a, b] for a, b in sl[1:]]
            else:
                block = data
                bslice = []
            yield bslice, block


def iter_state_chunks(
    tree: Any,
    *,
    chunk_bytes: int = 16 << 20,
    baseline: Mapping[tuple, str] | None = None,
    changed_hint: Mapping[str, np.ndarray] | None = None,
    hash_threads: int = 0,
    have_digest: Callable[[str], bool] | None = None,
    compress: Callable[[Any], "tuple[str, Any] | None"] | None = None,
) -> Any:
    """Chunk + hash ``tree`` in deterministic enumeration order.

    Yields :class:`StateChunk` in order. Hashing runs on a bounded-window
    thread pool (``hash_threads``; 0 = min(8, cpu_count), 1 = inline), so
    the pool hashes chunk k+window while the consumer writes/sends chunk k.

    ``baseline`` maps ``(path, bslice_key(slice))`` to a content hash;
    chunks whose hash matches are yielded as references (``data=None``).
    ``changed_hint`` (per-array chunk-grid bitmaps from
    ``core/delta.device_changed_hints``) short-circuits hashing entirely for
    chunks the device already proved unchanged — those reuse the baseline
    hash verbatim, keeping the grid continuous for the *next* delta.

    ``have_digest`` is the digest-first enumeration oracle: chunks whose
    content the consumer *already holds under this digest* — a CAS store
    object (``ObjectStore.has``), or a chunk sent earlier in the same
    stream — are yielded with ``dup=True`` and no payload, regardless of
    their (path, slice) position. ``compress`` runs on the hash pool right
    after hashing (so the I/O consumer never stalls behind compression) and
    returns ``(codec, compressed_bytes)`` or ``None`` to keep the chunk
    raw; it is skipped for chunks the baseline or ``have_digest`` already
    excuse from travelling.
    """
    flat, _ = flatten_with_paths(tree)
    array_paths = sorted(k for k, v in flat.items() if _is_array_leaf(v))
    baseline = baseline or {}
    changed_hint = changed_hint or {}
    threads = hash_threads if hash_threads > 0 else max(1, min(8, os.cpu_count() or 1))
    pool = (
        ThreadPoolExecutor(max_workers=threads, thread_name_prefix="cmi-hash")
        if threads > 1
        else None
    )
    window = threads * 4
    pending: deque = deque()  # (path, bslice, itemsize, buf|None, fut|None)
    seq = 0

    def hash_task(buf, key):
        """Pool-side work: hash + CRC, then compress unless the chunk is
        already excused from travelling (baseline hit / consumer-held
        digest). ``have_digest`` may race the consumer's view here — a miss
        only costs a wasted compression, never a wrong chunk."""
        h, crc = _hash_and_crc(buf)
        comp = None
        if compress is not None and baseline.get(key) != h:
            if have_digest is None or not have_digest(h):
                comp = compress(buf)
        return h, crc, comp

    def drain_one() -> StateChunk:
        nonlocal seq
        path, bslice, itemsize, buf, fut = pending.popleft()
        key = (path, bslice_key(bslice))
        nbytes = _block_nbytes(bslice, itemsize)
        if buf is None:  # device hint: unchanged, never hashed
            ch = StateChunk(seq, path, [list(s) for s in bslice], None, nbytes,
                            baseline[key], None, True)
        else:
            h, crc, comp = fut.result() if fut is not None else hash_task(buf, key)
            if baseline.get(key) == h:
                ch = StateChunk(seq, path, [list(s) for s in bslice], None, nbytes,
                                h, crc, True)
            elif have_digest is not None and have_digest(h):
                ch = StateChunk(seq, path, [list(s) for s in bslice], None, nbytes,
                                h, crc, False, dup=True)
            else:
                ch = StateChunk(seq, path, [list(s) for s in bslice], buf, nbytes,
                                h, crc, False)
                if comp is not None:
                    ch.codec, ch.cdata = comp
        seq += 1
        return ch

    try:
        for apath in array_paths:
            x = flat[apath]
            itemsize = dtype_itemsize(leaf_dtype(x))
            hint = changed_hint.get(apath)
            counter = 0
            for bslice, block in _iter_array_blocks(x, chunk_bytes):
                key = (apath, bslice_key(bslice))
                unchanged_hint = (
                    hint is not None
                    and counter < len(hint)
                    and not bool(hint[counter])
                    and key in baseline
                )
                counter += 1
                if unchanged_hint:
                    pending.append((apath, bslice, itemsize, None, None))
                else:
                    buf = _byte_view(block)
                    fut = pool.submit(hash_task, buf, key) if pool is not None else None
                    pending.append((apath, bslice, itemsize, buf, fut))
                while len(pending) >= window:
                    yield drain_one()
        while pending:
            yield drain_one()
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def state_stream_meta(tree: Any) -> dict:
    """JSON-able description of ``tree``: structure skeleton + array table.

    This is the manifest's restore-relevant core without any file/offset
    bookkeeping — what a streaming receiver needs to preallocate arrays and
    rebuild the tree (``repro_torch.fabric.stream`` sends it as the stream
    header). Equal to the JAX package's for the same arrays."""
    flat, _ = flatten_with_paths(tree)
    array_paths = {k for k, v in flat.items() if _is_array_leaf(v)}
    arrays = {}
    for apath in sorted(array_paths):
        x = flat[apath]
        rec = _sharding_record(x)
        arrays[apath] = {
            "shape": [int(d) for d in x.shape],
            "dtype": leaf_dtype(x),
            "sharding": None if rec is None else rec.to_json(),
        }
    return {"structure": encode_structure(tree, array_paths), "arrays": arrays}


class StreamStateError(RuntimeError):
    """A streamed chunk failed validation (CRC/hash/baseline mismatch)."""


def _box(bslice) -> tuple:
    return tuple(slice(a, b) for a, b in bslice)


class StateAssembler:
    """Receiving half of the chunk engine: rebuild a tree chunk by chunk.

    Constructed from :func:`state_stream_meta` output; chunks may arrive in
    any order. Payload bytes land in host buffers of each array's storage
    dtype: ``target_view(path, slice)`` hands out a writable memoryview of
    the destination region when it is contiguous, so a socket receiver can
    ``recv_into`` payload bytes with zero intermediate copies; otherwise
    ``put`` scatters from a scratch buffer.

    Chunks with no payload — references into a cached ``baseline`` tree
    from a previous stream (delta hops) and digest-first ``dup`` chunks —
    are recorded and copied in arrival order by :meth:`finish`, after the
    host buffers went to ``device``: a baseline that lives on the card is
    never read back to the host.
    """

    def __init__(
        self,
        meta: Mapping[str, Any],
        *,
        baseline: Any = None,
        baseline_grid: Mapping[tuple, str] | None = None,
        validate_crc: bool = True,
        device: torch.device | str | None = None,
    ):
        self.structure = meta["structure"]
        self.validate = validate_crc
        self.device = None if device is None else torch.device(device)
        self.arrays: dict[str, np.ndarray] = {}  # host buffers, storage dtype
        self.dtypes: dict[str, str] = {}
        self._filled: dict[str, int] = {}
        self.grid: dict[tuple, str] = {}  # (path, bslice_key) -> hash
        for apath, a in meta["arrays"].items():
            shape = tuple(int(d) for d in a["shape"])
            self.dtypes[apath] = a["dtype"]
            self.arrays[apath] = np.empty(shape, dtype=storage_dtype(a["dtype"]))
            self._filled[apath] = 0
        self._baseline_flat: dict[str, Any] | None = None
        if baseline is not None:
            self._baseline_flat, _ = flatten_with_paths(baseline)
        self._baseline_grid = dict(baseline_grid or {})
        # digest -> ("self"|"base", path, bslice): where bytes with that
        # hash can be copied from. Seeded with the baseline grid, grown as
        # chunks land — resolves dup (digest-first) chunks whose content
        # exists at a *different* (path, slice) than where it is needed.
        self._by_digest: dict[str, tuple[str, str, tuple]] = {}
        if self._baseline_flat is not None:
            for (bpath, bkey), bhash in self._baseline_grid.items():
                if bpath in self._baseline_flat:
                    self._by_digest.setdefault(bhash, ("base", bpath, bkey))
        # (dest path, dest bslice, "self"|"base", source path, source key,
        # same-place ref?) — the payload-free chunks, copied by finish()
        self._deferred: list[tuple] = []

    def target_view(self, path: str, bslice) -> memoryview | None:
        """Writable byte view of the destination region, or ``None`` when the
        region is not contiguous (receiver must scatter via ``put``)."""
        arr = self.arrays[path]
        if arr.ndim != len(bslice):
            return None
        if not arr.flags.c_contiguous:
            return None
        for d in range(1, arr.ndim):
            a, b = bslice[d]
            if a != 0 or b != arr.shape[d]:
                return None
        region = arr[bslice[0][0]: bslice[0][1]] if bslice else arr
        try:
            return memoryview(region).cast("B")
        except (ValueError, TypeError):
            return memoryview(region.reshape(-1).view(np.uint8))

    def put(
        self,
        path: str,
        bslice,
        data=None,
        *,
        hash: str | None = None,
        crc32: int | None = None,
        ref: bool = False,
        inplace: bool = False,
        dup: bool = False,
    ) -> None:
        """Account one chunk. ``inplace=True`` means the payload was already
        ``recv_into``'d through :meth:`target_view` (data is that view, used
        only for CRC validation). ``dup=True`` chunks carry no payload at
        all: their bytes are resolved by digest from a region this stream
        (or its baseline) already holds."""
        arr = self.arrays[path]
        key = (path, bslice_key(bslice))
        if dup:
            if hash is None or hash not in self._by_digest:
                raise StreamStateError(f"dup chunk {key}: digest not held here")
            where, spath, skey = self._by_digest[hash]
            self._deferred.append((path, key[1], where, spath, skey, False))
        elif ref:
            if self._baseline_flat is None or path not in self._baseline_flat:
                raise StreamStateError(f"ref chunk {key} but no baseline state")
            if hash is not None and self._baseline_grid.get(key) not in (None, hash):
                raise StreamStateError(f"baseline hash mismatch for {key}")
            self._deferred.append((path, key[1], "base", path, key[1], True))
        else:
            if self.validate and crc32 is not None and crc32_of(data) != crc32:
                raise StreamStateError(f"CRC mismatch in streamed chunk {key}")
            if not inplace:
                shape = tuple(b - a for a, b in bslice)
                block = np.frombuffer(data, dtype=arr.dtype).reshape(shape)
                arr[_box(bslice)] = block
        if hash is not None:
            self.grid[key] = hash
            self._by_digest.setdefault(hash, ("self", path, key[1]))
        vol = 1
        for a, b in bslice:
            vol *= b - a
        self._filled[path] += vol

    def finish(self) -> Any:
        """Validate coverage and return the rebuilt tree: tensors on the
        assembler's device (host CPU tensors when it has none)."""
        for apath, arr in self.arrays.items():
            expected = int(np.prod(arr.shape, dtype=np.int64)) if arr.shape else 1
            if self._filled[apath] != expected:
                raise StreamStateError(
                    f"array {apath!r}: chunks cover {self._filled[apath]}/{expected} elements"
                )
        tensors = {}
        for apath, arr in self.arrays.items():
            t = storage_to_tensor(arr, self.dtypes[apath])
            tensors[apath] = t if self.device is None else t.to(self.device)
        for dpath, dkey, where, spath, skey, same_place in self._deferred:
            src = (self._baseline_flat if where == "base" else tensors)[spath][_box(skey)]
            dst = tensors[dpath]
            if same_place:  # a baseline ref: same array, same slice
                dst[_box(dkey)] = src.to(dst.device)
            else:  # a dup: equal bytes, maybe another dtype and shape
                raw = src.contiguous().reshape(-1).view(torch.uint8).to(dst.device)
                shape = tuple(b - a for a, b in dkey)
                dst[_box(dkey)] = raw.view(dst.dtype).reshape(shape)
        return decode_structure(self.structure, tensors)


def assemble_state_chunks(
    meta: Mapping[str, Any],
    chunks,
    *,
    baseline: Any = None,
    baseline_grid: Mapping[tuple, str] | None = None,
    validate_crc: bool = True,
    device: torch.device | str | None = None,
) -> tuple[Any, dict[tuple, str]]:
    """Inverse of :func:`iter_state_chunks`: fold a chunk iterable back into
    a tree. Returns ``(tree, hash grid)`` — the grid keys future deltas."""
    asm = StateAssembler(
        meta, baseline=baseline, baseline_grid=baseline_grid, validate_crc=validate_crc,
        device=device,
    )
    for ch in chunks:
        asm.put(ch.path, ch.slice, ch.data, hash=ch.hash, crc32=ch.crc32, ref=ch.ref,
                dup=getattr(ch, "dup", False))
    return asm.finish(), asm.grid


def save_checkpoint(
    store_root: str | os.PathLike,
    name: str,
    tree: Any,
    *,
    step: int = 0,
    meta: dict | None = None,
    options: SaveOptions | None = None,
    _crash_after_data: bool = False,
) -> Manifest:
    """Serialize ``tree`` as CMI ``<store_root>/<name>``. Returns the manifest.

    With ``options.cas`` the save is content-addressed (manifest v4): chunk
    bytes become digest-named objects in the store-level object tree and
    only digests the store does not already hold are written.
    """
    opts = options or SaveOptions()
    if opts.cas:
        return _save_checkpoint_cas(
            store_root, name, tree, step=step, meta=meta, opts=opts,
            _crash_after_data=_crash_after_data,
        )
    writers = opts.resolved_writers()
    store_root = Path(store_root)
    store_root.mkdir(parents=True, exist_ok=True)
    final = store_root / name

    parent_chunks: dict[tuple[str, tuple], ChunkEntry] = {}
    if opts.parent is not None:
        pman = load_manifest(store_root, opts.parent)
        for apath, aentry in pman.arrays.items():
            for c in aentry.chunks:
                key = (apath, tuple(tuple(s) for s in c.slice))
                parent_chunks[key] = c

    flat, _ = flatten_with_paths(tree)
    array_paths = {k for k, v in flat.items() if _is_array_leaf(v)}
    structure = encode_structure(tree, array_paths)

    arrays: dict[str, ArrayEntry] = {}
    for apath in sorted(array_paths):
        x = flat[apath]
        arrays[apath] = ArrayEntry(
            shape=list(x.shape),
            dtype=leaf_dtype(x),
            chunks=[],
            sharding=_sharding_record(x),
        )
    baseline = {key: c.hash for key, c in parent_chunks.items()}
    stats = {"written_bytes": 0, "ref_bytes": 0, "chunks": 0, "ref_chunks": 0}

    with CommitScope(final, crash_after_data=_crash_after_data) as scope:
        sink = _ChunkSink(scope, writers, stats, parent=opts.parent)
        try:
            # The shared chunk engine hashes a bounded window ahead (inline
            # when writers == 1 — the fully-sequential seed path) while the
            # sink streams earlier chunks to the pure-I/O writer threads.
            for ch in iter_state_chunks(
                tree,
                chunk_bytes=opts.chunk_bytes,
                baseline=baseline,
                changed_hint=opts.changed_hint,
                hash_threads=1 if writers == 1 else 0,
            ):
                entry = arrays[ch.path]
                if ch.ref:
                    pchunk = parent_chunks[(ch.path, bslice_key(ch.slice))]
                    sink.put_ref(entry.chunks, ch.slice, pchunk, ch.hash)
                else:
                    sink.put_data(entry.chunks, ch.slice, ch.data, ch.hash, ch.crc32)
        finally:
            sink.close()
        for fname in sink.data_files:  # writers fsync'd these on close
            scope.mark_synced(fname)

        manifest = Manifest(
            step=step,
            meta=meta or {},
            structure=structure,
            arrays=arrays,
            parent=opts.parent,
            version=3,  # striped layout; v4 is the CAS path below
            data_files=sink.data_files,
            extra={"stats": stats},
        )
        scope.write_text("manifest.json", manifest.dumps())
    logger.debug(
        "saved CMI %s: %d chunks (%d ref'd) across %d files, %.1f MiB written, %.1f MiB ref'd",
        name, stats["chunks"], stats["ref_chunks"], writers,
        stats["written_bytes"] / 2**20, stats["ref_bytes"] / 2**20,
    )
    return manifest


def _save_checkpoint_cas(
    store_root: str | os.PathLike,
    name: str,
    tree: Any,
    *,
    step: int,
    meta: dict | None,
    opts: SaveOptions,
    _crash_after_data: bool = False,
) -> Manifest:
    """Content-addressed save (manifest v4).

    Every chunk entry is a digest reference (``ref="objects/<d[:2]>"``,
    ``file=<digest>``) into the store's object tree; only digests the store
    does not already hold are written, in parallel, by an
    :class:`~repro_torch.checkpoint.cas.ObjectWriterPool`. Durability order:
    objects are fsync'd + linked (``cas.publish.pre_link`` per object),
    bucket dirs fsync'd, ``cas.publish.post_objects`` fires, and only then
    does ``CommitScope`` stage + COMMIT the manifest — a kill anywhere
    leaves either the previous CMI intact or benign orphan objects, never
    a manifest with dangling refs. The whole sequence runs under the
    store's *shared* fcntl guard so a concurrent mark-and-sweep GC cannot
    delete objects out from under an in-flight publish.
    """
    from repro_torch.chaos import faults

    store_root = Path(store_root)
    store_root.mkdir(parents=True, exist_ok=True)
    final = store_root / name
    store = ObjectStore(store_root)

    parent_chunks: dict[tuple[str, tuple], ChunkEntry] = {}
    if opts.parent is not None:
        pman = load_manifest(store_root, opts.parent)
        if pman.version >= 4:
            # Only a CAS parent guarantees every baseline digest exists as
            # an object; delta-chaining against a v3 parent would mint
            # digest refs to bytes that live in the parent's stripe files.
            # Fall back to a full (still store-deduped) enumeration.
            for apath, aentry in pman.arrays.items():
                for c in aentry.chunks:
                    key = (apath, tuple(tuple(s) for s in c.slice))
                    parent_chunks[key] = c

    flat, _ = flatten_with_paths(tree)
    array_paths = {k for k, v in flat.items() if _is_array_leaf(v)}
    structure = encode_structure(tree, array_paths)
    arrays: dict[str, ArrayEntry] = {}
    for apath in sorted(array_paths):
        x = flat[apath]
        arrays[apath] = ArrayEntry(
            shape=list(x.shape),
            dtype=leaf_dtype(x),
            chunks=[],
            sharding=_sharding_record(x),
        )
    baseline = {key: c.hash for key, c in parent_chunks.items()}
    changed_hint = opts.changed_hint if parent_chunks else {}
    stats = {"written_bytes": 0, "ref_bytes": 0, "chunks": 0, "ref_chunks": 0,
             "dedup_chunks": 0, "objects_written": 0}

    with store.publish_guard():
        pool = ObjectWriterPool(store, opts.resolved_writers())
        try:
            for ch in iter_state_chunks(
                tree,
                chunk_bytes=opts.chunk_bytes,
                baseline=baseline,
                changed_hint=changed_hint,
                have_digest=store.has,
            ):
                digest = ch.hash
                crc = ch.crc32
                if crc is None:  # device-hint ref: hashing skipped entirely
                    crc = parent_chunks[(ch.path, bslice_key(ch.slice))].crc32
                arrays[ch.path].chunks.append(ChunkEntry(
                    slice=[list(s) for s in ch.slice],
                    file=digest,
                    offset=0,
                    nbytes=ch.nbytes,
                    crc32=crc,
                    hash=digest,
                    ref=object_ref(digest),
                ))
                stats["chunks"] += 1
                if ch.data is None:  # baseline ref, hint ref, or dedup hit
                    stats["ref_chunks"] += 1
                    stats["ref_bytes"] += ch.nbytes
                    if ch.dup:
                        stats["dedup_chunks"] += 1
                else:
                    pool.submit(digest, ch.data)
        except BaseException:
            try:
                pool.close()  # orphan objects only; no manifest committed
            except Exception:
                pass  # the original failure is the one worth surfacing
            raise
        stats["written_bytes"], stats["objects_written"] = pool.close()
        faults.fire("cas.publish.post_objects")

        manifest = Manifest(
            step=step,
            meta=meta or {},
            structure=structure,
            arrays=arrays,
            parent=opts.parent,
            version=4,
            data_files=[],
            extra={"stats": stats},
        )
        with CommitScope(final, crash_after_data=_crash_after_data) as scope:
            scope.write_text("manifest.json", manifest.dumps())
    logger.debug(
        "saved CAS CMI %s: %d chunks (%d ref'd, %d dedup'd), %d new objects, "
        "%.1f MiB written",
        name, stats["chunks"], stats["ref_chunks"], stats["dedup_chunks"],
        stats["objects_written"], stats["written_bytes"] / 2**20,
    )
    return manifest


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def load_manifest(store_root: str | os.PathLike, name: str) -> Manifest:
    d = Path(store_root) / name
    if not is_committed(d):
        raise FileNotFoundError(f"CMI {d} is missing or uncommitted (no {COMMIT_FILE})")
    return Manifest.loads((d / "manifest.json").read_text())


def _overlap(
    a: list[list[int]] | tuple, b: tuple[tuple[int, int], ...]
) -> tuple[tuple[int, int], ...] | None:
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


class _ChunkReader:
    """Thread-pooled chunk range reader with per-thread file handles.

    ``io_threads <= 1`` reads serially on the calling thread (and still
    validates CRCs); otherwise coalesced runs execute concurrently on a
    shared pool. File handles are cached per (thread, path) so concurrent
    ``seek``+``read`` never race on shared descriptors.
    """

    def __init__(
        self,
        store_root: Path,
        self_name: str,
        validate_crc: bool,
        io_threads: int = 0,
    ):
        self.root = store_root
        self.name = self_name
        self.validate = validate_crc
        self.threads = io_threads if io_threads > 0 else _default_io_threads()
        self._tls = threading.local()
        self._all_files: list[Any] = []
        self._lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None

    def _open(self, p: Path):
        cache = getattr(self._tls, "files", None)
        if cache is None:
            cache = self._tls.files = {}
        f = cache.get(p)
        if f is None:
            f = cache[p] = open(p, "rb")
            with self._lock:
                self._all_files.append(f)
        return f

    def file_path(self, owner: str, file: str) -> Path:
        return self.root / owner / file

    def read_range(self, path: Path, offset: int, nbytes: int) -> bytes:
        f = self._open(path)
        f.seek(offset)
        buf = f.read(nbytes)
        if len(buf) != nbytes:
            raise IOError(f"short read on {path} @ {offset}")
        return buf

    def pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.threads, thread_name_prefix="cmi-read"
            )
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        with self._lock:
            for f in self._all_files:
                f.close()
            self._all_files.clear()


@dataclass
class _ReadRun:
    """A coalesced contiguous byte range in one data file."""

    path: Path
    offset: int
    nbytes: int
    items: list  # [(ChunkEntry, overlap)]


def _plan_runs(
    entry: ArrayEntry, target: tuple[tuple[int, int], ...], reader: _ChunkReader
) -> list[_ReadRun]:
    """Group target-overlapping chunks by file; coalesce adjacent ranges."""
    by_file: dict[tuple[str, str], list] = {}
    for chunk in entry.chunks:
        ov = _overlap(chunk.slice, target)
        if ov is None:
            continue
        by_file.setdefault((chunk.ref or reader.name, chunk.file), []).append(
            (chunk, ov)
        )
    runs: list[_ReadRun] = []
    for (owner, file), items in sorted(by_file.items()):
        items.sort(key=lambda co: co[0].offset)
        path = reader.file_path(owner, file)
        cur: _ReadRun | None = None
        for chunk, ov in items:
            if (
                cur is not None
                and chunk.offset == cur.offset + cur.nbytes
                and cur.nbytes + chunk.nbytes <= _MAX_RUN_BYTES
            ):
                cur.nbytes += chunk.nbytes
                cur.items.append((chunk, ov))
            else:
                cur = _ReadRun(path, chunk.offset, chunk.nbytes, [(chunk, ov)])
                runs.append(cur)
    return runs


def _exec_run(
    run: _ReadRun,
    dtype: np.dtype,
    target: tuple[tuple[int, int], ...],
    out: np.ndarray,
    reader: _ChunkReader,
) -> int:
    """Read one coalesced run, CRC-check each chunk, scatter into ``out``."""
    buf = memoryview(reader.read_range(run.path, run.offset, run.nbytes))
    filled = 0
    for chunk, ov in run.items:
        rel = chunk.offset - run.offset
        raw = buf[rel : rel + chunk.nbytes]
        if reader.validate and crc32_of(raw) != chunk.crc32:
            raise IOError(
                f"CRC mismatch in {run.path} @ {chunk.offset} (corrupt CMI)"
            )
        shape = tuple(b - a for a, b in chunk.slice)
        block = np.frombuffer(raw, dtype=dtype).reshape(shape)
        src = tuple(
            slice(lo - c0, hi - c0) for (lo, hi), (c0, _) in zip(ov, chunk.slice)
        )
        dst = tuple(slice(lo - t0, hi - t0) for (lo, hi), (t0, _) in zip(ov, target))
        out[dst] = block[src]
        filled += int(np.prod([hi - lo for lo, hi in ov], dtype=np.int64)) if ov else 1
    return filled


def _assemble(
    entry: ArrayEntry,
    target: tuple[tuple[int, int], ...],
    reader: _ChunkReader,
) -> np.ndarray:
    """Materialise ``target`` slice of the array, reading only overlapping chunks."""
    dtype = storage_dtype(entry.dtype)
    tshape = tuple(b - a for a, b in target)
    out = np.empty(tshape, dtype=dtype)
    runs = _plan_runs(entry, target, reader)
    if reader.threads > 1 and len(runs) > 1:
        futs = [
            reader.pool().submit(_exec_run, run, dtype, target, out, reader)
            for run in runs
        ]
        filled = sum(f.result() for f in futs)
    else:
        filled = sum(_exec_run(run, dtype, target, out, reader) for run in runs)
    expected = int(np.prod(tshape, dtype=np.int64)) if tshape else 1
    if filled != expected:
        raise IOError(
            f"CMI chunks cover {filled}/{expected} elements of requested slice "
            "(inconsistent manifest)"
        )
    return out


def _materialize(entry: ArrayEntry, reader: _ChunkReader, device) -> torch.Tensor:
    """Read the whole array and allocate it on ``device`` (host if None)."""
    host = _assemble(entry, tuple((0, d) for d in entry.shape), reader)
    t = storage_to_tensor(host, entry.dtype)
    return t if device is None else t.to(device)


def _materialize_sharded(entry: ArrayEntry, reader: _ChunkReader, sharding) -> torch.Tensor:
    """This rank's shard of the array under ``sharding`` (a
    ``distributed.sharding.NamedSharding``) as a DTensor: only the chunks
    that meet the shard are read."""
    from repro_torch.distributed.sharding import from_local, mesh_coordinate, mesh_device

    index = sharding.shard_index(entry.shape, mesh_coordinate(sharding.mesh))
    local = storage_to_tensor(_assemble(entry, index, reader), entry.dtype)
    return from_local(local.to(mesh_device(sharding.mesh)), entry.shape, sharding)


def _load_one(apath: str, entry: ArrayEntry, reader: _ChunkReader, shardings, devices):
    """One array: placed by ``shardings`` (a mapping or a resolver giving a
    NamedSharding or None) where it names one, else on ``devices``' device."""
    sharding = None
    if callable(shardings):
        sharding = shardings(apath, tuple(entry.shape), entry.dtype, entry.sharding)
    elif shardings is not None:
        sharding = shardings.get(apath)
    if sharding is not None:
        return _materialize_sharded(entry, reader, sharding)
    device = devices
    if callable(devices):
        device = devices(apath, tuple(entry.shape), entry.dtype, entry.sharding)
    return _materialize(entry, reader, device)


def load_checkpoint(
    store_root: str | os.PathLike,
    name: str,
    *,
    devices: DeviceResolver | None = None,
    shardings: Mapping[str, Any] | Callable | None = None,
    validate_crc: bool = True,
    io_threads: int = 0,
) -> tuple[Any, Manifest]:
    """Restore a CMI. Returns ``(tree, manifest)``; array leaves are tensors.

    ``devices`` is None (host CPU tensors) or a resolver callback
    ``(path, shape, dtype, saved_sharding_record) -> device``, as
    ``core.cmi.device_resolver`` builds. ``shardings`` places arrays as
    DTensors: a mapping from array path to a ``NamedSharding``, or a
    resolver callback with ``devices``' arguments giving one or None
    (``core.cmi.mesh_resharding_resolver``); an array it gives none goes
    to ``devices``. ``io_threads`` bounds the concurrent-read pool (0 =
    min(8, cpu_count), 1 = serial).
    """
    store_root = Path(store_root)
    manifest = load_manifest(store_root, name)
    reader = _ChunkReader(store_root, name, validate_crc, io_threads)
    try:
        arrays = {apath: _load_one(apath, entry, reader, shardings, devices)
                  for apath, entry in manifest.arrays.items()}
        return decode_structure(manifest.structure, arrays), manifest
    finally:
        reader.close()


def load_arrays(
    store_root: str | os.PathLike,
    name: str,
    paths: list[str] | None = None,
    *,
    device: torch.device | str | None = None,
    shardings: Any = None,
    validate_crc: bool = True,
    io_threads: int = 0,
) -> dict[str, torch.Tensor]:
    """Partial restore: just the named arrays (all, for ``paths=None``) as a
    flat ``{path: tensor}`` dict, on ``device`` (None: host CPU tensors), or
    placed as DTensors by ``shardings`` (as in :func:`load_checkpoint`).
    Only the chunks of the named arrays (of this rank's shards) are read."""
    store_root = Path(store_root)
    manifest = load_manifest(store_root, name)
    reader = _ChunkReader(store_root, name, validate_crc, io_threads)
    try:
        return {apath: _load_one(apath, manifest.arrays[apath], reader, shardings, device)
                for apath in (paths if paths is not None else list(manifest.arrays))}
    finally:
        reader.close()
