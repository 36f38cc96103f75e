"""Checkpoint substrate: chunked, atomically-committed CMIs of tensor trees.

The port of the JAX package's ``repro.checkpoint``, with the same on-disk
format (manifest v1–v4, striped ``data-*.bin`` files, the content-addressed
``objects/`` tree): a CMI written by either package restores bit-identically
in the other, and one v4 store deduplicates chunks across both.
"""

from repro_torch.checkpoint.format import (  # noqa: F401
    ArrayEntry,
    ChunkEntry,
    Manifest,
    decode_structure,
    encode_structure,
)
from repro_torch.checkpoint.atomic import (  # noqa: F401
    CommitScope,
    is_committed,
    list_committed,
)
from repro_torch.checkpoint.cas import (  # noqa: F401
    ObjectStore,
    is_object_ref,
    object_ref,
    referenced_digests,
)
from repro_torch.checkpoint.fsck import fsck_store  # noqa: F401
from repro_torch.checkpoint.serializer import (  # noqa: F401
    SaveOptions,
    load_arrays,
    load_checkpoint,
    load_manifest,
    save_checkpoint,
)
