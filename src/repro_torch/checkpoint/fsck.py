"""Store integrity checker: ``python -m repro_torch.checkpoint.fsck <store_root>``.

Walks every committed CMI in a store (all manifest versions), resolves every
chunk reference, and re-hashes the content-addressed object tree:

* **dangling ref** — a chunk names a file (object or stripe) that does not
  exist, or a byte range past the end of it. Error.
* **corruption** — chunk bytes fail their manifest CRC, or an object file's
  blake2b digest no longer matches its name. Error.
* **orphan** — a linked object no committed manifest references, or a stale
  ``.tmp-*`` file from a killed publisher. *Benign*: exactly what a SIGKILL
  between object linking and manifest COMMIT leaves behind; the next
  mark-and-sweep GC reclaims them. Reported, but clean (exit 0) unless
  ``--strict``.

Exit status: 0 clean (orphans allowed), 2 on any error. The chaos matrix
runs this after every CAS fault cell — "SIGKILL anywhere leaves fsck clean"
is the store's durability contract.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.checkpoint.atomic import list_committed
from repro_torch.checkpoint.cas import ObjectStore, is_object_ref
from repro_torch.checkpoint.serializer import load_manifest
from repro_torch.utils import content_hash, crc32_of


@dataclass
class FsckReport:
    store_root: str
    cmis: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)  # corruption + dangling refs
    orphans: list[str] = field(default_factory=list)  # benign, GC-able
    objects_checked: int = 0
    chunks_checked: int = 0

    @property
    def clean(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        state = "clean" if self.clean else f"{len(self.errors)} error(s)"
        return (
            f"fsck {self.store_root}: {len(self.cmis)} CMI(s), "
            f"{self.chunks_checked} chunk(s), {self.objects_checked} object(s) "
            f"re-hashed, {len(self.orphans)} orphan(s) — {state}"
        )


def fsck_store(store_root: str | Path, *, check_crc: bool = True) -> FsckReport:
    """Programmatic fsck. See module docstring for the error taxonomy."""
    root = Path(store_root)
    report = FsckReport(store_root=str(root))
    store = ObjectStore(root)
    referenced: set[str] = set()

    # list_committed yields full paths; everything below keys on the CMI
    # *name* (joins against root), which also keeps relative store roots
    # working — Path(root)/absolute would silently discard root instead
    for cmi_path in list_committed(root):
        name = cmi_path.name
        report.cmis.append(name)
        try:
            man = load_manifest(root, name)
        except Exception as e:
            report.errors.append(f"{name}: unreadable manifest: {e}")
            continue
        for apath, aentry in man.arrays.items():
            for c in aentry.chunks:
                report.chunks_checked += 1
                owner = c.ref or name
                if is_object_ref(c.ref):
                    referenced.add(c.file)
                p = root / owner / c.file
                if not p.is_file():
                    report.errors.append(
                        f"{name}: dangling ref {apath}@{c.slice}: missing {owner}/{c.file}"
                    )
                    continue
                size = p.stat().st_size
                if c.offset + c.nbytes > size:
                    report.errors.append(
                        f"{name}: truncated {owner}/{c.file}: chunk needs "
                        f"[{c.offset}, {c.offset + c.nbytes}) of {size} bytes"
                    )
                    continue
                if check_crc:
                    with open(p, "rb") as f:
                        f.seek(c.offset)
                        buf = f.read(c.nbytes)
                    if crc32_of(buf) != c.crc32:
                        report.errors.append(
                            f"{name}: CRC mismatch {apath}@{c.slice} in {owner}/{c.file}"
                        )

    # object tree: names must equal content hashes; unreferenced -> orphan
    for digest in store.digests():
        report.objects_checked += 1
        p = store.path(digest)
        if content_hash(p.read_bytes()) != digest:
            report.errors.append(f"objects/{digest[:2]}/{digest}: content does not match digest")
        elif digest not in referenced:
            report.orphans.append(f"objects/{digest[:2]}/{digest}")
    for tmp in store.tmp_files():
        report.orphans.append(str(tmp.relative_to(root)))
    for p in root.iterdir() if root.is_dir() else []:
        if ".stage-" in p.name:
            report.orphans.append(p.name)

    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.checkpoint.fsck", description=__doc__)
    ap.add_argument("store_root", help="store directory (a flat dir of CMIs + objects/)")
    ap.add_argument("--strict", action="store_true",
                    help="treat orphans as errors (default: benign, GC-able)")
    ap.add_argument("--no-crc", action="store_true",
                    help="skip per-chunk CRC validation (structure + digests only)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    report = fsck_store(args.store_root, check_crc=not args.no_crc)
    if not args.quiet:
        for e in report.errors:
            print(f"ERROR: {e}")
        for o in report.orphans:
            print(f"orphan: {o}")
        print(report.summary())
    if report.errors or (args.strict and report.orphans):
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
