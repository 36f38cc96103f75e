"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``build/kernels/`` at the repository root. The library's file name carries
a hash of its source, the headers beside it (``csrc/*.cuh``) and the flags,
so an edited source or header is never served by a stale build. Nothing is
built when a module is imported: the first CUDA launch builds what it
needs, and :func:`build` compiles several sources at once, one nvcc
process each. nvcc's ptxas report (registers, spills) is kept beside each
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("delta_encode", "colocate", "flash_attention", "flash_attention_bwd",
           "linear_recurrence")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc; raises where there is no CUDA toolkit."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def lib_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``: its name hashes the source, every
    header of ``csrc`` (which any source may include) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.name.encode() + p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.blake2b(src + headers + " ".join(NVCC_FLAGS).encode(),
                          digest_size=6).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=SOURCES) -> None:
    """Compile every named source that has no current build, one nvcc each,
    all started together, keeping each build's ptxas report (see
    :func:`ptxas_report`); raises with nvcc's output if any build fails."""
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.tmp-{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}.cu (rc={proc.returncode}):\n{log}")
        else:
            out.with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent loader sees old or new
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))


def ptxas_report(name: str) -> str:
    """nvcc's output for the current build of ``csrc/<name>.cu``."""
    return lib_path(name).with_suffix(".ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return lib
