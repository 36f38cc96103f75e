"""K2's tie cases: inputs on which the tie rule and the CUDA kernel's control
flow can go wrong, made from a seed with numpy alone.

The kernel walks FOVs in sub-tiles of ``kSub`` = 32 inside shared-memory
tiles of ``kTileM`` = 512, a block owns 512 rows, and the Pallas kernel
tiles M by 512. Each case is (label, N, M, duplicated FOV pairs (a, b) with
``los[b] = los[a]``, or "all" for M copies of one FOV). ``chip_smoke.py``
and the card tests hold the kernel to the plain version on them; the CPU
tests hold the kernel's algorithm, emulated in torch, to the plain version
and the plain version to the Pallas kernel.
"""

import numpy as np

TIE_CASES = [
    ("N not a multiple of a block's rows", 1537, 300, []),
    ("M = 1", 700, 1, []),
    ("M = T", 700, 32, []),
    ("M = T + 1", 700, 33, []),
    ("M across two tiles", 1000, 1000, []),
    ("duplicate in one sub-tile", 900, 200, [(3, 20)]),
    ("duplicate across sub-tiles", 900, 200, [(5, 40), (31, 32)]),
    ("duplicate across tiles", 900, 1100, [(100, 600), (511, 512), (7, 1000)]),
    ("every FOV identical", 900, 300, "all"),
    ("M = 0", 900, 0, []),
]


def unit_vectors(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` random float32 unit vectors, f32[n, 3]."""
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def tie_case(label: str) -> tuple[np.ndarray, np.ndarray]:
    """(u f32[N,3], los f32[M,3]) of a ``TIE_CASES`` entry, from a seed.
    Where FOVs are duplicated, a third of the pixels are exact copies of a
    duplicated FOV and a third lie within 1e-4 rad of one, so their best
    cosine is reached at both indices of the pair."""
    i, (_, n, m, dups) = next((i, c) for i, c in enumerate(TIE_CASES) if c[0] == label)
    rng = np.random.default_rng(100 + i)
    u, los = unit_vectors(rng, n), unit_vectors(rng, m)
    if dups == "all":
        los[:] = los[0]
    elif dups:
        for a, b in dups:
            los[b] = los[a]
        k = n // 3
        src = los[np.resize([a for a, _ in dups], k)]
        u[:k] = src
        near = src + np.float32(1e-4) * rng.standard_normal((k, 3)).astype(np.float32)
        u[k:2 * k] = near / np.linalg.norm(near, axis=1, keepdims=True)
    return u, los
