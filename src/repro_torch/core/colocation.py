"""VIIRS→CrIS satellite observation co-location — the paper's application.

Port of the JAX package's ``core/colocation.py`` (Fig. 7/8; Wang et al.
2016, Remote Sensing 8(1):76):

  stage 1  read VIIRS + CrIS granules      (synthetic orbital geometry here)
  stage 2  compute CrIS LOS vectors in ECEF
           compute VIIRS POS vectors in ECEF
  stage 3  match VIIRS pixels to CrIS FOVs (angular nearest-neighbor)
  stage 4  write product

The match (stage 3) is the compute hot-spot: an N×M angular argmax with
N ≈ millions of VIIRS pixels and M ≈ thousands of CrIS fields-of-view, done
by the colocate kernel (K2, ``repro_torch.kernels.colocate``) on the card.

The JAX package runs with 64-bit types off, and this module reproduces its
types exactly: the geometry runs in float32, ``sat_pos`` is computed in
float32 and stored as float64 by :func:`make_synthetic_granules`, and the
read stage turns float64 arrays into float32 tensors, as ``jnp.asarray``
does there.

Geometry notes: WGS-84 geodetic→ECEF; CrIS FOV nominal diameter 0.963°; a
VIIRS pixel matches a CrIS FOV when the angle between (pixel_pos − sat_pos)
and the FOV line-of-sight is below the half-angle.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.colocate.ops import colocate_match, colocate_match_plain, fma_f32
from repro_torch.utils import numpy_to_tensor, resolve_device, warm_cpu_math

# WGS-84
_A = 6378137.0  # semi-major axis, m
_F = 1.0 / 298.257223563
_E2 = _F * (2 - _F)

CRIS_FOV_DIAMETER_DEG = 0.963
_DEG2RAD = float(np.float32(np.pi / 180))  # the float32 constant of jnp.deg2rad


def geodetic_to_ecef(lat_deg: torch.Tensor, lon_deg: torch.Tensor, alt_m: float = 0.0):
    """WGS-84 geodetic coordinates (float32) → ECEF, shape [..., 3] (meters)."""
    lat = lat_deg * _DEG2RAD
    lon = lon_deg * _DEG2RAD
    warm_cpu_math(lat)
    sin_lat, cos_lat = torch.sin(lat), torch.cos(lat)
    # a true division: ``scalar / tensor`` would multiply by the reciprocal
    n = torch.full_like(sin_lat, _A) / _sqrt_f32(1.0 - _E2 * (sin_lat * sin_lat))
    x = (n + alt_m) * cos_lat * torch.cos(lon)
    y = (n + alt_m) * cos_lat * torch.sin(lon)
    z = (n * (1.0 - _E2) + alt_m) * sin_lat
    return torch.stack([x, y, z], dim=-1)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (PyTorch's CPU float32 sqrt is
    not; through float64 it is, as 53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def _unit(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|`` over the last axis (of 3), the norm summed as the fused
    chain XLA's CPU backend uses for the JAX package's ``jnp.linalg.norm``."""
    x0, x1, x2 = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return v / _sqrt_f32(fma_f32(x2, x2, fma_f32(x1, x1, x0 * x0)))


# ---------------------------------------------------------------------------
# synthetic granules (stage 1)
# ---------------------------------------------------------------------------


def make_synthetic_granules(
    seed: int = 0,
    *,
    n_scans: int = 16,
    cris_for_per_scan: int = 30,
    cris_fov_per_for: int = 9,
    viirs_pixels_per_scan: int = 3200,
    viirs_lines_per_scan: int = 16,
    orbit_alt_m: float = 824_000.0,  # Suomi-NPP
    swath_half_deg: float = 8.0,
) -> dict[str, np.ndarray]:
    """Generate co-registered synthetic VIIRS/CrIS granules along one track
    (numpy, from ``seed``; the same arrays as the JAX package's).

    Both instruments view the same ground swath from the same platform (SNPP
    carries both), so true matches exist by construction; jitter makes the
    nearest-neighbor problem non-trivial.
    """
    rng = np.random.default_rng(seed)
    # ground track: inclined great-circle-ish path
    t = np.linspace(0.0, 1.0, n_scans)
    track_lat = -20.0 + 40.0 * t
    track_lon = 120.0 + 10.0 * t

    def cross_track(n, jitter):
        off = np.linspace(-swath_half_deg, swath_half_deg, n)
        return off + rng.normal(0, jitter, size=off.shape)

    # CrIS: n_scans × (FOR × FOV) field centres
    cris_lat, cris_lon = [], []
    for i in range(n_scans):
        offs = cross_track(cris_for_per_scan * cris_fov_per_for, 0.02)
        cris_lat.append(np.full_like(offs, track_lat[i]) + rng.normal(0, 0.05, offs.shape))
        cris_lon.append(track_lon[i] + offs)
    cris_lat = np.concatenate(cris_lat)
    cris_lon = np.concatenate(cris_lon)

    # VIIRS: denser sampling of the same swath
    viirs_lat, viirs_lon = [], []
    for i in range(n_scans):
        for line in range(viirs_lines_per_scan):
            offs = np.linspace(-swath_half_deg, swath_half_deg, viirs_pixels_per_scan)
            lat_line = track_lat[i] + (line - viirs_lines_per_scan / 2) * 0.01
            viirs_lat.append(np.full_like(offs, lat_line) + rng.normal(0, 0.003, offs.shape))
            viirs_lon.append(track_lon[i] + offs + rng.normal(0, 0.003, offs.shape))
    viirs_lat = np.concatenate(viirs_lat)
    viirs_lon = np.concatenate(viirs_lon)

    # satellite position above the mid-track point (single-position model),
    # computed in float32 and stored as float64, as the JAX package does
    sat_pos = geodetic_to_ecef(
        torch.tensor(track_lat.mean(), dtype=torch.float32),
        torch.tensor(track_lon.mean(), dtype=torch.float32),
        orbit_alt_m,
    ).numpy()
    # synthetic radiances to aggregate in the product
    viirs_rad = rng.standard_normal(viirs_lat.shape).astype(np.float32) + 5.0
    return {
        "cris_lat": cris_lat.astype(np.float32),
        "cris_lon": cris_lon.astype(np.float32),
        "viirs_lat": viirs_lat.astype(np.float32),
        "viirs_lon": viirs_lon.astype(np.float32),
        "viirs_rad": viirs_rad,
        "sat_pos": sat_pos.astype(np.float64),
    }


# ---------------------------------------------------------------------------
# geometry (stage 2)
# ---------------------------------------------------------------------------


def cris_los_ecef(cris_lat, cris_lon, sat_pos) -> torch.Tensor:
    """Unit line-of-sight vectors sat → CrIS FOV ground intersection, [M, 3]."""
    fov_pos = geodetic_to_ecef(cris_lat, cris_lon, 0.0)
    return _unit(fov_pos - sat_pos[None, :])


def viirs_pos_ecef(viirs_lat, viirs_lon) -> torch.Tensor:
    """VIIRS pixel ground positions in ECEF, [N, 3]."""
    return geodetic_to_ecef(viirs_lat, viirs_lon, 0.0)


# ---------------------------------------------------------------------------
# match (stage 3)
# ---------------------------------------------------------------------------


def _cos_threshold(half_angle_deg: float, device) -> torch.Tensor:
    half = torch.tensor(half_angle_deg, dtype=torch.float32, device=device)
    warm_cpu_math(half)
    return torch.cos(half * _DEG2RAD)


def match_viirs_to_cris(
    viirs_pos: torch.Tensor,  # [N, 3] ECEF
    cris_los: torch.Tensor,  # [M, 3] unit
    sat_pos: torch.Tensor,  # [3]
    *,
    half_angle_deg: float = CRIS_FOV_DIAMETER_DEG / 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each VIIRS pixel: (best CrIS index, best cosine, within-FOV mask).

    CUDA tensors go through the colocate kernel, CPU tensors through its
    plain version; a kernel failure raises.
    """
    u = _unit(viirs_pos - sat_pos[None, :]).to(torch.float32)
    idx, cos = colocate_match(u, cris_los.to(torch.float32))
    return idx, cos, cos >= _cos_threshold(half_angle_deg, cos.device)


def match_viirs_to_cris_ref(
    viirs_pos: torch.Tensor,
    cris_los: torch.Tensor,
    sat_pos: torch.Tensor,
    *,
    half_angle_deg: float = CRIS_FOV_DIAMETER_DEG / 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`match_viirs_to_cris` through the plain version on any device."""
    u = _unit(viirs_pos - sat_pos[None, :]).to(torch.float32)
    idx, cos = colocate_match_plain(u, cris_los.to(torch.float32))
    return idx, cos, cos >= _cos_threshold(half_angle_deg, cos.device)


# ---------------------------------------------------------------------------
# product (stage 4)
# ---------------------------------------------------------------------------


def build_product(granules: dict, idx: torch.Tensor, within: torch.Tensor) -> dict[str, Any]:
    """Aggregate matched VIIRS radiances per CrIS FOV (mean + count).

    The JAX package's ``segment_sum`` becomes ``index_add_``, which sums in
    another order: the means agree to float32 rounding, the counts exactly.
    """
    m = granules["cris_lat"].shape[0]
    dev = idx.device
    rad = granules["viirs_rad"]
    rad = rad.to(dev) if isinstance(rad, torch.Tensor) else numpy_to_tensor(rad, dev)
    w = within.to(torch.float32)
    seg = idx.to(torch.int64)
    counts = torch.zeros(m, dtype=torch.float32, device=dev).index_add_(0, seg, w)
    sums = torch.zeros(m, dtype=torch.float32, device=dev).index_add_(0, seg, rad * w)
    mean = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       torch.full_like(sums, math.nan))
    return {
        "cris_mean_rad": mean.cpu().numpy(),
        "cris_match_count": counts.to(torch.int32).cpu().numpy(),
        "matched_frac": float(w.mean()),
    }


# ---------------------------------------------------------------------------
# stage helpers for itineraries (state dict -> state dict)
# ---------------------------------------------------------------------------


def stage_read(state: dict, *, device: torch.device | str | None = None, seed: int = 0,
               **granule_kw) -> dict:
    """Stage 1: the granules as tensors on ``device`` (default: the CUDA card).
    float64 arrays become float32, as ``jnp.asarray`` makes them with x64 off."""
    dev = resolve_device(device)
    g = make_synthetic_granules(seed, **granule_kw)
    return {**state, **{
        k: numpy_to_tensor(v.astype(np.float32) if v.dtype == np.float64 else v, dev)
        for k, v in g.items()
    }}


def stage_geometry(state: dict) -> dict:
    """Stage 2: CrIS lines of sight and VIIRS positions, where the state lives."""
    los = cris_los_ecef(state["cris_lat"], state["cris_lon"], state["sat_pos"])
    pos = viirs_pos_ecef(state["viirs_lat"], state["viirs_lon"])
    return {**state, "los": los, "pos": pos}


def stage_match(state: dict) -> dict:
    """Stage 3: the match (K2 on the card)."""
    idx, _cos, within = match_viirs_to_cris(state["pos"], state["los"], state["sat_pos"])
    return {**state, "idx": idx, "within": within}


def stage_product(state: dict) -> dict[str, Any]:
    """Stage 4: the product of a matched state (host numpy arrays)."""
    return build_product(
        {"cris_lat": state["cris_lat"], "viirs_rad": state["viirs_rad"]},
        state["idx"], state["within"],
    )
