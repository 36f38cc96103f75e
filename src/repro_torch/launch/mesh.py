"""Production and debug meshes. Functions, not module-level constants:
importing this module touches no device and no process group.

Port of the JAX package's ``repro/launch/mesh.py``: each function returns
an ``init_device_mesh`` over the process group's ranks (one rank per
device), so the default group must be initialised first, with as many
ranks as the mesh has devices. The device type is ``"cuda"`` (one card a
rank) unless the caller asks for the CPU (``gloo``).
"""

from __future__ import annotations


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str = "cuda"):
    """A ``shape`` mesh with axes ``names`` over the default group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 ``("data", "model")`` (256 devices) or 2×16×16 with ``"pod"``
    (512 devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type)


def make_debug_mesh(n_data: int = 0, n_model: int = 1, *, device_type: str = "cuda"):
    """A small ``("data", "model")`` mesh over the process group's ranks
    (``n_data`` 0: as many as the world size allows)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n_data <= 0:
        n_data = max(1, n // n_model)
    return make_mesh((n_data, n_model), ("data", "model"), device_type)
