"""Production mesh builders (functions, never module-level constants: a
mesh needs its process group, which the caller starts).

Counterpart of ``repro.launch.mesh``: the same axis names and shapes, built
with ``torch.distributed.device_mesh.init_device_mesh`` over the process
group the caller initialized (one rank per device; the world size must be
the mesh's size).
"""
from __future__ import annotations


def _init(device, shape: tuple, axes: tuple):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device="cuda"):
    """Default 16x16 (one pod) or 2x16x16; ``shape`` overrides the dims -
    a 2-tuple maps to ('data', 'model'), a 3-tuple to ('pod', 'data',
    'model') - so the dry-run grid can run micro-meshes."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh shape must have 2 or 3 dims, got {shape}")
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return _init(device, shape, axes)


def make_local_mesh(device="cuda"):
    """1-device mesh with the same axis names (smoke tests / examples)."""
    return _init(device, (1, 1), ("data", "model"))


def axis_names(multi_pod: bool):
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)
