"""Device meshes (port of ``repro/launch/mesh.py``).

A FUNCTION, not a module-level constant: importing this module touches
no process group. Each mesh is ``init_device_mesh(device_type, shape,
mesh_dim_names=axes)`` over the process group the caller initialised
(``torch.distributed.init_process_group``; ``torchrun`` or spawned
processes), one rank a device, ranks laid out row-major over the axes.

The production layout keeps the reference's axes: ``(data=16,
model=16)`` on one pod, ``(pod=2, data=16, model=16)`` over two, the pod
axis carrying only batch (pure data-parallel gradient reduction) unless
the rules opt into FSDP over it (``sharding/logical.py``). The H100
constants the smoke run's roofline uses stay in ``chip_smoke.py``.
"""
from __future__ import annotations


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A mesh of the given shape and axis names over the initialised
    process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *,
                    device_type: str = "cpu"):
    """Small mesh for multi-process tests (``gloo`` on the CPU)."""
    return make_mesh(shape, axes, device_type=device_type)


def ep_degree(mesh) -> int:
    """Expert-parallel width of a mesh: the size of the EP a2a axis
    (``sharding/logical.py`` EP_AXIS, i.e. ``model``); 1 when absent."""
    from repro_torch.sharding.logical import EP_AXIS, mesh_shape

    return mesh_shape(mesh).get(EP_AXIS, 1)
