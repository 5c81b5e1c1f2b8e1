"""Device meshes (port of ``repro/launch/mesh.py``).

A FUNCTION, not a module-level constant: importing this module touches
no process group. Each mesh is ``init_device_mesh(device_type, shape,
mesh_dim_names=axes)`` over the process group the caller initialised
(``torch.distributed.init_process_group``; ``torchrun`` or spawned
processes), one rank a device, ranks laid out row-major over the axes.

The production layout keeps the reference's axes: ``(data=16,
model=16)`` on one pod, ``(pod=2, data=16, model=16)`` over two, the pod
axis carrying only batch (pure data-parallel gradient reduction) unless
the rules opt into FSDP over it (``sharding/logical.py``).

The card's constants below, beside the mesh functions as the reference
keeps its v5e ones, are the published NVIDIA H100 SXM data sheet's
(dense rates, no sparsity, at the 700 W power limit). None of them is a
measurement: a card set below 700 W runs slower under load. The
kernels' bounds (``kernels/tiling.py``), the dry run's roofline
(``launch/dryrun.py``) and ``mfu`` (``launch/flops.py``) read them.
"""
from __future__ import annotations


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A mesh of the given shape and axis names over the initialised
    process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_mesh_shape(*, multi_pod: bool = False) -> dict:
    """``{axis: size}`` of the production layout: the rules and the dry
    run (``launch/specs.py``) take this mapping as a mesh, with no
    process group."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(tuple(shape.values()), tuple(shape),
                     device_type=device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *,
                    device_type: str = "cpu"):
    """Small mesh for multi-process tests (``gloo`` on the CPU)."""
    return make_mesh(shape, axes, device_type=device_type)


def ep_degree(mesh) -> int:
    """Expert-parallel width of a mesh: the size of the EP a2a axis
    (``sharding/logical.py`` EP_AXIS, i.e. ``model``); 1 when absent."""
    from repro_torch.sharding.logical import EP_AXIS, mesh_shape

    return mesh_shape(mesh).get(EP_AXIS, 1)


# H100 SXM data sheet (dense, 700 W); the reference's names where one
# exists.
PEAK_FLOPS_BF16 = 989e12  # bf16 / fp16 tensor cores, FLOP/s
PEAK_FLOPS_TF32 = 495e12  # TF32 tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12  # float32 on CUDA cores, FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80 * 10 ** 9  # HBM capacity (80 GB)
SM_COUNT = 132  # streaming multiprocessors of the SXM part
# NVLink 4: 900 GB/s a card in both directions together, 450 GB/s each
# way (the counterpart of the reference's per-link ICI_BW).
NVLINK_BW = 450e9
