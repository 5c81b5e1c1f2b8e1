"""A step's counted FLOPs and bytes, and the model-FLOPs utilisation
(the counterpart of ``repro/launch/hlo_analysis.py``).

The reference parses the compiled HLO because XLA's ``cost_analysis``
counts a loop body once. There is no XLA here and so no HLO to parse:
the port counts what runs. :func:`step_cost` runs a step once under
``torch.utils.flop_counter.FlopCounterMode``, which counts the aten
products outside the kernels (PyTorch's dense GEMMs, and the plain
versions where those run), and under ``kernels.build.count_work``,
which adds each hand-written kernel's FLOPs and bytes from its work
model (``kernels/tiling.py``): the kernels are bound with ``ctypes``,
so FlopCounterMode cannot see them. On the meta device the kernels'
shape-only route records the same models (the dry run,
``launch/dryrun.py``). The aten ops' bytes are their operands read and
results written once an op (views excluded): eager traffic, with no
fusion, so an upper bound of what a fused program would move.

FlopCounterMode's dispatch mode adds host work to the step it counts,
so a step's time is taken from steps run outside it.

Utilisation follows the reference's convention (``dryrun.py``): model
FLOPs are 6 N D to train and 2 N D to infer, N the active parameters
and D the tokens. ``mfu`` divides them by the step's seconds times the
card's dense bf16 tensor-core peak (``launch/mesh.PEAK_FLOPS_BF16``,
989 TFLOP/s on the H100 data sheet) for every dtype, so a float32 step
on 3xTF32 tensor cores can never read above 1.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch.mesh import PEAK_FLOPS_BF16


class _AtenBytes(TorchDispatchMode):
    """Sums every non-view aten op's operand and result bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


def step_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once, counting. Returns (its result,
    the cost): ``aten_flops`` (FlopCounterMode's total), ``aten_bytes``,
    ``kernel_flops``, ``kernel_bytes`` and ``kernel_calls`` by kernel
    name (launches on the card; shape-only calls on the meta device),
    and ``total_flops`` = aten + kernels. The kernels' data-dependent
    work is read from the device once, when the count closes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.build import count_work

    with FlopCounterMode(display=False) as fc, _AtenBytes() as ab, \
            count_work() as work:
        out = fn(*args, **kwargs)
    aten = int(fc.get_total_flops())
    return out, {
        "aten_flops": aten,
        "aten_bytes": ab.bytes,
        "kernel_flops": dict(work.flops),
        "kernel_bytes": dict(work.bytes),
        "kernel_calls": dict(work.calls),
        "total_flops": aten + sum(work.flops.values()),
    }


def model_flops(cfg, kind: str, tokens: int, n_active: int | None = None):
    """6 N D for a train step, 2 N D for a prefill or decode step; N the
    active parameters (``specs.count_params(cfg)``'s by default), D the
    step's tokens."""
    if n_active is None:
        from repro_torch.launch.specs import count_params

        n_active = count_params(cfg)[1]
    return (6 if kind == "train" else 2) * n_active * tokens


def utilization(model: float, counted: float, step_s: float) -> dict:
    """``mfu`` (model FLOPs over step seconds x the bf16 peak),
    ``hardware_flops_util`` (counted FLOPs over the same) and
    ``useful_flops_ratio`` (model over counted, the reference's name)."""
    peak = step_s * PEAK_FLOPS_BF16
    return {"mfu": model / peak, "hardware_flops_util": counted / peak,
            "useful_flops_ratio": model / counted if counted else 0.0}
