"""A step's live device bytes, counted storage by storage (the port's
counterpart of XLA's buffer assignment and ``compiled.memory_analysis()``,
which ``repro/launch/dryrun.py`` reads).

The port is eager PyTorch: every buffer a step allocates is the output
of an ATen op, which a ``TorchDispatchMode`` sees, and autograd's saved
tensors, ``torch.utils.checkpoint``'s recompute and the optimizer's
updates all run through ATen. :class:`LiveBytes` counts each new storage
once, when the op that made it returns (a view or an in-place op adds
nothing), at the caching allocator's granularity (its bytes rounded up
to :data:`GRANULE`), and releases it when it is freed, through a weakref
callback on the storage: no scan of the live storages after an op. It
runs on any device; on the meta device (the dry run) nothing is
allocated, and the count is that of the card running the same ops.

:func:`measure` runs a step under it and reports:

* ``argument_bytes``: the storages that existed on entry (the step's
  arguments), their exact bytes;
* ``output_bytes``: the storages of the returned tree that are not
  arguments, their exact bytes (a leaf updated in place is an
  argument);
* ``peak_bytes``: the most bytes live at once, arguments included, at
  the allocator's granularity;
* ``temp_bytes``: ``peak_bytes`` less the arguments and the outputs, so
  that ``argument_bytes + temp_bytes + output_bytes == peak_bytes == total_bytes``
  (the reference's sum);
* ``at_peak``: the live storages at the peak grouped by the op that
  made each and the port's function running then (the innermost frame
  in ``repro_torch``; in the backward the autograd node), the
  :data:`TOP` largest groups.
"""
from __future__ import annotations

import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

GRANULE = 512  # the CUDA caching allocator rounds every block up to this
TOP = 10
_PACKAGE = "/repro_torch/"
_SELF = "/launch/memory.py"


def rounded(nbytes: int) -> int:
    """Bytes the caching allocator holds for a storage of ``nbytes``."""
    return -(-nbytes // GRANULE) * GRANULE


def _where() -> str:
    """The running autograd node in a backward, else the innermost
    frame of the port: ``module.function``."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward:{node.name()}"
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if _PACKAGE in name and not name.endswith(_SELF):
            return f"{f.f_globals.get('__name__', '?')}.{f.f_code.co_name}"
        f = f.f_back
    return "?"


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class LiveBytes(TorchDispatchMode):
    """Counts the live storages of the ops run under it (see the module
    docstring). :meth:`add_arguments` registers the storages a step
    starts with; :meth:`report` reads the counts."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._t = 0  # one tick per allocation and per free
        self._peak_t = 0
        self._records = []  # [bytes, op, where, t_alloc, t_free, weakref]
        self._by_key: dict = {}
        self._args: set = set()
        self._closed = False

    def _track(self, st, op: str, where: str) -> None:
        key = st._cdata
        if key in self._by_key:
            return
        rec = [rounded(st.nbytes()), op, where, self._t, None, None]

        def freed(_, rec=rec, key=key):
            if self._closed:
                return
            self._t += 1
            rec[4] = self._t
            self.live -= rec[0]
            self._by_key.pop(key, None)

        rec[5] = weakref.ref(st, freed)
        self._by_key[key] = rec
        self._records.append(rec)
        self._t += 1
        self.live += rec[0]
        if self.live > self.peak:
            self.peak, self._peak_t = self.live, self._t

    def add_arguments(self, tree) -> int:
        """Register the storages of ``tree``'s tensors as arguments;
        returns their exact bytes (each storage once)."""
        n = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self._by_key:
                self._track(st, "argument", "argument")
                self._args.add(st._cdata)
                n += st.nbytes()
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            fresh = [t for t in _tensors(out)
                     if t.untyped_storage()._cdata not in self._by_key]
            if fresh:
                where = _where()
                for t in fresh:
                    self._track(t.untyped_storage(), str(func), where)
        return out

    def output_bytes(self, tree) -> int:
        """Exact bytes of ``tree``'s storages that are not arguments."""
        seen, n = set(), 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self._args and st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
        return n

    def at_peak(self, top: int = TOP) -> list:
        """The live storages at the peak, grouped by (op, where), the
        ``top`` largest groups: [{"op", "where", "bytes", "count"}]."""
        groups: dict = {}
        t = self._peak_t
        for nbytes, op, where, t0, t1, _ in self._records:
            if t0 < t and (t1 is None or t1 > t):
                g = groups.setdefault((op, where), [0, 0])
                g[0] += nbytes
                g[1] += 1
        ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]
        return [{"op": op, "where": where, "bytes": b, "count": c}
                for (op, where), (b, c) in ranked]

    def close(self) -> None:
        """Stop counting frees (storages that outlive the step)."""
        self._closed = True


def measure(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under :class:`LiveBytes`. Returns (its
    result, the report: ``argument_bytes``, ``output_bytes``,
    ``temp_bytes``, ``peak_bytes``, ``total_bytes``, ``at_peak``)."""
    mode = LiveBytes()
    arg_b = mode.add_arguments((args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    out_b = mode.output_bytes(out)
    report = {
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": mode.peak - arg_b - out_b,
        "peak_bytes": mode.peak,
        "total_bytes": mode.peak,
        "at_peak": mode.at_peak(),
    }
    mode.close()
    return out, report
