"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C function; it is compiled at
first use by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/`` at the repository root and loaded
with ``ctypes``. Libraries are named by a hash of their source, every
header in ``csrc`` and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. Nothing is built when a
module is imported: the CPU tests import every module.

Inside a :func:`count_work` block every kernel call also adds its work
model (``kernels/tiling.py``) to the block's :class:`WorkCount`: a
launch on the card, and a call of a wrapper's shape-only route on the
meta device (the dry run's path, ``kernels/ops.py``). Outside the block
nothing is computed beyond the launch count.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# -cudart shared: the library binds to the CUDA runtime PyTorch has
# already loaded (same soname), so both launch through one runtime.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-cudart", "shared",
)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from source on the machine with the card"
        )
    return found


class Kernel:
    """One CUDA kernel: its source library, its C entry point, its
    ctypes binding (built on first use) and its launch count. Entry
    points of one source (``source`` names it, default ``name``) share
    one library.

    ``launches`` counts successful launches of the kernel itself; the
    plain PyTorch versions and the meta route never touch it. ``csrc``
    is the directory of the source and its headers (default: the
    package's own; a copy with an edit builds a variant beside the
    original).
    """

    def __init__(self, name: str, symbol: str, argtypes: list, *,
                 source: str | None = None, csrc: Path = CSRC):
        self.name = name
        self.csrc = Path(csrc)
        self.source = self.csrc / f"{source or name}.cu"
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._err = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source, *sorted(self.csrc.glob("*.cuh"))):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return build_dir() / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def _command(self, out: Path) -> list:
        nvcc = nvcc_path()
        # Find the toolkit's runtime when no runtime of its soname is
        # loaded yet.
        rpath = Path(nvcc).resolve().parents[1] / "lib64"
        return [nvcc, *NVCC_FLAGS, f"-I{self.csrc}", "-Xlinker",
                f"-rpath={rpath}", "-o", str(out), str(self.source)]

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def fn(self):
        if self._fn is None:
            build_all([self])
        return self._fn

    def launch(self, *args, work=None) -> None:
        """Call the C entry point (which launches on the given stream)
        and raise if ``cudaGetLastError()`` was not 0; then
        :meth:`record` ``work``."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {rc} "
                f"({self._err(rc).decode()})"
            )
        self.launches += 1
        if work is not None:
            self.record(work)

    def record(self, work) -> None:
        """Inside :func:`count_work`, add one call whose ``work()`` gives
        its (bytes, FLOPs); outside it ``work`` is not called."""
        if _COUNTER is not None:
            _COUNTER.add(self.name, *work())


class WorkCount:
    """The kernel calls of one :func:`count_work` block: ``calls``,
    ``bytes`` and ``flops`` by kernel name. A call's bytes and FLOPs
    are ints, or int64 device scalars where they depend on the data
    (ragged rows, slot lengths, lane starts): those are kept on their
    device and read together, once, when the block closes; ``bytes``
    and ``flops`` hold ints from then on."""

    def __init__(self):
        self.calls: dict = {}
        self.bytes: dict = {}
        self.flops: dict = {}

    def add(self, name: str, nbytes, flops) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes.setdefault(name, []).append(nbytes)
        self.flops.setdefault(name, []).append(flops)

    def _close(self) -> None:
        import torch

        tensors = {}  # device -> [values]
        for table in (self.bytes, self.flops):
            for vals in table.values():
                for v in vals:
                    if isinstance(v, torch.Tensor):
                        tensors.setdefault(v.device, []).append(v)
        read = {}
        for dev, vals in tensors.items():
            host = torch.stack([v.reshape(()) for v in vals]).cpu().tolist()
            read.update(zip(map(id, vals), host))
        for table in (self.bytes, self.flops):
            for name, vals in table.items():
                table[name] = sum(int(read[id(v)]) if isinstance(
                    v, torch.Tensor) else int(v) for v in vals)


_COUNTER: WorkCount | None = None


@contextlib.contextmanager
def count_work():
    """Count the kernels' work in the block: yields a :class:`WorkCount`
    whose totals are read when the block closes (one device-to-host copy
    a device). The kernels launch as they would outside the block; their
    results do not change. Blocks do not nest."""
    global _COUNTER
    if _COUNTER is not None:
        raise RuntimeError("count_work() blocks do not nest")
    counter = _COUNTER = WorkCount()
    try:
        yield counter
    finally:
        _COUNTER = None
    counter._close()


def build_all(kernels) -> float:
    """Build every missing library, one ``nvcc`` per source, all started
    together; then bind them all. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    queued = set()
    for k in kernels:
        lib = k.library_path()
        if lib.exists() or lib in queued:
            continue
        queued.add(lib)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            k._command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        procs.append((k, proc, tmp, lib))
    failed = []
    logs = {}
    for k, proc, tmp, lib in procs:
        logs[lib], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k.source.name}:\n{logs[lib]}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for k in kernels:
        k.build_log = logs.get(k.library_path(), k.build_log)
        if k._fn is None:
            k._bind()
    return time.perf_counter() - t0
