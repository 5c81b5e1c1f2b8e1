"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C function; it is compiled at
first use by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/`` at the repository root and loaded
with ``ctypes``. Libraries are named by a hash of their source, every
header in ``csrc`` and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. Nothing is built when a
module is imported: the CPU tests import every module.
"""
from __future__ import annotations

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
    plain PyTorch versions never touch it.
    """

    def __init__(self, name: str, symbol: str, argtypes: list, *,
                 source: str | None = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._err = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source, *sorted(CSRC.glob("*.cuh"))):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return build_dir() / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def _command(self, out: Path) -> list:
        nvcc = nvcc_path()
        # Find the toolkit's runtime when no runtime of its soname is
        # loaded yet.
        rpath = Path(nvcc).resolve().parents[1] / "lib64"
        return [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-Xlinker",
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

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream)
        and raise if ``cudaGetLastError()`` was not 0."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {rc} "
                f"({self._err(rc).decode()})"
            )
        self.launches += 1


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
