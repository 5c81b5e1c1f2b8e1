"""PyTorch + CUDA port of the ``repro`` sparse-upcycling system.

The port mirrors ``src/repro/`` module by module (each file names its
counterpart) and imports ``torch`` and numpy only — never ``jax`` and
nothing of ``repro``. Its hot kernels are hand-written CUDA C++ for
Hopper (``kernels/csrc``), built with ``nvcc`` at first use.

Entry points (``init_params``, ``init_paged_serve_cache``,
``ServeEngine``, ``launch/serve.py``) run on the card by default and
raise when no card is present, unless the caller asks for
``device="cpu"`` (the parity tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Asking for CUDA without a card raises — the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev
