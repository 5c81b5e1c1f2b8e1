"""Back-compat shim (port of ``repro/training/serve.py``): the serving
engine lives in the ``repro_torch.serve`` package. Imports of the form
``from repro_torch.training.serve import ServeConfig, ServeEngine`` keep
working; new code should import from ``repro_torch.serve``.
"""
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: F401

__all__ = ["Request", "ServeConfig", "ServeEngine"]
