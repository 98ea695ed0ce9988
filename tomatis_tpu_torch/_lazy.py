"""PEP 562 lazy names for the package's __init__ files.

The package's public names live in modules that import torch. Resolving
them at first touch keeps `import tomatis_tpu_torch` and the host-only
sub-packages (io, native, and ops.wire) free of torch and of a CUDA
context.
"""
from __future__ import annotations

import importlib


def lazy_getattr(package: str, table: dict):
    """A module-level __getattr__ for `package`: table maps each lazy name
    to (module, attribute), or to (module, None) for the module itself."""
    def __getattr__(name):
        if name not in table:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        mod, attr = table[name]
        m = importlib.import_module(mod)
        return m if attr is None else getattr(m, attr)
    return __getattr__
