"""Device and dtype resolution.

Entry points take an explicit device name and run on ``cuda`` unless the
caller asks for ``cpu``. Nothing here looks at ``torch.cuda.is_available()``
to pick a device quietly: asking for ``cuda`` on a machine without a card
is an error.
"""
from __future__ import annotations

import torch

# the reference's dtype names (``ArchConfig.dtype``, wire dtypes) -> torch
DTYPES: dict[str, torch.dtype] = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}")


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device(name)``; raises if CUDA is asked for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available "
            "(pass device='cpu' to run on the CPU)")
    return dev
