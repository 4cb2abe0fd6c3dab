"""PyTorch / CUDA port of the consensus-ADMM trainer (``repro`` is the JAX
reference it is held to).

The package imports ``torch`` and numpy only. Its layout mirrors the
reference's so that every module's counterpart is easy to find:
``configs/``, ``core/``, ``kernels/``, ``wire/``, ``optim/``, ``models/``,
``data/`` and ``launch/``. Hand-written CUDA kernels live under
``kernels/csrc/`` and are compiled with ``nvcc`` at first use; nothing is
built or imported from CUDA when this package is imported.
"""
from repro_torch.device import DTYPES, resolve_device, torch_dtype

__all__ = ["DTYPES", "resolve_device", "torch_dtype"]
