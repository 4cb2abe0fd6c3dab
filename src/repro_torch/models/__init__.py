"""Dense transformer model of the ported slices."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
