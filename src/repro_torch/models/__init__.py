"""Dense decoder models in eager PyTorch."""

from repro_torch.models.model import Model, resolve_device

__all__ = ["Model", "resolve_device"]
