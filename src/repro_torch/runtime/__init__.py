"""Runtime policies (the port's copy of the part of ``repro.runtime`` the
serving recovery layer uses)."""

from repro_torch.runtime.fault_tolerance import StragglerMitigator

__all__ = ["StragglerMitigator"]
