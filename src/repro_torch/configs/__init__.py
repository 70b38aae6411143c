"""Architecture configs: one module per assigned architecture.

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
smoke tests.  ``ARCHS`` lists all assigned architecture ids.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, get_config, get_smoke_config, ARCHS

__all__ = ["ArchConfig", "MoEConfig", "get_config", "get_smoke_config", "ARCHS"]
