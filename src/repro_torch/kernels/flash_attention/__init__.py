"""Prefill and decode attention: CUDA kernels (``csrc/``), wrappers
(``ops``) and their plain PyTorch versions (``ref``).  Importing builds
nothing: a kernel is built at its first launch."""
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_decode_attention)

__all__ = ["flash_attention", "flash_decode_attention"]
