"""RG-LRU linear recurrence: CUDA kernel (``csrc/``), wrapper (``ops``)
and its plain PyTorch version (``ref``).  Importing builds nothing: the
kernel is built at its first launch."""
from repro_torch.kernels.rglru.ops import rglru_scan

__all__ = ["rglru_scan"]
