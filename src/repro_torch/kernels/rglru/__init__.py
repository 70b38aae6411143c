"""RG-LRU linear recurrence: CUDA kernel (``csrc/``), wrapper (``ops``)
and its plain PyTorch version (``ref``)."""
