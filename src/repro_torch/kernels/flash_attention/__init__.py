"""Prefill and decode attention: CUDA kernels (``csrc/``), wrappers
(``ops``) and their plain PyTorch versions (``ref``)."""
