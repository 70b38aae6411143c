"""PyTorch / CUDA port of the serving system (``repro`` is the JAX
reference it is held against).

The layout mirrors ``repro``: ``configs``, ``core`` (endpoint categories
and plans), ``models`` (params, layers, attention, transformer, model),
``kernels`` (hand-written CUDA kernels with their plain versions),
``serve`` (slot and page pools, the continuous engine, ``connect``) and
``launch`` (the serving CLI).  The package imports torch and numpy only.
"""
