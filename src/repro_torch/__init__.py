"""PyTorch / CUDA port of the serving and training system (``repro`` is
the JAX reference it is held against).

The layout mirrors ``repro``: ``configs``, ``core`` (endpoint categories
and plans), ``models`` (params, layers, attention, transformer, model,
losses), ``kernels`` (hand-written CUDA kernels with their plain
versions), ``serve`` (slot and page pools, the continuous engine,
``connect``), the training side (``optim``, ``data``, ``checkpoint``,
``runtime``, ``comm`` (the endpoint-scheduled gradient sync), ``train``)
and ``launch`` (the serving and training CLIs, the step builders).  The
package imports torch and numpy only.
"""
