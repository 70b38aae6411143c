"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell (a model configuration under a traffic mix)::

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells and the
metrics; everything that belongs to one configuration, traffic mix, cell,
per-layer metric or reference family sits in a file of its own here,
found by that name:

* ``configs/<config>.json``: the sizes as run, their source and cuts;
* ``traffic/<mix>.json``: the parameters the one generator
  (``generator.py``) reads;
* ``cells/<workload>.json``: the plan a cell serves under, its fixed rate
  or client count, its sample sizes and the limits of its check;
* ``metrics/<metric>.py``: a reader of the traced run's records;
* ``reference/<family>.py``: plain fp32 PyTorch, which imports nothing of
  the program.

The benchmark takes from the program only the system under test
(``repro_torch.serve.connect`` and its engine) and the names of its
kernels.  It imports neither JAX nor the JAX package.
"""
