"""``BENCHMARK.json`` and the files it names, found by name.

A workload ``<config>.<traffic>`` resolves to ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``cells/<workload>.json``; a per-layer
metric ``<metric>`` to ``metrics/<metric>.py``; a configuration's family
to ``reference/<family>.py``.  Nothing here knows a cell by its name.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One workload with everything its run needs."""

    name: str
    entry: dict                  # its ``workloads`` entry
    cfg: dict                    # configs/<config>.json
    mix: dict                    # traffic/<traffic>.json
    data: dict                   # cells/<workload>.json
    end_to_end: List[dict]       # the metrics a --trace 0 run reports
    per_layer: List[dict]        # the metrics a --trace 1 run reports


def metric_applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: dict = None,
              here: Path = HERE) -> Cell:
    bench = bench if bench is not None else load_benchmark(here.parent)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_path = here.parent / configs[entry["config"]]["file"]
    return Cell(
        name=workload, entry=entry, cfg=_json(cfg_path),
        mix=_json(here / "traffic" / f"{entry['traffic']}.json"),
        data=_json(here / "cells" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if metric_applies(m, workload)],
        per_layer=[m for m in bench["per_layer"]
                   if metric_applies(m, workload)])


def reader(metric: str, here: Path = HERE):
    """``metrics/<metric>.py``'s ``read(records)``: the metric's value
    from a traced run's records, or None where they hold nothing to
    read."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference_model(family: str):
    """``reference/<family>.py``'s ``MODEL`` class."""
    return importlib.import_module(f"perfbench.reference.{family}").MODEL
