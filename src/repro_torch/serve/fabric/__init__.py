"""Serving fabric (DESIGN.md §9, §11).

The port's own copy of ``repro.serve.fabric``, as far as the single
engine needs it: the fabric cost model ``FabricCosts``, whose decode-step
cost lays out the single engine's request spans, and the placement
policies' names, which ``connect`` checks.  The router, the dispatch
channels, the workers, traffic and faults come with the fleet slice.
"""

from repro_torch.serve.fabric.placement import POLICIES
from repro_torch.serve.fabric.router import FabricCosts

__all__ = ["FabricCosts", "POLICIES"]
