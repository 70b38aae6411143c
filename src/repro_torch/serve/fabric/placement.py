"""Placement policies: which dispatch channel admits a new arrival.

For now only the policies' names, the set ``connect`` and
``ServeClient.replan`` check a plan's ``placement`` against, as
``repro.serve.fabric.placement.POLICIES`` does.  The policies themselves
(round robin, least loaded, session affinity) come with the fleet slice,
which keys them by the same names.
"""

from __future__ import annotations

#: the placement policies of ``repro.serve.fabric.placement``, by name
POLICIES = frozenset({"round_robin", "least_loaded", "session_affinity"})
