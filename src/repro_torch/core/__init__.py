"""The paper's primary contribution, scalable communication endpoints (the
port's own copy of ``repro.core``): exact mlx5 resource accounting
(resources.py), the uUAR-to-QP assignment policy (policy.py), the six
scalable-endpoint categories and the sweep builders (endpoints.py), the
IB data-path simulator behind the paper's figures (ibsim/), sharing
plans and the planner (plan.py), dispatch plans (channels.py) and the
adaptive controller (adapt.py).
"""

from repro_torch.core.adapt import Replanner, WindowStats
from repro_torch.core.endpoints import (Category, EndpointModel, ThreadPath,
                                        build_cq_shared, build_ctx_shared,
                                        build_qp_shared, category_for_level,
                                        level_group_size, paper_categories,
                                        sharing_group_size)
from repro_torch.core.plan import (EndpointPlan, Hints, PRESETS,
                                   SharingVector, as_plan, resolve)
from repro_torch.core.resources import (ResourceUsage, TDSharing,
                                        naive_td_per_ctx_usage)

__all__ = [
    "Category", "EndpointModel", "EndpointPlan", "Hints", "PRESETS",
    "Replanner", "ResourceUsage", "SharingVector", "TDSharing",
    "ThreadPath", "WindowStats", "as_plan",
    "build_cq_shared", "build_ctx_shared", "build_qp_shared",
    "category_for_level", "level_group_size", "naive_td_per_ctx_usage",
    "paper_categories", "resolve", "sharing_group_size",
]
