"""The paper's InfiniBand data-path simulator (the port's own copy of
``repro.core.ibsim``): the cost model, the event-driven sender simulator
in virtual time, the Section-IV message-rate benchmark, and the
serially-held ``Resource`` timeline the fleet's dispatch channels lock
through."""

from repro_torch.core.ibsim.benchmark import (MessageRateResult,
                                              category_rate, category_table,
                                              message_rate)
from repro_torch.core.ibsim.costmodel import (ALL_FEATURES, CONSERVATIVE,
                                              BufferConfig, CostModel,
                                              Features)
from repro_torch.core.ibsim.engine import Resource, SimResult, Simulator

__all__ = [
    "CostModel", "Features", "BufferConfig", "Simulator", "SimResult",
    "message_rate", "MessageRateResult", "Resource", "ALL_FEATURES",
    "CONSERVATIVE", "category_rate", "category_table",
]
