"""Streaming serving: the online bandit loop, the serving engine and
their queue adapters.

Counterpart of ``avenir_tpu/stream/``: ``OnlineLearnerLoop`` (the
reference's ReinforcementLearnerBolt around one learner), ``LoopStats``,
``ServingEngine`` (the pipelined bolt) with ``EngineStats`` and
``AdmissionControl``, ``InProcQueues`` and the Redis-wire ``RedisQueues``
(``miniredis`` is a broker and client that speak that wire). The grouped
learner and engine, the broker fleet and the scale-out workers are not
ported yet.
"""

from avenir_tpu_torch.stream.engine import (
    AdmissionControl, EngineStats, ServingEngine)
from avenir_tpu_torch.stream.loop import (
    InProcQueues, LoopStats, OnlineLearnerLoop, RedisQueues)

__all__ = ["AdmissionControl", "EngineStats", "InProcQueues", "LoopStats",
           "OnlineLearnerLoop", "RedisQueues", "ServingEngine"]
