"""Streaming serving: the online bandit loop and its queue adapters.

Counterpart of ``avenir_tpu/stream/``: ``OnlineLearnerLoop`` (the
reference's ReinforcementLearnerBolt around one learner), ``LoopStats``,
``InProcQueues`` and the Redis-wire ``RedisQueues`` (``miniredis`` is a
broker and client that speak that wire). The serving engine, the grouped
learner and the broker fleet are not ported yet.
"""

from avenir_tpu_torch.stream.loop import (
    InProcQueues, LoopStats, OnlineLearnerLoop, RedisQueues)

__all__ = ["InProcQueues", "LoopStats", "OnlineLearnerLoop", "RedisQueues"]
