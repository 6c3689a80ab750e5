"""Streaming serving: the online bandit loop, the serving engines, their
queue adapters and the broker fleet.

Counterpart of ``avenir_tpu/stream/``:

- ``loop``: ``OnlineLearnerLoop`` (the reference's
  ReinforcementLearnerBolt around one learner), ``LoopStats``,
  ``GroupedLearner`` (the multi-context ReinforcementLearnerGroup, one
  batched step for every context), ``InProcQueues`` and the Redis-wire
  ``RedisQueues``;
- ``engine``: ``ServingEngine`` (the pipelined bolt) with ``EngineStats``
  and ``AdmissionControl``, its ``BoostServingLearner`` and
  ``AnnServingLearner``, and ``GroupedServingEngine``;
- ``miniredis``: a broker and client that speak the Redis wire;
- ``fleet``: the consistent-hash group-to-shard router, the
  ``BrokerFleet`` client pool, the ``ShardedQueues`` fan-out transport
  and ``migrate_group_queues``;
- ``faultnet``: deterministic network fault injection over the MiniRedis
  client.

Not ported yet: the scale-out workers (``stream/scaleout.py``) and the
ownership rebalancer (``stream/rebalance.py``).
"""

from avenir_tpu_torch.stream.engine import (
    AdmissionControl, BoostServingLearner, EngineStats,
    GroupedServingEngine, ServingEngine)
from avenir_tpu_torch.stream.faultnet import FaultNet
from avenir_tpu_torch.stream.fleet import (
    BrokerFleet, ShardedQueues, consistent_route)
from avenir_tpu_torch.stream.loop import (
    GroupedLearner, InProcQueues, LoopStats, OnlineLearnerLoop, RedisQueues)

__all__ = ["AdmissionControl", "BoostServingLearner", "BrokerFleet",
           "EngineStats", "FaultNet", "GroupedLearner",
           "GroupedServingEngine", "InProcQueues", "LoopStats",
           "OnlineLearnerLoop", "RedisQueues", "ServingEngine",
           "ShardedQueues", "consistent_route"]
