"""The plan-graph execution layer.

Counterpart of ``avenir_tpu/plan``. The plan-capable CLI verbs
(``cli/plans.py``) build an explicit graph of encode / stage / kernel /
reduce / write nodes joined by typed edges, which the scheduler runs.
What lives once in the graph instead of in each verb:

- the content-addressed staged-table cache (:mod:`cache`): a stage node's
  fingerprint covers its input files, the schema and every encode key,
  so a ``BayesianDistribution`` then ``NearestNeighbor`` chain encodes the
  train table once;
- a ``plan.<verb>.<node>`` telemetry span a node;
- the parallel split ingest and the ``DeviceFeed`` as node properties
  (``ingest``, ``fused``), which ``--explain`` prints.

Every output is byte-identical to the hand-wired verb bodies, which stay
in ``cli/main.py`` as the ``plan.enable=false`` path.
"""

from avenir_tpu_torch.plan.cache import (StagedTableCache, reset_cache,
                                         staged_cache)
from avenir_tpu_torch.plan.graph import Plan, PlanNode
from avenir_tpu_torch.plan.scheduler import execute, last_run

__all__ = ["Plan", "PlanNode", "StagedTableCache", "execute", "last_run",
           "reset_cache", "staged_cache"]
