"""The plan scheduler: one pass over the nodes in order.

Counterpart of ``avenir_tpu/plan/scheduler.py``:

1. A probe of every cacheable node's fingerprint (no statistics touched);
   a hit marks the nodes it names in ``skips_on_hit`` (the encode that
   would feed it) skipped.
2. Each node runs inside a ``plan.<verb>.<node>`` span (free while the
   tracer is off). A cacheable node asks the cache first; a miss runs
   it and stores its value.
3. The cache's statistics publish as ``plan.cache.*`` gauges.

A hit returns the value the node would have computed (the fingerprint
covers every input, and the key adds the device the value lives on), so
no output can tell a warm cache from a cold one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from avenir_tpu_torch.obs import telemetry
from avenir_tpu_torch.parallel.ingest import take_last_stats
from avenir_tpu_torch.plan.cache import MISS, staged_cache
from avenir_tpu_torch.plan.graph import Plan

# last executed plan's (verb, outcomes) — introspection for tests and
# smokes that need per-node hit/miss without threading the plan out of
# the CLI entrypoint
_LAST: Optional[Dict[str, Any]] = None


def last_run() -> Optional[Dict[str, Any]]:
    """{"verb": ..., "outcomes": {node: "ran"|"hit"|"miss"|"skipped"}}
    of the most recent :func:`execute`, or None."""
    return _LAST


def execute(plan: Plan) -> Dict[str, Any]:
    """Run the plan; return the edge-value dict."""
    global _LAST
    cache = staged_cache() if plan.cache_enabled else None
    if cache is not None and plan.cache_budget_bytes is not None:
        cache.set_budget(plan.cache_budget_bytes)

    skipped = set()
    if cache is not None:
        for node in plan.nodes:
            if node.fingerprint and cache.contains(node.cache_key):
                skipped.update(node.skips_on_hit)

    values: Dict[str, Any] = {}
    outcomes: Dict[str, str] = {}
    for node in plan.nodes:
        if node.name in skipped:
            outcomes[node.name] = "skipped"
            continue
        with telemetry.span(f"plan.{plan.verb}.{node.name}"):
            if node.fingerprint and cache is not None:
                value = cache.get(node.cache_key)
                if value is not MISS:
                    outcomes[node.name] = "hit"
                else:
                    value = node.run(values)
                    cache.put(node.cache_key, value)
                    outcomes[node.name] = "miss"
            else:
                value = node.run(values)
                outcomes[node.name] = "ran"
        if node.output is not None:
            values[node.output] = value
    plan.outcomes = outcomes
    _LAST = {"verb": plan.verb, "outcomes": dict(outcomes)}
    # what the split encode pool recorded in this plan's stage nodes, by
    # table tag
    stats = take_last_stats()
    if stats:
        _LAST["ingest"] = stats
    if cache is not None:
        cache.publish_gauges()
    return values
