"""``--explain``: print the plan, never run it.

Counterpart of ``avenir_tpu/plan/explain.py``; ``render`` and
``plan_json`` give the JAX package's text letter for letter. The probe
is the cache's ``contains``, which touches no statistics: explaining a
plan twice shows the same hits and misses.
"""

from __future__ import annotations

from typing import Dict, Optional

from avenir_tpu_torch.plan.cache import staged_cache
from avenir_tpu_torch.plan.graph import Plan


def probe(plan: Plan) -> Dict[str, Optional[str]]:
    """node name -> "hit" | "miss" (cacheable nodes) | None."""
    cache = staged_cache() if plan.cache_enabled else None
    out: Dict[str, Optional[str]] = {}
    for node in plan.nodes:
        if node.fingerprint is None:
            out[node.name] = None
        elif cache is not None and cache.contains(node.cache_key):
            out[node.name] = "hit"
        else:
            out[node.name] = "miss"
    return out


def plan_json(plan: Plan) -> dict:
    return plan.to_json(probes=probe(plan))


def render(plan: Plan) -> str:
    probes = probe(plan)
    lines = [f"plan {plan.verb}: {len(plan.nodes)} nodes, cache "
             f"{'on' if plan.cache_enabled else 'off'}"]
    width = max(len(n.name) for n in plan.nodes)
    for node in plan.nodes:
        bits = [f"  [{node.kind:<6}] {node.name:<{width}}"]
        if node.inputs:
            bits.append("<- " + ",".join(node.inputs))
        if node.output:
            bits.append(f"-> {node.output}:{node.edge_type}")
        if node.fingerprint:
            bits.append(f"fp={node.fingerprint[:12]} "
                        f"cache={probes[node.name]}")
        if node.fused:
            bits.append("fused")
        if node.journal:
            j = node.journal
            bits.append(f"journal={j.get('dir')} shards={j.get('shards')}"
                        f" resume={j.get('resume')}")
        if node.ingest:
            g = node.ingest
            bits.append(f"ingest=parallel workers={g.get('workers')} "
                        f"splits={g.get('splits')} "
                        f"split_bytes={g.get('split_bytes')}")
        if node.ann:
            a = node.ann
            ann_bits = [f"ann={'live' if a.get('live') else 'ivf'} "
                        f"nlist={a.get('nlist')} nprobe={a.get('nprobe')} "
                        f"index={a.get('source')}"]
            if a.get("version") is not None:
                ann_bits.append(f"v={a['version']} "
                                f"tail_fill={a['tail_fill']} "
                                f"swaps={a['swaps']}")
            bits.append(" ".join(ann_bits))
        lines.append(" ".join(bits))
        if node.detail:
            lines.append(" " * 12 + node.detail)
        if node.ann and node.ann.get("reason"):
            lines.append(" " * 12 + node.ann["reason"])
    lines.append("edges:")
    for node in plan.nodes:
        if node.output is None:
            continue
        consumers = plan.consumers(node.output) or ["(terminal)"]
        lines.append(f"  {node.output} ({node.edge_type}): "
                     f"{node.name} -> {', '.join(consumers)}")
    return "\n".join(lines)
