"""The plan's node and edge model.

Counterpart of ``avenir_tpu/plan/graph.py`` (pure Python, copied). A
:class:`Plan` is a short list of :class:`PlanNode`\\ s in topological
order. Edges are named, typed values ("train.table" of type
``staged-table``): a node names the edges it consumes and the one it
produces, and the scheduler passes the values through a dict, so a
node's output can be cached and its run skipped.

Node kinds:

``encode``   host-side parse and featurizer preparation
``stage``    the encoded table or binned catalog on the device (the
             cacheable kind: it carries a fingerprint)
``kernel``   the verb's compute (train / classify / distributions)
``reduce``   host-side folds over kernel output (scores, validation)
``write``    output (model files, prediction files, stdout JSON)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

Runner = Callable[[Dict[str, Any]], Any]

NODE_KINDS = ("encode", "stage", "kernel", "reduce", "write")


@dataclasses.dataclass
class PlanNode:
    """One unit of work. ``run(values)`` receives the edge dict and
    returns the produced edge value (or None for sink nodes)."""

    name: str                       # e.g. "stage:train"
    kind: str                       # one of NODE_KINDS
    run: Runner
    inputs: Tuple[str, ...] = ()    # edge names consumed
    output: Optional[str] = None    # edge name produced (None = sink)
    edge_type: Optional[str] = None  # type of the produced edge
    # content-addressed cache key (None = not cacheable). A hit returns
    # the cached edge value and skips this node's run AND every node
    # named in skips_on_hit (its now-dead producers).
    fingerprint: Optional[str] = None
    skips_on_hit: Tuple[str, ...] = ()
    # the device the cached value lives on ("cpu", "cuda:0"): the cache
    # keys on the fingerprint AND the device, so a table staged for one
    # device never serves a job that asked for another. The fingerprint
    # itself stays the JAX package's digest (--explain prints it).
    device: Optional[str] = None
    # fusion marker: this node's device work overlaps H2D with compute
    # through one DeviceFeed instead of materializing an intermediate
    fused: bool = False
    # ShardJournal retry/resume as a node property:
    # {"dir": ..., "shards": N, "resume": bool, "enabled": bool}
    journal: Optional[Dict[str, Any]] = None
    # parallel cold-path ingest as an encode-node property:
    # {"workers": N, "splits": N, "split_bytes": B, "files": N,
    #  "queue_depth": D}. None = serial encode. Advisory only — the
    # fingerprint is unchanged (same bytes in -> same staged table out).
    ingest: Optional[Dict[str, Any]] = None
    # ANN index provenance on a knn kernel node: {"nlist",
    # "nprobe", "live", "source" ("cached"|"build"), "reason", and when
    # the live slot is warm its "version"/"tail_fill"/"swaps"}. None =
    # brute-force scoring. Advisory only, like ingest.
    ann: Optional[Dict[str, Any]] = None
    detail: str = ""                # one-line human note for --explain

    def __post_init__(self):
        if self.kind not in NODE_KINDS:
            raise ValueError(f"unknown plan node kind {self.kind!r} "
                             f"(expected one of {NODE_KINDS})")

    @property
    def cache_key(self) -> Optional[str]:
        """The staged cache's key: the fingerprint on its device (None =
        not cacheable)."""
        if self.fingerprint is None or self.device is None:
            return self.fingerprint
        return f"{self.fingerprint}@{self.device}"


class Plan:
    """Node container in construction (= topological) order, plus the
    per-plan cache switches the scheduler honors."""

    def __init__(self, verb: str, cache_enabled: bool = True,
                 cache_budget_bytes: Optional[int] = None):
        self.verb = verb
        self.nodes: List[PlanNode] = []
        self.cache_enabled = cache_enabled
        self.cache_budget_bytes = cache_budget_bytes
        # filled by the scheduler after execute(): node name ->
        # "ran" | "hit" | "miss" | "skipped"
        self.outcomes: Dict[str, str] = {}

    def add(self, **kwargs) -> PlanNode:
        node = PlanNode(**kwargs)
        if any(n.name == node.name for n in self.nodes):
            raise ValueError(f"duplicate plan node name {node.name!r}")
        missing = [e for e in node.inputs
                   if not any(n.output == e for n in self.nodes)]
        if missing:
            raise ValueError(
                f"plan node {node.name!r} consumes undeclared edge(s) "
                f"{missing} — producers must be added first")
        self.nodes.append(node)
        return node

    def node(self, name: str) -> PlanNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def consumers(self, edge: str) -> List[str]:
        return [n.name for n in self.nodes if edge in n.inputs]

    def to_json(self, probes: Optional[Dict[str, Optional[str]]] = None
                ) -> Dict[str, Any]:
        """The --explain / beside-``--metrics-out`` JSON form. ``probes``
        (node name -> "hit"|"miss"|None) comes from a NON-mutating cache
        probe so explaining a plan never perturbs hit statistics."""
        nodes = []
        for n in self.nodes:
            nodes.append({
                "name": n.name,
                "kind": n.kind,
                "inputs": list(n.inputs),
                "output": n.output,
                "edge_type": n.edge_type,
                "fingerprint": n.fingerprint,
                "cache": (probes or {}).get(n.name),
                "skips_on_hit": list(n.skips_on_hit),
                "fused": n.fused,
                "journal": n.journal,
                "ingest": n.ingest,
                "ann": n.ann,
                "detail": n.detail,
            })
        edges = [{"name": n.output, "type": n.edge_type,
                  "producer": n.name, "consumers": self.consumers(n.output)}
                 for n in self.nodes if n.output is not None]
        return {"verb": self.verb, "cache_enabled": self.cache_enabled,
                "nodes": nodes, "edges": edges}
