"""Boundary-vertex replication: mirror hot boundary vertices into neighbours
(port of ``repro.serve.graph.replication``).

A vertex ``v`` owned by partition ``q`` is a *boundary* vertex for partition
``p`` when some vertex of ``p`` has an edge to ``v``. Every 2-hop query that
is mastered at ``p`` and reaches ``v`` in its first hop must ship an RPC to
``q`` to scan ``v``'s adjacency - the dominant cross-partition cost of the
serving layer. Replicating ``v``'s record (property + adjacency list) into
``p`` removes that RPC for every such query, at the storage cost of one more
copy of ``v``'s adjacency.

:func:`plan_replication` chooses which ``(vertex, partition)`` replica pairs
to materialize under a budget, greedily by *demand*: the number of cut edges
from partition ``p`` into ``v`` (an unbiased proxy for how often a ``p``-
mastered traversal will need ``v``, exact under a uniform seed distribution
and a strong signal under the degree-biased LDBC mix, since high-degree
boundary vertices accumulate demand from many neighbours). Ties break on the
replica key so the plan is deterministic for a given assignment.

The plan never changes query *answers* - a replica is a byte-identical copy
of the owner's adjacency row - only where the scan happens. Tests pin this
bit-parity across budgets.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ReplicationPlan", "plan_replication", "resolve_budget"]


@dataclasses.dataclass(frozen=True)
class ReplicationPlan:
    """Chosen replicas: ``vertices[i]`` is mirrored into ``partitions[i]``.

    ``demand[i]`` is the number of cut edges that replica absorbs (how many
    (p-vertex -> v) edges stop needing the owner). ``adjacency_entries`` is
    the total number of adjacency entries mirrored - the storage bill.
    """

    k: int
    budget_pairs: int
    vertices: np.ndarray  # int64[R]
    partitions: np.ndarray  # int64[R] destination partition of each replica
    demand: np.ndarray  # int64[R] cut edges covered by each replica
    adjacency_entries: int

    @property
    def num_replicas(self) -> int:
        return int(self.vertices.shape[0])

    def replicas_into(self, p: int) -> np.ndarray:
        """Sorted vertex ids replicated into partition ``p``."""
        return np.sort(self.vertices[self.partitions == p])

    def stats(self) -> dict:
        return {
            "budget_pairs": self.budget_pairs,
            "num_replicas": self.num_replicas,
            "demand_covered": int(self.demand.sum()),
            "adjacency_entries": self.adjacency_entries,
        }


def resolve_budget(budget: float, num_vertices: int) -> int:
    """``replication_budget`` semantics: a value in ``(0, 1)`` is a fraction
    of ``|V|`` replica pairs; ``>= 1`` is an absolute pair count; ``0`` means
    no replication."""
    if budget < 0:
        raise ValueError(f"replication_budget must be >= 0, got {budget!r}")
    if budget == 0:
        return 0
    if budget < 1:
        return int(budget * num_vertices)
    return int(budget)


def plan_replication(graph, assignment, k: int, budget: float) -> ReplicationPlan:
    """Greedy demand-ordered boundary replication under ``budget`` pairs."""
    assignment = np.asarray(assignment, dtype=np.int64)
    pairs = resolve_budget(float(budget), graph.num_vertices)
    empty = np.empty(0, dtype=np.int64)
    if pairs == 0 or graph.num_edges == 0 or k < 2:
        return ReplicationPlan(k, pairs, empty, empty, empty, 0)
    edges = graph.edges_array()  # (|E|, 2), each undirected edge once
    pu, pv = assignment[edges[:, 0]], assignment[edges[:, 1]]
    cut = pu != pv
    if not cut.any():
        return ReplicationPlan(k, pairs, empty, empty, empty, 0)
    # demand keys: replicating v into part(u) covers edge (u, v); both
    # directions of every cut edge generate one candidate pair
    cand_v = np.concatenate([edges[cut, 1], edges[cut, 0]])
    cand_p = np.concatenate([pu[cut], pv[cut]])
    key = cand_v * np.int64(k) + cand_p
    uniq, demand = np.unique(key, return_counts=True)
    # highest demand first; ties break on the key for determinism
    order = np.lexsort((uniq, -demand))[:pairs]
    chosen = uniq[order]
    verts = chosen // k
    dests = chosen % k
    adjacency_entries = int(np.diff(graph.indptr)[verts].sum())
    return ReplicationPlan(
        k=k,
        budget_pairs=pairs,
        vertices=verts.astype(np.int64),
        partitions=dests.astype(np.int64),
        demand=demand[order].astype(np.int64),
        adjacency_entries=adjacency_entries,
    )
