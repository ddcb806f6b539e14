"""Task-dependency DAGs: the ``DagSpec`` carrier plus topological utilities.

A :class:`DagSpec` records, for a workload of ``m`` tasks,

- the parent edges: ``child[i]`` depends on ``parent[i]`` (both are task
  indices into the workload's arrival order), and
- a dense per-task ``out_size``: the bytes a task materializes on the node
  that ran it, which children may have to fetch over the cluster link
  (``transfer = out_size / link_bandwidth`` — cf. Dask's worker-objective
  ``comm_cost``).

Validation is strict and happens at construction: edges must index real
tasks, self-loops and duplicate edges are rejected, and the graph must be
acyclic — a cycle is reported as a readable path (``cycle: 3 -> 7 -> 3``)
rather than a bare error, because cycles in converted traces are almost
always an upstream join bug worth seeing.

Topological utilities (``depth`` / ``width`` / ``critical_path`` /
``cp_lower_bound``) are one-pass dynamic programs over a cached topological
order; ``cp_lower_bound`` is the arrival-aware critical-path bound of Dutot
et al. — the earliest any schedule on this cluster could finish — against
which the engine normalizes makespan (``cp_stretch``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["DagSpec", "make_dag", "DAG_KINDS"]


def _as_idx(values, name: str) -> np.ndarray:
    arr = np.asarray(values, dtype=np.int64).reshape(-1)
    return arr if arr.size else np.zeros(0, dtype=np.int64)


@dataclass(frozen=True)
class DagSpec:
    """Parent edges plus per-task output sizes for one workload.

    ``child``/``parent`` are parallel int64 arrays of task indices
    (``child[i]`` cannot start until ``parent[i]`` completes); ``out_size``
    is dense over all ``m`` tasks (bytes produced; 0 = nothing to move).
    ``m`` is carried explicitly so an edgeless-but-declared DAG of 10 tasks
    is distinct from one of 20.
    """

    child: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    parent: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    out_size: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float64))
    m: int = 0

    def __post_init__(self):
        object.__setattr__(self, "child", _as_idx(self.child, "child"))
        object.__setattr__(self, "parent", _as_idx(self.parent, "parent"))
        out = np.asarray(self.out_size, dtype=np.float64).reshape(-1)
        object.__setattr__(self, "out_size", out)
        m = int(self.m) if self.m else out.size
        object.__setattr__(self, "m", m)
        if self.child.shape != self.parent.shape:
            raise ValueError(
                f"dag edge arrays disagree: {self.child.size} children vs "
                f"{self.parent.size} parents")
        if out.size not in (0, m):
            raise ValueError(
                f"dag out_size has {out.size} entries for {m} tasks")
        if out.size and (~np.isfinite(out) | (out < 0)).any():
            bad = int(np.flatnonzero(~np.isfinite(out) | (out < 0))[0])
            raise ValueError(
                f"dag out_size must be finite and >= 0; task {bad} has "
                f"{out[bad]}")
        if out.size == 0 and m:
            object.__setattr__(self, "out_size", np.zeros(m))
        if self.k:
            lo = min(self.child.min(), self.parent.min())
            hi = max(self.child.max(), self.parent.max())
            if lo < 0 or hi >= m:
                raise ValueError(
                    f"dag edge references task {lo if lo < 0 else hi} but "
                    f"the workload has tasks 0..{m - 1}")
            if (self.child == self.parent).any():
                t = int(self.child[self.child == self.parent][0])
                raise ValueError(f"dag has a self-loop: task {t} -> {t}")
            pairs = self.child * m + self.parent
            if np.unique(pairs).size != pairs.size:
                _, first = np.unique(pairs, return_index=True)
                dup = np.setdiff1d(np.arange(pairs.size), first)[0]
                raise ValueError(
                    f"dag has a duplicate edge: {self.parent[dup]} -> "
                    f"{self.child[dup]}")
        self._check_acyclic()

    # -- structure ---------------------------------------------------------

    @property
    def k(self) -> int:
        """Number of dependency edges."""
        return int(self.child.size)

    @property
    def empty(self) -> bool:
        return self.k == 0 and self.m == 0

    def parents_of(self) -> list[list[int]]:
        """Adjacency: ``parents_of()[t]`` lists the parents of task ``t``."""
        out: list[list[int]] = [[] for _ in range(self.m)]
        for c, p in zip(self.child.tolist(), self.parent.tolist()):
            out[c].append(p)
        return out

    def children_of(self) -> list[list[int]]:
        out: list[list[int]] = [[] for _ in range(self.m)]
        for c, p in zip(self.child.tolist(), self.parent.tolist()):
            out[p].append(c)
        return out

    def _check_acyclic(self) -> None:
        """Kahn's algorithm; on failure, walk the residual graph to print
        one concrete cycle instead of just declaring its existence."""
        order = self._topo_order()
        if order.size == self.m:
            object.__setattr__(self, "_topo", order)
            return
        in_cycle = np.ones(self.m, dtype=bool)
        in_cycle[order] = False
        parents = self.parents_of()
        start = int(np.flatnonzero(in_cycle)[0])
        # follow any still-cyclic parent until a node repeats
        path, seen = [start], {start: 0}
        node = start
        while True:
            node = next(p for p in parents[node] if in_cycle[p])
            if node in seen:
                cyc = path[seen[node]:] + [node]
                pretty = " -> ".join(str(t) for t in reversed(cyc))
                raise ValueError(f"dag has a cycle: {pretty}")
            seen[node] = len(path)
            path.append(node)

    def _topo_order(self) -> np.ndarray:
        """Kahn topological order (parents before children); may be partial
        when the graph is cyclic — callers compare its size against m."""
        indeg = np.zeros(self.m, dtype=np.int64)
        np.add.at(indeg, self.child, 1)
        children = self.children_of()
        frontier = list(np.flatnonzero(indeg == 0))
        order = []
        while frontier:
            t = frontier.pop()
            order.append(t)
            for c in children[t]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    frontier.append(c)
        return np.asarray(order, dtype=np.int64)

    @property
    def topo(self) -> np.ndarray:
        """Cached topological order (parents first)."""
        return self._topo  # set by _check_acyclic

    # -- topological measures ---------------------------------------------

    def levels(self) -> np.ndarray:
        """Per-task depth: 0 for roots, 1 + max parent level otherwise."""
        lv = np.zeros(self.m, dtype=np.int64)
        parents = self.parents_of()
        for t in self.topo.tolist():
            if parents[t]:
                lv[t] = 1 + max(lv[p] for p in parents[t])
        return lv

    def depth(self) -> int:
        """Number of levels on the longest chain (1 for an edgeless DAG of
        >= 1 task, 0 when empty)."""
        if self.m == 0:
            return 0
        return int(self.levels().max()) + 1

    def width(self) -> int:
        """Largest number of tasks sharing one level — an upper bound on
        useful parallelism at any instant of a level-synchronous schedule."""
        if self.m == 0:
            return 0
        return int(np.bincount(self.levels()).max())

    def critical_path(self, works=None) -> float:
        """Weight of the heaviest root-to-leaf chain. With ``works=None``
        every task weighs 1, so this is the longest chain in *tasks*."""
        if self.m == 0:
            return 0.0
        w = (np.ones(self.m) if works is None
             else np.asarray(works, dtype=np.float64))
        if w.size != self.m:
            raise ValueError(f"works has {w.size} entries for {self.m} tasks")
        finish = np.zeros(self.m)
        parents = self.parents_of()
        for t in self.topo.tolist():
            up = max((finish[p] for p in parents[t]), default=0.0)
            finish[t] = up + w[t]
        return float(finish.max())

    def cp_lower_bound(self, works, powers, t_arrive=None) -> float:
        """Arrival-aware critical-path lower bound on makespan.

        ``ef[t] = max(t_arrive[t], max over parents ef[p]) + work[t]/p_max``
        assumes every task runs on the fastest node with zero transfer or
        queueing — no schedule on this cluster finishes sooner. The area
        bound ``total_work / total_power`` is folded in, so the result is
        valid for both chain-dominated and volume-dominated workloads.
        """
        if self.m == 0:
            return 0.0
        w = np.asarray(works, dtype=np.float64)
        pw = np.asarray(powers, dtype=np.float64)
        if w.size != self.m:
            raise ValueError(f"works has {w.size} entries for {self.m} tasks")
        p_max = float(pw.max()) if pw.size else 0.0
        if p_max <= 0:
            return float("inf") if w.sum() > 0 else 0.0
        ta = (np.zeros(self.m) if t_arrive is None
              else np.asarray(t_arrive, dtype=np.float64))
        ef = np.zeros(self.m)
        parents = self.parents_of()
        for t in self.topo.tolist():
            up = max((ef[p] for p in parents[t]), default=0.0)
            ef[t] = max(float(ta[t]), up) + w[t] / p_max
        area = (float(ta.min()) if t_arrive is not None else 0.0) \
            + float(w.sum()) / float(pw.sum())
        return max(float(ef.max()), area)

    # -- serialization / re-indexing ---------------------------------------

    def to_dict(self) -> dict:
        return {
            "m": self.m,
            "edges": [[int(c), int(p)]
                      for c, p in zip(self.child, self.parent)],
            "out_size": [float(x) for x in self.out_size],
        }

    @classmethod
    def from_dict(cls, data: dict) -> "DagSpec":
        edges = data.get("edges", [])
        child = [e[0] for e in edges]
        parent = [e[1] for e in edges]
        return cls(child=child, parent=parent,
                   out_size=data.get("out_size", []),
                   m=int(data.get("m", 0)))

    def select(self, idx) -> "DagSpec":
        """Re-index onto the task subset ``idx`` (kept tasks, in their new
        order). Edges with either endpoint dropped are dropped — a clipped
        parent can no longer gate its child."""
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        new_id = np.full(self.m, -1, dtype=np.int64)
        new_id[idx] = np.arange(idx.size)
        keep = (new_id[self.child] >= 0) & (new_id[self.parent] >= 0) \
            if self.k else np.zeros(0, dtype=bool)
        return DagSpec(child=new_id[self.child[keep]],
                       parent=new_id[self.parent[keep]],
                       out_size=self.out_size[idx] if self.m else [],
                       m=int(idx.size))


# -- generators ------------------------------------------------------------


def _chain(m: int, rng: np.random.Generator, out_size: float) -> DagSpec:
    child = np.arange(1, m, dtype=np.int64)
    return DagSpec(child=child, parent=child - 1,
                   out_size=np.full(m, out_size), m=m)


def _diamond(m: int, rng: np.random.Generator, out_size: float) -> DagSpec:
    """1 source -> (m-2) parallel middles -> 1 sink (m >= 3)."""
    if m < 3:
        return _chain(m, rng, out_size)
    mids = np.arange(1, m - 1, dtype=np.int64)
    child = np.concatenate([mids, np.full(mids.size, m - 1)])
    parent = np.concatenate([np.zeros(mids.size, dtype=np.int64), mids])
    return DagSpec(child=child, parent=parent,
                   out_size=np.full(m, out_size), m=m)


def _fanin_fanout(m: int, rng: np.random.Generator, out_size: float,
                  fan: int = 4) -> DagSpec:
    """Repeating stages: 1 stage head fans out to ``fan`` workers which fan
    back into the next head — the map/reduce shape where locality pays."""
    child, parent = [], []
    head = 0
    t = 1
    while t < m:
        workers = list(range(t, min(t + fan, m)))
        for w in workers:
            child.append(w)
            parent.append(head)
        t += len(workers)
        if t < m:  # next head joins every worker of this stage
            for w in workers:
                child.append(t)
                parent.append(w)
            head = t
            t += 1
    return DagSpec(child=child, parent=parent,
                   out_size=np.full(m, out_size), m=m)


def _random_dag(m: int, rng: np.random.Generator, out_size: float,
                p: float = 0.15, max_parents: int = 3) -> DagSpec:
    """Each task picks Binomial parents uniformly among earlier tasks —
    acyclic by construction, shape varies with the scenario seed."""
    child, parent = [], []
    for t in range(1, m):
        n = int(min(rng.binomial(max_parents, p) if p < 1 else max_parents,
                    t))
        if n:
            for q in rng.choice(t, size=n, replace=False):
                child.append(t)
                parent.append(int(q))
    sizes = rng.exponential(out_size, size=m) if out_size else np.zeros(m)
    return DagSpec(child=child, parent=parent, out_size=sizes, m=m)


DAG_KINDS = {
    "chain": _chain,
    "diamond": _diamond,
    "fanin_fanout": _fanin_fanout,
    "random": _random_dag,
}


def make_dag(spec: dict, m: int, seed: int = 0) -> DagSpec:
    """Realize a DAG from a generator spec (or explicit edges) for a
    workload of ``m`` tasks.

    ``spec`` is either explicit — ``{"edges": [[child, parent], ...],
    "out_size": [...]}`` — or a generator — ``{"kind": "chain" | "diamond"
    | "fanin_fanout" | "random", "out_size": <scalar bytes>, ...}`` with
    kind-specific knobs (``fan`` for fanin_fanout, ``p``/``max_parents``
    for random). Generators are deterministic in ``seed``.
    """
    if not isinstance(spec, dict):
        raise TypeError(f"dag spec must be a dict, got {type(spec).__name__}")
    if "edges" in spec:
        data = dict(spec)
        data.setdefault("m", m)
        dag = DagSpec.from_dict(data)
        if dag.m != m:
            raise ValueError(
                f"explicit dag declares {dag.m} tasks but the workload "
                f"materialized {m}")
        return dag
    kind = spec.get("kind")
    if kind not in DAG_KINDS:
        raise ValueError(
            f"unknown dag kind {kind!r}; expected one of "
            f"{sorted(DAG_KINDS)} or explicit 'edges'")
    kwargs = {k: v for k, v in spec.items() if k not in ("kind", "out_size")}
    rng = np.random.default_rng(seed)
    if m == 0:
        return DagSpec(child=[], parent=[], out_size=[], m=0)
    return DAG_KINDS[kind](m, rng, float(spec.get("out_size", 0.0)), **kwargs)
