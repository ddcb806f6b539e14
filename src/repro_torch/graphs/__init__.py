"""Task-dependency graphs: ``DagSpec`` carrier, generators, topo utilities."""

from .dag import DAG_KINDS, DagSpec, make_dag

__all__ = ["DagSpec", "make_dag", "DAG_KINDS"]
