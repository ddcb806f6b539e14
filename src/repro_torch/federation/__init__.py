"""repro_torch.federation — the paper's recursion applied one level above a
cluster: N member clusters (one ``lab.Scenario`` each) balancing work
through a top-level positional rule over WAN-cost links.

Declare a federation once::

    from repro_torch import lab

    fed = lab.Federation(
        members=tuple(
            lab.Scenario(name=f"dc{i}", seed=i,
                         cluster=lab.ClusterSpec(n_nodes=8, power_seed=i),
                         workload=lab.WorkloadSpec(params={"rate": r}),
                         policy=lab.PolicySpec("psts"))
            for i, r in enumerate([12.0, 2.0, 2.0, 2.0])),
        topology=lab.TopologySpec(kind="full", bandwidth=8.0, latency=2.0),
        exchange_period=4.0)

then run it like any scenario: ``lab.run(fed, backend="federated")`` —
aggregate metrics in the canonical schema, per-member results and WAN
accounting in ``extras``. A link-free federation of uniform members
auto-lowers to one batched run on the CUDA device (``device="cpu"`` runs
it on the CPU); the event-driven path is host code.
"""

from .balancer import ExchangeStats, admit, choose_destination, choose_victim
from .specs import (
    EXCHANGE_POLICIES,
    FEDERATION_MODES,
    TOPOLOGY_KINDS,
    Federation,
    LinkSpec,
    TopologySpec,
)
from .runtime import (
    FederatedRuntime,
    FederationReport,
    WanMessage,
    aggregate_metrics,
)
from .backend import FederatedBackend

__all__ = [
    "Federation", "LinkSpec", "TopologySpec", "TOPOLOGY_KINDS",
    "FEDERATION_MODES", "EXCHANGE_POLICIES",
    "choose_destination", "choose_victim", "admit", "ExchangeStats",
    "FederatedRuntime", "FederationReport", "WanMessage",
    "aggregate_metrics", "FederatedBackend",
]
