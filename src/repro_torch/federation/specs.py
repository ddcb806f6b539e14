"""Federation specs: several clusters as data, like ``repro_torch.lab`` scenarios.

A :class:`Federation` is a frozen, JSON-round-trippable composition of N
member :class:`~repro_torch.lab.specs.Scenario` s (one Scenario per member
cluster, as the ROADMAP prescribes) with an inter-cluster topology. Each
directed :class:`LinkSpec` carries WAN bandwidth and latency, so migrating a
task from cluster ``src`` to cluster ``dst`` costs
``latency + packets / bandwidth`` time units — orders of magnitude above
intra-cluster migration, which is the reason federation needs admission
control rather than flat balancing (cf. co-allocation and redistribution
costs in Moise et al. 2011 and Casanova et al. 2011).

Round-trip contract matches ``Scenario``: ``Federation.from_json(f.to_json())``
is equal and shares ``fingerprint()``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, fields
from typing import Mapping

from ..lab.specs import Scenario, _SpecBase, _spec_hash, _thaw

__all__ = ["LinkSpec", "TopologySpec", "Federation", "TOPOLOGY_KINDS",
           "FEDERATION_MODES", "EXCHANGE_POLICIES"]


@dataclass(frozen=True)
class LinkSpec(_SpecBase):
    """One directed WAN link ``src -> dst`` between member clusters."""

    src: int
    dst: int
    bandwidth: float = 8.0  # packets per time unit across the WAN
    latency: float = 2.0  # propagation delay, time units

    def __post_init__(self):
        object.__setattr__(self, "src", int(self.src))
        object.__setattr__(self, "dst", int(self.dst))
        object.__setattr__(self, "bandwidth", float(self.bandwidth))
        object.__setattr__(self, "latency", float(self.latency))
        if self.src == self.dst:
            raise ValueError(f"link {self.src}->{self.dst} is a self-loop")
        if self.src < 0 or self.dst < 0:
            raise ValueError("link endpoints must be >= 0")
        if self.bandwidth <= 0:
            raise ValueError("link bandwidth must be > 0")
        if self.latency < 0:
            raise ValueError("link latency must be >= 0")

    def delay(self, packets: float) -> float:
        """Transfer delay for a payload of ``packets`` packets."""
        return self.latency + packets / self.bandwidth


TOPOLOGY_KINDS = ("isolated", "full", "ring", "star", "line", "explicit")


@dataclass(frozen=True)
class TopologySpec(_SpecBase):
    """Inter-cluster connectivity: a named generator (``full``/``ring``/
    ``star``/``line``/``isolated``) stamped with uniform link parameters,
    or ``explicit`` with the links given one by one."""

    kind: str = "full"
    bandwidth: float = 8.0
    latency: float = 2.0
    links: tuple[LinkSpec, ...] = ()

    def __post_init__(self):
        if self.kind not in TOPOLOGY_KINDS:
            raise ValueError(
                f"unknown topology kind {self.kind!r}; "
                f"have {sorted(TOPOLOGY_KINDS)}")
        if self.bandwidth <= 0:
            raise ValueError("topology bandwidth must be > 0")
        if self.latency < 0:
            raise ValueError("topology latency must be >= 0")
        links = tuple(
            link if isinstance(link, LinkSpec)
            else LinkSpec.from_dict(dict(link))
            for link in self.links)
        if links and self.kind != "explicit":
            raise ValueError(
                f"explicit links need kind='explicit', not {self.kind!r}")
        object.__setattr__(self, "links", links)

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        d = dict(d)
        if "links" in d:
            d["links"] = tuple(
                LinkSpec.from_dict(dict(x)) if isinstance(x, Mapping) else x
                for x in d["links"])
        return super().from_dict(d)

    def resolve(self, n: int) -> tuple[LinkSpec, ...]:
        """Concrete directed links for ``n`` member clusters."""
        if n < 1:
            raise ValueError("a federation needs at least one member")
        if self.kind == "explicit":
            for link in self.links:
                if link.src >= n or link.dst >= n:
                    raise ValueError(
                        f"link {link.src}->{link.dst} names a member "
                        f"outside 0..{n - 1}")
            return self.links
        pairs: list[tuple[int, int]] = []
        if self.kind == "isolated" or n == 1:
            pairs = []
        elif self.kind == "full":
            pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        elif self.kind == "ring":
            for i in range(n):
                pairs += [(i, (i + 1) % n), ((i + 1) % n, i)]
            pairs = sorted(set(pairs))
        elif self.kind == "star":
            for i in range(1, n):
                pairs += [(0, i), (i, 0)]
        else:  # line
            for i in range(n - 1):
                pairs += [(i, i + 1), (i + 1, i)]
        return tuple(
            LinkSpec(src=s, dst=d, bandwidth=self.bandwidth,
                     latency=self.latency)
            for s, d in pairs)


FEDERATION_MODES = ("async", "lockstep")
EXCHANGE_POLICIES = ("push", "stealing")


def _coerce_member(m):
    """Scenario | Federation | mapping -> Scenario | Federation. A mapping
    with a ``members`` key is a nested federation (recursion level k+2:
    racks -> clusters -> regions); anything else is one member cluster."""
    if isinstance(m, Scenario) or getattr(m, "is_federation", False):
        return m
    if isinstance(m, Mapping) and "members" in m:
        return Federation.from_dict(dict(m))
    return Scenario.from_dict(dict(m))


@dataclass(frozen=True)
class Federation(_SpecBase):
    """N member clusters exchanging work over WAN links.

    ``exchange_period`` is the top-level balancer's evaluation period (the
    federation-level analogue of ``PolicySpec.trigger_period``);
    ``admission_margin`` is the predicted completion-time gain, in time
    units, a WAN migration must clear to be admitted (reservation-style
    admission: 0 admits any predicted improvement).

    ``mode`` picks the driving engine: ``async`` (the default) advances
    members to their own next event with WAN hand-offs as timestamped
    in-flight messages; ``lockstep`` is the conformance-reference epoch
    stepper. ``exchange`` picks the balancing policy: positional ``push``
    (overloaded members send) or pull-based ``stealing`` (underloaded
    members request). Members may themselves be federations — the
    positional rule applies per level.
    """

    members: tuple = ()
    topology: TopologySpec = field(default_factory=TopologySpec)
    exchange_period: float = 4.0
    admission_margin: float = 0.0
    mode: str = "async"
    exchange: str = "push"
    name: str = ""

    # marker the lab backends key eligibility on (duck-typed to avoid an
    # import cycle between repro_torch.lab.backends and this module)
    is_federation = True

    def __post_init__(self):
        members = tuple(_coerce_member(m) for m in self.members)
        if not members:
            raise ValueError("a federation needs at least one member "
                             "Scenario")
        object.__setattr__(self, "members", members)
        if self.exchange_period <= 0:
            raise ValueError("exchange_period must be > 0")
        if self.admission_margin < 0:
            raise ValueError("admission_margin must be >= 0")
        if self.mode not in FEDERATION_MODES:
            raise ValueError(f"unknown federation mode {self.mode!r}; "
                             f"have {sorted(FEDERATION_MODES)}")
        if self.exchange not in EXCHANGE_POLICIES:
            raise ValueError(f"unknown exchange policy {self.exchange!r}; "
                             f"have {sorted(EXCHANGE_POLICIES)}")

    @property
    def n_members(self) -> int:
        return len(self.members)

    # -- serialization ------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "Federation":
        d = dict(d)
        if "members" in d:
            d["members"] = tuple(_coerce_member(m) for m in d["members"])
        if "topology" in d and isinstance(d["topology"], Mapping):
            d["topology"] = TopologySpec.from_dict(dict(d["topology"]))
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Federation: unknown fields {sorted(unknown)}")
        return cls(**d)

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Federation":
        return cls.from_dict(json.loads(text))

    def fingerprint(self) -> str:
        """Stable 16-hex-digit identity of the canonical JSON form (same
        contract as ``Scenario.fingerprint``: telemetry config is excluded,
        member-wise, so an instrumented federation shares the fingerprint
        of its un-instrumented twin)."""
        d = self.to_dict()
        _strip_obs(d)
        canon = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    # -- grid support -------------------------------------------------------
    def updated(self, assignments: dict) -> "Federation":
        """A copy with dotted-path fields replaced; numeric segments index
        the member list: ``{"members.0.seed": 3, "topology.bandwidth": 16}``.
        """
        d = self.to_dict()
        for path, value in assignments.items():
            node = d
            *parents, leaf = path.split(".")
            for p in parents:
                if isinstance(node, list):
                    node = node[int(p)]
                elif isinstance(node, dict) and isinstance(
                        node.get(p), (dict, list)):
                    node = node[p]
                else:
                    raise KeyError(f"no such federation section: {path!r}")
            if isinstance(node, list):
                node[int(leaf)] = _thaw(value)
            else:
                node[leaf] = _thaw(value)
        return Federation.from_dict(d)


def _strip_obs(fed_dict: dict) -> None:
    """Drop telemetry config member-wise, at every nesting level."""
    for member in fed_dict.get("members", []):
        if "members" in member:
            _strip_obs(member)
        else:
            member.pop("obs", None)


for _cls in (LinkSpec, TopologySpec, Federation):
    _cls.__hash__ = _spec_hash
