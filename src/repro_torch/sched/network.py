"""Network cost model — per-location-pair bandwidth/latency.

A copy of ``repro/sched/network.py``.

SWIRL's stated purpose is the *automatic optimisation of data movements*;
deciding where steps should run requires an explicit model of what a
``send``/``recv`` between two locations costs.  :class:`NetworkModel` maps
ordered location pairs to :class:`Link` parameters (bandwidth in bytes/s,
latency in seconds) with three resolution layers, most specific first:

1. an explicit per-pair entry in ``links``;
2. the pair's *group* link — locations are partitioned into named groups
   (racks, host classes) and ``group_links`` prices each group pair;
3. the ``default`` link.

Intra-location movement is always free (``src == dst`` — exactly the
transfers rule R1 deletes).

Named presets cover the common topologies (the Bux & Leser SWfMS-scheduling
survey's machine models):

* ``uniform``          — every pair identical (a flat cluster);
* ``two-rack``         — fast intra-rack, slow inter-rack links; racks are
  given explicitly or assigned at :meth:`bind` time (sorted locations split
  in half);
* ``cpu+accelerator``  — a slow host tier and a fast accelerator tier joined
  by a PCIe-class link; the host tier is given explicitly or inferred from
  location names at :meth:`bind` time.

Presets that need the location set (``two-rack`` without ``racks=``,
``cpu+accelerator`` without ``cpu=``) stay *unbound* until
:meth:`NetworkModel.bind` is called with the system's locations —
``Plan.schedule`` and :func:`repro_torch.sched.simulate.simulate` bind
automatically.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable, Mapping


@dataclass(frozen=True)
class Link:
    """One directed link: ``transfer_s = latency + nbytes / bandwidth``."""

    bandwidth: float  # bytes per second
    latency: float = 0.0  # seconds

    def __post_init__(self) -> None:
        if self.bandwidth <= 0:
            raise ValueError(f"bandwidth must be positive: {self.bandwidth}")
        if self.latency < 0:
            raise ValueError(f"latency must be non-negative: {self.latency}")

    def transfer_s(self, nbytes: float) -> float:
        if self.bandwidth == float("inf"):
            return self.latency
        return self.latency + nbytes / self.bandwidth


#: The implicit intra-location link: moving data to yourself is free.
LOCAL_LINK = Link(bandwidth=float("inf"), latency=0.0)


@dataclass(frozen=True)
class NetworkModel:
    """Per-location-pair link parameters with group-level defaults."""

    default: Link = field(default_factory=lambda: Link(1e9, 100e-6))
    links: Mapping[tuple[str, str], Link] = field(default_factory=dict)
    groups: Mapping[str, frozenset[str]] = field(default_factory=dict)
    group_links: Mapping[tuple[str, str], Link] = field(default_factory=dict)
    #: Group assigned to locations not listed in any ``groups`` entry.
    open_group: str | None = None
    name: str = "custom"
    # Preset still awaiting the location set (see bind()).
    _pending: str | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "links", dict(self.links))
        object.__setattr__(
            self,
            "groups",
            {g: frozenset(ms) for g, ms in dict(self.groups).items()},
        )
        object.__setattr__(self, "group_links", dict(self.group_links))
        seen: dict[str, str] = {}
        for g, ms in self.groups.items():
            for l in ms:
                if l in seen:
                    raise ValueError(
                        f"location {l!r} is in groups {seen[l]!r} and {g!r}"
                    )
                seen[l] = g

    # -- resolution ---------------------------------------------------------
    def group_of(self, location: str) -> str | None:
        for g, members in self.groups.items():
            if location in members:
                return g
        return self.open_group

    def link(self, src: str, dst: str) -> Link:
        """The link used for a ``src -> dst`` transfer (LOCAL if same)."""
        if src == dst:
            return LOCAL_LINK
        hit = self.links.get((src, dst))
        if hit is not None:
            return hit
        gs, gd = self.group_of(src), self.group_of(dst)
        if gs is not None and gd is not None:
            hit = self.group_links.get((gs, gd)) or self.group_links.get(
                (gd, gs)
            )
            if hit is not None:
                return hit
        return self.default

    def transfer_s(self, nbytes: float, src: str, dst: str) -> float:
        """Seconds to move ``nbytes`` from ``src`` to ``dst``."""
        return self.link(src, dst).transfer_s(nbytes)

    # -- binding ------------------------------------------------------------
    def bind(self, locations: Iterable[str]) -> "NetworkModel":
        """Resolve a location-dependent preset against a concrete system.

        Idempotent: an already-bound (or never-pending) model returns a model
        with the same pricing.  Locations not covered by any group fall back
        to the ``default`` link.
        """
        locs = sorted(set(locations))
        if self._pending is None:
            return self
        if self._pending == "two-rack":
            half = (len(locs) + 1) // 2
            groups = {
                "rack0": frozenset(locs[:half]),
                "rack1": frozenset(locs[half:]),
            }
            return replace(self, groups=groups, _pending=None)
        if self._pending == "cpu+accelerator":
            cpu = frozenset(
                l
                for l in locs
                if "cpu" in l.lower() or "host" in l.lower() or l == "l^d"
            )
            if not cpu and locs:
                cpu = frozenset(locs[:1])
            groups = {
                "cpu": cpu,
                "accel": frozenset(l for l in locs if l not in cpu),
            }
            return replace(self, groups=groups, _pending=None)
        raise ValueError(f"unknown pending preset {self._pending!r}")

    # -- presets ------------------------------------------------------------
    @classmethod
    def preset(cls, name: str, **kw) -> "NetworkModel":
        """Named topologies: ``uniform``, ``two-rack``, ``cpu+accelerator``.

        ``uniform(bandwidth=, latency=)`` — one link everywhere.

        ``two-rack(racks={"rack0": [...], "rack1": [...]}, intra=Link,
        inter=Link)`` — without ``racks=`` the sorted location set is split
        in half at :meth:`bind` time.

        ``cpu+accelerator(cpu=[...], cpu_link=, accel_link=, pcie=)`` —
        without ``cpu=`` the host tier is inferred at :meth:`bind` time from
        location names (``cpu``/``host``/``l^d``), falling back to the first
        sorted location.
        """
        if name == "uniform":
            link = Link(
                bandwidth=float(kw.pop("bandwidth", 1e9)),
                latency=float(kw.pop("latency", 100e-6)),
            )
            _reject_extra(name, kw)
            return cls(default=link, name=name)
        if name == "two-rack":
            intra = kw.pop("intra", Link(10e9, 10e-6))
            inter = kw.pop("inter", Link(1e9, 500e-6))
            racks = kw.pop("racks", None)
            _reject_extra(name, kw)
            group_links = {
                ("rack0", "rack0"): intra,
                ("rack1", "rack1"): intra,
                ("rack0", "rack1"): inter,
            }
            if racks is not None:
                groups = {g: frozenset(ms) for g, ms in dict(racks).items()}
                unknown = set(groups) - {"rack0", "rack1"}
                if unknown:
                    raise ValueError(
                        f"two-rack racks must be named rack0/rack1, got "
                        f"{sorted(unknown)}"
                    )
                return cls(
                    default=inter,
                    groups=groups,
                    group_links=group_links,
                    name=name,
                )
            return cls(
                default=inter,
                group_links=group_links,
                name=name,
                _pending="two-rack",
            )
        if name == "cpu+accelerator":
            cpu_link = kw.pop("cpu_link", Link(1e9, 100e-6))
            accel_link = kw.pop("accel_link", Link(50e9, 5e-6))
            pcie = kw.pop("pcie", Link(16e9, 20e-6))
            cpu = kw.pop("cpu", None)
            _reject_extra(name, kw)
            group_links = {
                ("cpu", "cpu"): cpu_link,
                ("accel", "accel"): accel_link,
                ("cpu", "accel"): pcie,
            }
            if cpu is not None:
                return cls(
                    default=pcie,
                    groups={"cpu": frozenset(cpu)},
                    group_links=group_links,
                    open_group="accel",  # everything else is the fast tier
                    name=name,
                )
            return cls(
                default=pcie,
                group_links=group_links,
                name=name,
                _pending="cpu+accelerator",
            )
        raise ValueError(
            f"unknown network preset {name!r}; "
            "known: uniform, two-rack, cpu+accelerator"
        )

    # -- introspection ------------------------------------------------------
    def describe(self) -> str:
        lines = [f"network: {self.name}"]
        if self._pending:
            lines.append("  (unbound preset — call .bind(locations))")
        for g, members in sorted(self.groups.items()):
            lines.append(f"  {g}: {', '.join(sorted(members))}")
        return "\n".join(lines)


def _reject_extra(name: str, kw: dict) -> None:
    if kw:
        raise TypeError(
            f"unknown arguments for preset {name!r}: {sorted(kw)}"
        )
