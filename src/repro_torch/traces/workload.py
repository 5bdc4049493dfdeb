"""Workload representation (mirrors repro/traces/workload.py): only
``Topology``, the failure-domain tree the planner's recovery-cost term
reads. The rest of that module (requests, arrival processes, faults) comes
with the simulator's slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class Topology:
    """Seeded failure-domain tree over an anonymous chip count.

    Chips are integers ``0..n_chips-1``; the tree is positional —
    chip → host (``chips_per_host``), host → rack (``hosts_per_rack``),
    rack → power domain (``racks_per_domain``) — so the same Topology
    describes any pool size and two replays of one (trace, seed) agree
    on every domain membership. Defaults model a v5e-ish pod slice: 8
    chips per host, 4 hosts per rack, 2 racks per power feed.
    """

    chips_per_host: int = 8
    hosts_per_rack: int = 4
    racks_per_domain: int = 2

    def host_of(self, chip: int) -> int:
        return chip // self.chips_per_host

    def rack_of(self, chip: int) -> int:
        return self.host_of(chip) // self.hosts_per_rack

    def domain_of(self, chip: int) -> int:
        return self.rack_of(chip) // self.racks_per_domain

    def n_hosts(self, n_chips: int) -> int:
        return -(-n_chips // self.chips_per_host)

    def n_racks(self, n_chips: int) -> int:
        return -(-self.n_hosts(n_chips) // self.hosts_per_rack)

    def n_domains(self, n_chips: int) -> int:
        return -(-self.n_racks(n_chips) // self.racks_per_domain)

    def host_chips(self, host: int, n_chips: int) -> Tuple[int, ...]:
        lo = host * self.chips_per_host
        return tuple(range(lo, min(lo + self.chips_per_host, n_chips)))

    def rack_hosts(self, rack: int, n_chips: int) -> Tuple[int, ...]:
        lo = rack * self.hosts_per_rack
        return tuple(range(lo, min(lo + self.hosts_per_rack, self.n_hosts(n_chips))))

    def domain_hosts(self, domain: int, n_chips: int) -> Tuple[int, ...]:
        racks = range(
            domain * self.racks_per_domain,
            min((domain + 1) * self.racks_per_domain, self.n_racks(n_chips)),
        )
        out: List[int] = []
        for r in racks:
            out.extend(self.rack_hosts(r, n_chips))
        return tuple(out)

    def hosts_spanned(self, tp: int) -> int:
        """Host-failure modes a host-aligned TP group of size ``tp`` is
        exposed to (the planner's recovery-cost term reads this)."""
        return -(-tp // self.chips_per_host)
