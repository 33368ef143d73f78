"""VolumeGrowth: allocate new volumes satisfying an XYZ replica placement.

A copy of seaweedfs_tpu/topology/volume_growth.py (host code, no device work).

Reference: weed/topology/volume_growth.go (270 LoC).  The placement search
(`findEmptySlotsForOneVolume` :133-229) picks a main DC/rack/node plus the
required different-DC / different-rack / same-rack replicas, scoring
candidates by free slots.  The reference randomizes among eligible nodes;
we pick weighted-random by free slots (same behavior class, deterministic
under a seeded Random for tests).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..storage import types as t
from .node import DataCenter, DataNode, Rack


class NoFreeSpace(RuntimeError):
    pass


@dataclass
class VolumeGrowOption:
    collection: str = ""
    replica_placement: t.ReplicaPlacement = field(default_factory=t.ReplicaPlacement)
    ttl: t.TTL = field(default_factory=t.TTL)
    disk_type: str = "hdd"
    preferred_data_center: str = ""
    preferred_rack: str = ""
    preferred_node: str = ""


def target_count_per_request(rp: t.ReplicaPlacement) -> int:
    """How many volumes one growth request creates (AutomaticGrowByType
    volume_growth.go:33-48): fewer when each volume costs more replicas."""
    copies = rp.copy_count
    if copies == 1:
        return 7
    if copies == 2:
        return 6
    if copies == 3:
        return 3
    return 1


def _avoid_pods(candidates: list[DataNode], chosen: list[DataNode]):
    """Host-aware replica spreading: drop candidates sharing a
    mesh pod with an already-chosen replica — pod members degrade
    together, so two replicas inside
    one pod are barely more durable than one.  Falls back to the full
    candidate list when the filter would empty it (availability wins
    over strict domain separation, and clusters without pods — every
    mesh_pod "" — are untouched)."""
    taken = {n.mesh_pod for n in chosen if n.mesh_pod}
    if not taken:
        return candidates
    spread = [n for n in candidates if n.mesh_pod not in taken]
    return spread or candidates


class VolumeGrowth:
    def __init__(self, rng: random.Random | None = None):
        self.rng = rng or random.Random()

    def find_empty_slots(
        self, data_centers: dict[str, DataCenter], option: VolumeGrowOption
    ) -> list[DataNode]:
        """Pick copy_count nodes satisfying the XYZ placement; raises
        NoFreeSpace.  (findEmptySlotsForOneVolume volume_growth.go:133-229)"""
        rp = option.replica_placement
        dt = option.disk_type

        # 1. main DC: needs 1 + diff_rack + same_rack slots in-house and
        #    enough sibling DCs with capacity for the diff_dc replicas
        def rack_fits(r: Rack) -> bool:
            return (
                sum(1 for n in r.data_nodes() if n.free_slots(dt) >= 1)
                >= rp.same_rack + 1
            )

        def dc_fits(dc: DataCenter) -> bool:
            if not any(rack_fits(r) for r in dc.racks.values()):
                return False
            racks_with_space = sum(
                1 for r in dc.racks.values() if r.free_slots(dt) >= 1
            )
            return racks_with_space >= rp.diff_rack + 1

        main_dc = self._pick(
            [
                dc
                for dc in data_centers.values()
                if (not option.preferred_data_center or dc.name == option.preferred_data_center)
                and dc_fits(dc)
                and sum(
                    1
                    for other in data_centers.values()
                    if other.name != dc.name and other.free_slots(dt) >= 1
                )
                >= rp.diff_dc
            ],
            lambda dc: dc.free_slots(dt),
        )
        if main_dc is None:
            raise NoFreeSpace(
                f"no data center can host rp={rp} (need {rp.copy_count} copies)"
            )

        # 2. main rack within the DC
        main_rack = self._pick(
            [
                r
                for r in main_dc.racks.values()
                if (not option.preferred_rack or r.name == option.preferred_rack)
                and rack_fits(r)
                and sum(
                    1
                    for other in main_dc.racks.values()
                    if other.name != r.name and other.free_slots(dt) >= 1
                )
                >= rp.diff_rack
            ],
            lambda r: r.free_slots(dt),
        )
        if main_rack is None:
            raise NoFreeSpace(f"no rack in {main_dc.name} can host rp={rp}")

        # 3. main node within the rack
        main_node = self._pick(
            [
                n
                for n in main_rack.data_nodes()
                if (not option.preferred_node or n.url == option.preferred_node)
                and n.free_slots(dt) >= 1
            ],
            lambda n: n.free_slots(dt),
        )
        if main_node is None:
            raise NoFreeSpace(f"no node in {main_dc.name}/{main_rack.name} has space")

        servers = [main_node]
        # same-rack replicas: other nodes in the main rack, spread
        # across mesh pods where possible (pod members fail together)
        others = [
            n
            for n in main_rack.data_nodes()
            if n.url != main_node.url and n.free_slots(dt) >= 1
        ]
        if len(others) < rp.same_rack:
            raise NoFreeSpace(f"rack {main_rack.name}: need {rp.same_rack} more nodes")
        for _ in range(rp.same_rack):
            pick = self._pick(
                _avoid_pods(others, servers), lambda n: n.free_slots(dt)
            )
            if pick is None:
                raise NoFreeSpace(
                    f"rack {main_rack.name}: need {rp.same_rack} more nodes"
                )
            servers.append(pick)
            others.remove(pick)

        # different-rack replicas: one node from each other rack
        other_racks = [
            r
            for r in main_dc.racks.values()
            if r.name != main_rack.name and r.free_slots(dt) >= 1
        ]
        if len(other_racks) < rp.diff_rack:
            raise NoFreeSpace(f"dc {main_dc.name}: need {rp.diff_rack} more racks")
        for r in self._sample(other_racks, rp.diff_rack, lambda r: r.free_slots(dt)):
            node = self._pick(
                _avoid_pods(
                    [n for n in r.data_nodes() if n.free_slots(dt) >= 1],
                    servers,
                ),
                lambda n: n.free_slots(dt),
            )
            if node is None:
                raise NoFreeSpace(f"rack {r.name} has no node with space")
            servers.append(node)

        # different-DC replicas: one node from each other DC
        other_dcs = [
            dc
            for dc in data_centers.values()
            if dc.name != main_dc.name and dc.free_slots(dt) >= 1
        ]
        if len(other_dcs) < rp.diff_dc:
            raise NoFreeSpace(f"need {rp.diff_dc} more data centers")
        for dc in self._sample(other_dcs, rp.diff_dc, lambda d: d.free_slots(dt)):
            node = self._pick(
                _avoid_pods(
                    [n for n in dc.data_nodes() if n.free_slots(dt) >= 1],
                    servers,
                ),
                lambda n: n.free_slots(dt),
            )
            if node is None:
                raise NoFreeSpace(f"dc {dc.name} has no node with space")
            servers.append(node)

        return servers

    # weighted-random selection helpers --------------------------------------

    def _pick(self, items: list, weight) -> object | None:
        items = [i for i in items if weight(i) > 0]
        if not items:
            return None
        weights = [weight(i) for i in items]
        return self.rng.choices(items, weights=weights, k=1)[0]

    def _sample(self, items: list, k: int, weight) -> list:
        chosen = []
        pool = list(items)
        for _ in range(k):
            pick = self._pick(pool, weight)
            if pick is None:
                break
            chosen.append(pick)
            pool.remove(pick)
        return chosen
