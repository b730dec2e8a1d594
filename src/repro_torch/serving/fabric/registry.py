"""Cluster registry: what the fabric may submit to, validated up front
(the port's copy of ``repro.serving.fabric.registry``).

Mirrors the shape production container-launch stacks use: the site's
partitions and their node counts are declared once, and every submit is
validated against remaining capacity *before* anything is rendered or
spawned — a job that can never schedule should fail at the gateway, not
sit PENDING forever in a queue the operator has to go inspect.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


class CapacityError(ValueError):
    """Submit refused at validation: unknown partition or not enough
    free nodes.  Raised before any job state exists."""


@dataclass(frozen=True)
class Partition:
    name: str
    nodes: int
    cores_per_node: int = 48          # SuperMUC-NG thin node

    def __post_init__(self):
        if self.nodes <= 0:
            raise ValueError(f"partition {self.name!r}: nodes must be "
                             f"positive, got {self.nodes}")
        if self.cores_per_node <= 0:
            raise ValueError(f"partition {self.name!r}: cores_per_node "
                             f"must be positive, got {self.cores_per_node}")


@dataclass
class ClusterRegistry:
    """Partitions and their committed-node bookkeeping."""
    partitions: Dict[str, Partition] = field(default_factory=dict)
    committed: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def single_partition(cls, name: str = "general", nodes: int = 8,
                         cores_per_node: int = 48) -> "ClusterRegistry":
        reg = cls()
        reg.add(Partition(name, nodes, cores_per_node))
        return reg

    def add(self, partition: Partition) -> None:
        self.partitions[partition.name] = partition
        self.committed.setdefault(partition.name, 0)

    def free_nodes(self, partition: str) -> int:
        part = self.partitions.get(partition)
        if part is None:
            raise CapacityError(
                f"unknown partition {partition!r}; registered: "
                f"{sorted(self.partitions) or 'none'}")
        return part.nodes - self.committed[partition]

    def validate(self, partition: str, nodes: int = 1) -> None:
        """Refuse a submit that cannot fit.  Raises CapacityError."""
        if nodes <= 0:
            raise CapacityError(f"nodes must be positive, got {nodes}")
        free = self.free_nodes(partition)
        if nodes > free:
            raise CapacityError(
                f"partition {partition!r}: requested {nodes} node(s), "
                f"{free} free of {self.partitions[partition].nodes}")

    def commit(self, partition: str, nodes: int = 1) -> None:
        self.validate(partition, nodes)
        self.committed[partition] += nodes

    def release(self, partition: str, nodes: int = 1) -> None:
        self.committed[partition] = max(
            0, self.committed.get(partition, 0) - nodes)

    def summary(self) -> List[Dict[str, int]]:
        return [{"partition": p.name, "nodes": p.nodes,
                 "committed": self.committed[p.name],
                 "free": p.nodes - self.committed[p.name]}
                for p in self.partitions.values()]
