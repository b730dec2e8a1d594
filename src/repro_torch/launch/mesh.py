"""Meshes (counterpart of ``repro.launch.mesh``).

A mesh is a row-major layout of the ranks over named axes.  On a process
group it is ``hvd.axis_groups``' :class:`~repro_torch.core.hvd.Groups`
(this rank's group for every set of axes, and ``shape`` / ``axis_names``
as ``distributed.sharding`` reads them); without one, an
:class:`AbstractMesh` carries the axis sizes alone, which is all the
sharding rules need.  Nothing here is built at import.

Production layouts, as data (the reference's): a single pod of (16, 16)
over ``(data, model)``, and two pods, (2, 16, 16) over ``(pod, data,
model)``.  The host mesh is ``(world size,)`` over ``data`` with a
``model`` axis of size 1: the reference's ``make_host_mesh`` has no
``model`` axis, which is why its launcher cannot run ``dp_tp`` or
``fsdp_tp``.

Figures of the card the roofline reads, from NVIDIA's H100 SXM data
sheet: dense bf16 tensor-core peak, HBM3 bandwidth and capacity, and
NVLink 4's bandwidth per card (both directions together).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

PRODUCTION = {
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}

H100_SXM_PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense
H100_SXM_HBM_BW = 3.35e12             # bytes/s
H100_SXM_NVLINK_BW = 900e9            # bytes/s per card
H100_SXM_HBM_BYTES = 80 * 10**9       # HBM3 capacity, 80 GB (the dry-run's
                                      # ``fits``)


class AbstractMesh:
    """Axis names and sizes without devices or a process group."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} vs axes {axes}")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """This rank's groups over ``shape`` (row-major, the last axis
    fastest); needs the process group (``hvd.init``)."""
    from repro_torch.core import hvd
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes}")
    return hvd.axis_groups(dict(zip(axes, shape)))


def production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production layout's axis sizes (no devices)."""
    return AbstractMesh(*PRODUCTION["multi_pod" if multi_pod
                                    else "single_pod"])


def make_host_mesh(data: Optional[int] = None):
    """Every rank of the process group over ``data`` (or ``data`` ranks),
    with a ``model`` axis of size 1."""
    import torch.distributed as dist
    n = data or dist.get_world_size()
    return make_mesh((n, 1), ("data", "model"))
