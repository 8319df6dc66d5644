"""Device-mesh helpers for multi-chip scale-out.

The reference has no multi-device story (SURVEY.md §2.4 P6) — this is the
new capability: keyframe/map-point/observation blocks are sharded over a
1-D ``jax.sharding.Mesh`` and XLA inserts the collectives (NCCL on
GPUs).  One axis fits cards that reach each other at the same rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(list(devices), (DATA_AXIS,))


def sharded(mesh: Mesh, *axis: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, P(*axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
