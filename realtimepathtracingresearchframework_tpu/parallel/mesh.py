"""Device mesh helpers.

The reference is single-GPU; its parallel axes are the SIMT dispatch grid
and dual Vulkan queues (SURVEY section 2.6). The scaling axis here is a
``jax.sharding.Mesh`` of devices with the pixel grid sharded in row tiles
and the scene (SoA arrays + BVH) replicated into every device's memory;
collectives only assemble the framebuffer / reduce stats (SURVEY 5.8).
The cards of one host are joined all to all, so the mesh shape follows
the tiling alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"
TILE_Y_AXIS = "tile_y"
TILE_X_AXIS = "tile_x"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = TILE_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(rows: int, cols: int,
                 devices: Optional[Sequence] = None) -> Mesh:
    """2-D (tile_y, tile_x) mesh: the pixel grid shards in both rows and
    columns (SURVEY 5.8's 1-D/2-D mesh plan)."""
    devices = list(devices) if devices is not None else jax.devices()
    if len(devices) < rows * cols:
        raise ValueError(f"need {rows * cols} devices, have {len(devices)}")
    grid = np.array(devices[: rows * cols]).reshape(rows, cols)
    return Mesh(grid, (TILE_Y_AXIS, TILE_X_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Shard dim 0 (pixel rows) across the tile axis."""
    return NamedSharding(mesh, P(TILE_AXIS))
