"""Multi-device tile-parallel rendering via shard_map.

Data-parallel over rays: each device renders a horizontal band of the
pixel grid with the full scene replicated in its memory. Collectives are
limited to
(a) the implicit all-gather when the host assembles the framebuffer and
(b) a psum of ray counters — matching the thin communication plan of
SURVEY section 5.8 (no gradient/optimizer traffic exists).

Usage::

    mesh = make_mesh()
    f = build_sharded_render(mesh, cfg, width, height)
    accum, rays = f(device_scene, fp, view, spp)   # accum (H, W, 4)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from realtimepathtracingresearchframework_tpu.ops.integrator import (
    DeviceScene,
    FrameParams,
    IntegratorConfig,
    ViewBuffers,
    render_tile,
)
from realtimepathtracingresearchframework_tpu.parallel.mesh import (
    TILE_AXIS,
    TILE_X_AXIS,
    TILE_Y_AXIS,
)


def build_sharded_render(mesh, cfg: IntegratorConfig, width: int, height: int):
    """Returns a jitted (ds, fp, view, spp) -> (accum (H,W,4), rays) function
    sharded over ``mesh``'s tile axis. height must divide evenly by the
    axis size (callers pad; the driver configs use multiples of 8)."""
    n_dev = mesh.shape[TILE_AXIS]
    if height % n_dev != 0:
        raise ValueError(f"height {height} not divisible by {n_dev} devices")
    rows_per_dev = height // n_dev

    def per_device(ds, fp, view, spp):
        idx = jax.lax.axis_index(TILE_AXIS)
        y0 = idx.astype(jnp.int32) * rows_per_dev
        accum, rays = render_tile(
            ds, cfg, fp, view, width, height, spp, y0=y0, tile_h=rows_per_dev
        )
        rays = jax.lax.psum(rays, TILE_AXIS)
        return accum, rays

    shard = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),  # scene/params replicated
        out_specs=(P(TILE_AXIS), P()),  # framebuffer row-sharded
        check_vma=False,
    )
    return jax.jit(shard)


def build_sharded_render_2d(mesh, cfg: IntegratorConfig, width: int,
                            height: int):
    """2-D (tile_y, tile_x) sharding: each device renders an
    (H/rows, W/cols) pixel tile; the framebuffer is sharded in both dims
    and ray counters psum over both axes. Scene replicated per device."""
    rows = mesh.shape[TILE_Y_AXIS]
    cols = mesh.shape[TILE_X_AXIS]
    if height % rows != 0 or width % cols != 0:
        raise ValueError(
            f"frame {width}x{height} not divisible by mesh "
            f"(tile_x={cols}, tile_y={rows})"
        )
    tile_h = height // rows
    tile_w = width // cols

    def per_device(ds, fp, view, spp):
        iy = jax.lax.axis_index(TILE_Y_AXIS).astype(jnp.int32)
        ix = jax.lax.axis_index(TILE_X_AXIS).astype(jnp.int32)
        accum, rays = render_tile(
            ds, cfg, fp, view, width, height, spp,
            y0=iy * tile_h, tile_h=tile_h,
            x0=ix * tile_w, tile_w=tile_w,
        )
        rays = jax.lax.psum(rays, (TILE_Y_AXIS, TILE_X_AXIS))
        return accum, rays

    shard = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(TILE_Y_AXIS, TILE_X_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(shard)
