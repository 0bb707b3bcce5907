"""Brute-force XLA traversal for tiny scenes (cornell-class).

For scenes with at most a few dozen BVH rows this module intersects ALL
rows with a statically unrolled Moller-Trumbore chain in plain XLA: ~35
ops per row, no memory operands beyond the rays themselves, and the whole
thing inlines into the bounce body where XLA can fuse it with RNG,
shading and NEE math, where a kernel dispatch is a fusion boundary. The
hits equal the threaded walk's (ops/traverse.py): same per-row
Moller-Trumbore math and epsilon, and on exact-t ties the LOWER row wins,
which is the row the walk reaches first.

The reference has no counterpart (RT hardware handles every scene size
uniformly, vulkan/render_vulkan.cpp:472-545).

Trace-time cost: the rows ride as PYTHON FLOAT constants baked into
the jit program (tuple-of-tuples in IntegratorConfig.brute_rows, so
they key the pass-fn cache alongside the scene revision). The
renderer gates this to scenes small enough that the unrolled chain
stays cheap to trace (backend.renderer._BRUTE_MAX_ROWS).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from realtimepathtracingresearchframework_tpu.ops.traverse import Hit
from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3

_INF = jnp.float32(2.0e32)  # miss sentinel (intersect.T_MAX)
_DET_EPS = 1e-12  # degenerate-triangle determinant cutoff (intersect.EPS_DET)


def _mt_row(row, ro: Vec3, rd: Vec3):
    """One Moller-Trumbore intersection against a static (v0, e1, e2)
    row of Python floats; returns (valid_det, u, v, t) lane vectors.
    Same math + epsilon as intersect.ray_tri."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row
    px = rd.y * e2z - rd.z * e2y
    py = rd.z * e2x - rd.x * e2z
    pz = rd.x * e2y - rd.y * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > _DET_EPS
    inv_det = jnp.where(ok, 1.0 / det, 0.0)
    tvx = ro.x - v0x
    tvy = ro.y - v0y
    tvz = ro.z - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (rd.x * qx + rd.y * qy + rd.z * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return ok, u, v, t


def closest_hit_brute(rows, row_tri, ro: Vec3, rd: Vec3, t_min, t_max) -> Hit:
    """Closest hit over every row; lowest row wins exact-t ties. ``rows``
    is a static tuple of 9-float tuples in BVH-row order; the returned
    triangle id goes through ``row_tri`` (device (R,) i32).

    Structured for the compiler, not the reader: the per-row results
    merge through a BALANCED TREE (dependency depth log2(R), not R) and
    the final hit goes through an optimization_barrier so XLA can't
    fuse the whole chain into the bounce's shading region (one giant
    fusion made XLA's scheduling superlinear in compile time). The
    barrier materializes 4 lane vectors."""
    per_row = []
    for k, row in enumerate(rows):
        ok, u, v, t = _mt_row(row, ro, rd)
        hit = (
            ok
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_min)
            & (t < t_max)
        )
        per_row.append((
            jnp.where(hit, t, _INF),
            jnp.where(hit, k, jnp.int32(-1)),
            u,
            v,
        ))
    # balanced merge; on equal t the LOWER row (left operand) wins,
    # matching the sequential chain's strict `t < best_t` rule
    while len(per_row) > 1:
        nxt = []
        for i in range(0, len(per_row) - 1, 2):
            ta, ka, ua, va = per_row[i]
            tb, kb, ub, vb = per_row[i + 1]
            right = tb < ta
            nxt.append((
                jnp.where(right, tb, ta),
                jnp.where(right, kb, ka),
                jnp.where(right, ub, ua),
                jnp.where(right, vb, va),
            ))
        if len(per_row) % 2:
            nxt.append(per_row[-1])
        per_row = nxt
    best_t, best_row, best_u, best_v = per_row[0]
    miss = best_row < 0
    tri = jnp.where(miss, -1, row_tri[jnp.maximum(best_row, 0)])
    t_out = jnp.where(miss, _INF, best_t)
    u_out = jnp.where(miss, 0.0, best_u)
    v_out = jnp.where(miss, 0.0, best_v)
    t_out, tri, u_out, v_out = jax.lax.optimization_barrier(
        (t_out, tri, u_out, v_out)
    )
    return Hit(t=t_out, tri=tri, u=u_out, v=v_out)


def occluded_brute(rows, ro: Vec3, rd: Vec3, t_min, t_max):
    """Any-hit visibility over every row (shadow rays). Same balanced
    OR-tree + fusion barrier as closest_hit_brute."""
    per_row = []
    for row in rows:
        ok, u, v, t = _mt_row(row, ro, rd)
        per_row.append(
            ok
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_min)
            & (t < t_max)
        )
    while len(per_row) > 1:
        nxt = [
            per_row[i] | per_row[i + 1]
            for i in range(0, len(per_row) - 1, 2)
        ]
        if len(per_row) % 2:
            nxt.append(per_row[-1])
        per_row = nxt
    return jax.lax.optimization_barrier(per_row[0])
