"""Ray-triangle and ray-AABB intersection primitives (JAX).

The analogue of the fixed-function/HW intersection the reference gets from
``rayQueryEXT`` (vulkan/pt_megakernel.glsl:440-478). Möller-Trumbore over
precomputed (v0, e1, e2); slab test for AABBs. All functions are written
for ``vmap`` over rays with small static inner dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

T_MAX = jnp.float32(2.0e32)  # reference uses 2.e32f (pt_megakernel.glsl:326)
EPS_DET = 1e-12


def ray_tri(ro, rd, v0, e1, e2, t_min, t_max):
    """Möller-Trumbore. All inputs broadcastable; returns (hit, t, u, v).

    ro, rd: (..., 3); v0,e1,e2: (..., 3).
    """
    pvec = jnp.cross(rd, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > EPS_DET, 1.0 / det, 0.0)
    tvec = ro - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(rd * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > EPS_DET)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def ray_aabb(ro, inv_rd, bmin, bmax, t_min, t_max):
    """Slab test. ro/inv_rd: (..., 3); bmin/bmax: (..., 3). Returns hit bool
    and entry t (clamped to t_min)."""
    t0 = (bmin - ro) * inv_rd
    t1 = (bmax - ro) * inv_rd
    tsmall = jnp.minimum(t0, t1)
    tbig = jnp.maximum(t0, t1)
    tenter = jnp.maximum(jnp.max(tsmall, axis=-1), t_min)
    texit = jnp.minimum(jnp.min(tbig, axis=-1), t_max)
    return tenter <= texit, tenter


def safe_inv_dir(rd):
    """1/rd with +-inf-free handling of zero components (sign-preserving
    huge value so slab tests stay well-defined)."""
    tiny = 1e-20
    sign = jnp.where(rd >= 0.0, 1.0, -1.0)
    return sign / jnp.maximum(jnp.abs(rd), tiny)


def brute_force_closest(tris_v0, tris_e1, tris_e2, ro, rd, t_min=0.0, t_max=T_MAX):
    """Reference O(T) closest-hit for testing the BVH path.

    ro, rd: (3,). Returns (t, tri_idx, u, v); tri_idx = -1 on miss.
    """
    hit, t, u, v = ray_tri(
        ro[None, :], rd[None, :], tris_v0, tris_e1, tris_e2, t_min, t_max
    )
    t = jnp.where(hit, t, jnp.inf)
    idx = jnp.argmin(t)
    best_t = t[idx]
    return (
        jnp.where(jnp.isfinite(best_t), best_t, T_MAX),
        jnp.where(jnp.isfinite(best_t), idx, -1),
        u[idx],
        v[idx],
    )
