"""Raster G-buffer pipeline (the optional ENABLE_RASTER path).

Counterpart of the reference's raster pipeline
(vulkan/pipeline_raster/raster_scene_vulkan.{h,cpp}, basic.vert/frag):
projects the scene's triangles with the pinhole camera and z-buffers a
shaded G-buffer (albedo, shading normal, depth, triangle id). The
reference uses it as a debug/compat path next to the RT pipelines; here
the "rasterizer" is a dense batched coverage test — for every triangle
batch, barycentrics are evaluated for all pixels and the
nearest hit is kept with a `lax.scan` (a z-buffer as a running minimum).
That is the array-program formulation: no scatter-based triangle
binning, fixed shapes, dense (T x P) broadcasts.

Cost scales with triangles x pixels, so this is a small-scene debug
path, matching the reference's positioning (the survey marks the raster
pipeline optional)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

TRI_BATCH = 64


class GBuffer(NamedTuple):
    albedo: jnp.ndarray  # (H, W, 3)
    normal: jnp.ndarray  # (H, W, 3)
    depth: jnp.ndarray  # (H, W)
    tri: jnp.ndarray  # (H, W) i32, -1 = background


def _project(view_pos, view_du, view_dv, view_tl, p):
    """World point -> (u, v, w): screen coords in [0,1) and view depth
    along the camera basis (the inverse of camera_rays' pixel->direction
    mapping — solve rel = u*du + v*dv + w*tl with rel scaled by w)."""
    rel = p - view_pos[None, :]
    m = jnp.stack([view_du, view_dv, view_tl], axis=1)  # (3, 3)
    coeffs = jnp.linalg.solve(
        jnp.broadcast_to(m, rel.shape[:-1] + (3, 3)), rel[..., None]
    )[..., 0]
    w = coeffs[..., 2]
    safe_w = jnp.where(jnp.abs(w) > 1e-9, w, 1e-9)
    return coeffs[..., 0] / safe_w, coeffs[..., 1] / safe_w, w


@functools.partial(jax.jit, static_argnames=("width", "height"))
def raster_gbuffer(
    v0, e1, e2, n0, n1, n2, base_color, tri_mat,
    view_pos, view_du, view_dv, view_tl,
    width: int, height: int,
):
    """Rasterize the triangle soup into a G-buffer.

    v0/e1/e2: (T, 3) world-space triangles; n0/n1/n2: (T, 3) corner
    normals; base_color: (M, 3) material colors; tri_mat: (T,) i32.
    view_*: the camera basis of camera_rays (models/camera.view_basis).
    """
    t = v0.shape[0]
    pad = (-t) % TRI_BATCH
    if pad:
        padv = lambda a: jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]
        )
        v0, e1, e2 = padv(v0), padv(e1), padv(e2)
        n0, n1, n2 = padv(n0), padv(n1), padv(n2)
        tri_mat = jnp.concatenate([tri_mat, jnp.full((pad,), -1, jnp.int32)])
    tp = v0.shape[0]

    # project the three corners of every triangle once
    u0, v0s, w0 = _project(view_pos, view_du, view_dv, view_tl, v0)
    u1, v1s, w1 = _project(view_pos, view_du, view_dv, view_tl, v0 + e1)
    u2, v2s, w2 = _project(view_pos, view_du, view_dv, view_tl, v0 + e2)

    # pixel centers in screen space
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    pxg = jnp.broadcast_to(px[None, :], (height, width)).reshape(-1)
    pyg = jnp.broadcast_to(py[:, None], (height, width)).reshape(-1)

    nb = tp // TRI_BATCH
    ids_flat = jnp.arange(tp, dtype=jnp.int32)
    ids_flat = jnp.where(ids_flat < t, ids_flat, -1)  # padding slots
    tri_ids = ids_flat.reshape(nb, TRI_BATCH)

    def scan_batch(carry, inp):
        zbuf, best = carry
        (bu0, bv0, bw0, bu1, bv1, bw1, bu2, bv2, bw2, ids) = inp
        # screen-space edge functions, (B, P)
        ax = bu0[:, None] - pxg[None, :]
        ay = bv0[:, None] - pyg[None, :]
        bx = bu1[:, None] - pxg[None, :]
        by = bv1[:, None] - pyg[None, :]
        cx = bu2[:, None] - pxg[None, :]
        cy = bv2[:, None] - pyg[None, :]
        e01 = ax * by - ay * bx
        e12 = bx * cy - by * cx
        e20 = cx * ay - cy * ax
        area = e01 + e12 + e20
        inside = ((e01 >= 0) & (e12 >= 0) & (e20 >= 0)) | (
            (e01 <= 0) & (e12 <= 0) & (e20 <= 0)
        )
        inv_area = jnp.where(jnp.abs(area) > 1e-12, 1.0 / area, 0.0)
        # barycentrics of the pixel (perspective-incorrect in screen space;
        # correct via 1/w interpolation)
        l0 = e12 * inv_area
        l1 = e20 * inv_area
        l2 = e01 * inv_area
        iw = (
            l0 / jnp.maximum(bw0[:, None], 1e-9)
            + l1 / jnp.maximum(bw1[:, None], 1e-9)
            + l2 / jnp.maximum(bw2[:, None], 1e-9)
        )
        z = 1.0 / jnp.maximum(iw, 1e-12)
        front = (bw0[:, None] > 0) & (bw1[:, None] > 0) & (bw2[:, None] > 0)
        valid = inside & front & (jnp.abs(area) > 1e-12) & (ids[:, None] >= 0)
        z = jnp.where(valid, z, jnp.inf)
        zi = jnp.argmin(z, axis=0)  # (P,) nearest triangle in batch
        zmin = jnp.take_along_axis(z, zi[None, :], axis=0)[0]
        improved = zmin < zbuf
        zbuf = jnp.where(improved, zmin, zbuf)
        best = jnp.where(improved, ids[zi], best)
        return (zbuf, best), None

    inputs = tuple(
        a.reshape(nb, TRI_BATCH)
        for a in (u0, v0s, w0, u1, v1s, w1, u2, v2s, w2)
    ) + (tri_ids,)
    npix = width * height
    init = (jnp.full((npix,), jnp.inf, jnp.float32),
            jnp.full((npix,), -1, jnp.int32))
    (zbuf, best), _ = jax.lax.scan(scan_batch, init, inputs)

    hit = best >= 0
    tri = jnp.maximum(best, 0)
    # recompute barycentrics for the winning triangle (P-sized gathers)
    pu0, pv0, pw0 = u0[tri], v0s[tri], w0[tri]
    pu1, pv1, pw1 = u1[tri], v1s[tri], w1[tri]
    pu2, pv2, pw2 = u2[tri], v2s[tri], w2[tri]
    ax, ay = pu0 - pxg, pv0 - pyg
    bx, by = pu1 - pxg, pv1 - pyg
    cx, cy = pu2 - pxg, pv2 - pyg
    e01 = ax * by - ay * bx
    e12 = bx * cy - by * cx
    e20 = cx * ay - cy * ax
    area = e01 + e12 + e20
    inv_area = jnp.where(jnp.abs(area) > 1e-12, 1.0 / area, 0.0)
    l0s, l1s, l2s = e12 * inv_area, e20 * inv_area, e01 * inv_area
    # perspective-correct attribute weights
    q0 = l0s / jnp.maximum(pw0, 1e-9)
    q1 = l1s / jnp.maximum(pw1, 1e-9)
    q2 = l2s / jnp.maximum(pw2, 1e-9)
    qs = jnp.maximum(q0 + q1 + q2, 1e-12)
    b0, b1, b2 = q0 / qs, q1 / qs, q2 / qs

    nrm = (
        n0[tri] * b0[:, None] + n1[tri] * b1[:, None] + n2[tri] * b2[:, None]
    )
    nrm = nrm / jnp.maximum(
        jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20
    )
    alb = base_color[jnp.maximum(tri_mat[tri], 0)]

    zero3 = jnp.zeros((npix, 3), jnp.float32)
    return GBuffer(
        albedo=jnp.where(hit[:, None], alb, zero3).reshape(height, width, 3),
        normal=jnp.where(hit[:, None], nrm, zero3).reshape(height, width, 3),
        depth=jnp.where(hit, zbuf, jnp.float32(np.inf)).reshape(height, width),
        tri=jnp.where(hit, best, -1).reshape(height, width),
    )
