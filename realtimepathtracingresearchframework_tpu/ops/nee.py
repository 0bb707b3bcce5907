"""Next-event estimation: light sampling + MIS (SoA core).

Port of the reference NEE stack:
- solid-angle triangle sampling via Householder + Van Oosterom-Strackee
  (rendering/lights/tri.glsl:66-155),
- binned RIS tri-light selection: uniform bin pick, luminance x solid-angle
  scoring of the <=16 lights in the bin, CDF select
  (rendering/mc/lights_linear.glsl:30-127),
- sun spherical-cap sampling (rendering/lights/sun.glsl,
  mc/lights_sun.glsl:8-22),
- sun-vs-area selection by ``sun_radiance.w`` + balance-heuristic MIS
  (rendering/mc/nee.glsl:32-90, nee_interface.glsl:11-15,46-58).

Directions/positions flow as ``vec3.Vec3`` SoA triples (see ops/vec3.py for
why); light tables are padded to a bin multiple so all loops are
fixed-width. Array-shaped wrappers for the pure-geometry helpers keep the
original test-facing API.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from realtimepathtracingresearchframework_tpu.ops import vec3 as v3
from realtimepathtracingresearchframework_tpu.ops.smallgather import select_rows
from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3

BIN_MAX_SIZE = 16  # BINNED_LIGHTS_BIN_MAX_SIZE (render_params.glsl.h:18)
MIN_IRRADIANCE = 6.2e-4 * 0.001  # lights_linear.glsl:40


class TriLightBuffers(NamedTuple):
    v0: jnp.ndarray  # (L,3)
    v1: jnp.ndarray
    v2: jnp.ndarray
    radiance: jnp.ndarray  # (L,3)


def ortho_frame_v(n: Vec3):
    """(v_x, v_y) completing n to a right-handed frame (util.glsl:73-93)."""
    zero = jnp.zeros_like(n.x)
    one = jnp.ones_like(n.x)
    c1 = jnp.abs(n.x) < 0.6
    c2 = jnp.abs(n.y) < 0.6
    c3 = jnp.abs(n.z) < 0.6
    vy = Vec3(
        jnp.where(c1 | ~(c2 | c3), one, zero),
        jnp.where(~c1 & c2, one, zero),
        jnp.where(~c1 & ~c2 & c3, one, zero),
    )
    vx = v3.normalize(v3.cross(vy, n))
    vy = v3.normalize(v3.cross(n, vx))
    return vx, vy


def ortho_frame(n):
    """Array-shaped wrapper: n (..., 3) -> (v_x, v_y) (..., 3)."""
    vx, vy = ortho_frame_v(v3.from_array(n))
    return v3.to_array(vx), v3.to_array(vy)


# ---------------------------------------------------------------------------
# Triangle solid angle (tri.glsl:66-155)
# ---------------------------------------------------------------------------


def half_triangle_solid_angle_tan_v(v0: Vec3, v1: Vec3, v2: Vec3):
    """Returns (tangent, params 3-tuple). v* must be unit directions."""
    householder_sign = jnp.where(v0.x > 0.0, -1.0, 1.0)
    inv = 1.0 / (jnp.abs(v0.x) + 1.0)
    hh_y = v0.y * inv
    hh_z = v0.z * inv
    dot_0_1 = v3.dot(v0, v1)
    dot_0_2 = v3.dot(v1, v2)
    dot_1_2 = v3.dot(v0, v2)
    dot_h0 = -householder_sign * v1.x + dot_0_1
    dot_h2 = -householder_sign * v2.x + dot_1_2
    col0_y = -dot_h0 * hh_y + v1.y
    col0_z = -dot_h0 * hh_z + v1.z
    col1_y = -dot_h2 * hh_y + v2.y
    col1_z = -dot_h2 * hh_z + v2.z
    simplex_volume = jnp.abs(col0_y * col1_z - col0_z * col1_y)
    dot_0_2_plus_1_2 = dot_0_2 + dot_1_2
    one_plus_dot_0_1 = 1.0 + dot_0_1
    tangent = simplex_volume / (one_plus_dot_0_1 + dot_0_2_plus_1_2)
    return tangent, (simplex_volume, dot_0_2_plus_1_2, one_plus_dot_0_1)


def _positive_atan(t):
    a = jnp.arctan(t)
    return jnp.where(a >= 0.0, a, a + jnp.pi)


def triangle_solid_angle_v(v0: Vec3, v1: Vec3, v2: Vec3):
    tangent, params = half_triangle_solid_angle_tan_v(v0, v1, v2)
    return 2.0 * _positive_atan(tangent), params


def sample_solid_angle_polygon_v(
    v0: Vec3, v1: Vec3, v2: Vec3, solid_angle, params, u0, u1
) -> Vec3:
    """Peters' clipped-arc sampling (tri.glsl:132-155). v* unit dirs."""
    target = solid_angle * u0
    cs = jnp.cos(0.5 * target)
    sn = jnp.sin(0.5 * target)
    # vertices[3] = {v1, v0, v2}
    offset = v1 * (params[0] * cs - params[1] * sn) + v2 * (params[2] * sn)
    d = v3.dot(v1, offset) / jnp.maximum(v3.dot(offset, offset), 1e-30)
    new_v2 = offset * (2.0 * d) - v1
    s2 = v3.dot(v0, new_v2)
    s = 1.0 + (s2 - 1.0) * u1
    denominator = 1.0 - s2 * s2
    t_normed = jnp.sqrt(
        jnp.maximum(1.0 - s * s, 0.0) / jnp.maximum(denominator, 1e-30)
    )
    t_normed = jnp.where(denominator > 0.0, t_normed, u1)
    return v0 * (s - t_normed * s2) + new_v2 * t_normed


def is_tri_facing_forward_v(v0: Vec3, v1: Vec3, v2: Vec3):
    return v3.dot(v3.cross(v0, v1), v2) < 0.0


def approx_triangle_solid_angle_v(v0: Vec3, v1: Vec3, v2: Vec3):
    tangent, _ = half_triangle_solid_angle_tan_v(v0, v1, v2)
    return 2.0 * _positive_atan(tangent)


# -- array-shaped wrappers (test/tool API) ----------------------------------


def triangle_solid_angle(v0, v1, v2):
    sa, params = triangle_solid_angle_v(
        v3.from_array(v0), v3.from_array(v1), v3.from_array(v2)
    )
    return sa, jnp.stack(params, axis=-1)


def sample_solid_angle_polygon(v0, v1, v2, solid_angle, params, u):
    out = sample_solid_angle_polygon_v(
        v3.from_array(v0),
        v3.from_array(v1),
        v3.from_array(v2),
        solid_angle,
        (params[..., 0], params[..., 1], params[..., 2]),
        u[..., 0],
        u[..., 1],
    )
    return v3.to_array(out)


def approx_triangle_solid_angle(v0, v1, v2):
    return approx_triangle_solid_angle_v(
        v3.from_array(v0), v3.from_array(v1), v3.from_array(v2)
    )


# ---------------------------------------------------------------------------
# Binned RIS tri-light sampling (lights_linear.glsl:20-127)
# ---------------------------------------------------------------------------


class LightSample(NamedTuple):
    illum: Vec3  # radiance / pdf
    dir: Vec3
    dist: jnp.ndarray
    pdf: jnp.ndarray
    mis_wpdf: jnp.ndarray


def _light_cols(lights: TriLightBuffers):
    """Per-component (L,) views of the light tables. The tables are scene
    constants in the captured pass programs, so these slices fold away at
    compile time."""
    return (
        v3.from_array(lights.v0),
        v3.from_array(lights.v1),
        v3.from_array(lights.v2),
        v3.from_array(lights.radiance),
    )


def _fetch(cols: Vec3, idx) -> Vec3:
    return Vec3(
        select_rows(cols.x, idx), select_rows(cols.y, idx), select_rows(cols.z, idx)
    )


def sample_tri_lights_v(
    lights: TriLightBuffers,
    hit_p: Vec3,
    hit_n: Vec3,
    dir_sample,
    sel_sample,
    bin_size: int,
    use_bins: bool,
) -> LightSample:
    """Batched tri-light sample (SoA). ``dir_sample``/``sel_sample`` are
    (u0, u1) tuples. Light table length must be a multiple of ``bin_size``
    when use_bins (padded with zero-radiance lights)."""
    num_lights = lights.v0.shape[0]
    c0, c1, c2, crad = _light_cols(lights)

    if use_bins:
        num_bins = num_lights // bin_size
        sx = sel_sample[0] * num_bins
        bin_id = jnp.minimum(sx.astype(jnp.int32), num_bins - 1)
        sel_p = 1.0 / num_bins
        # score all lights in the bin (fixed width, (N, B) component arrays)
        px, py, pz = hit_p
        if num_bins == 1:
            # single bin: broadcast the tiny light table instead of (N,16)
            # gathers
            def bc(col):
                return Vec3(
                    col.x[None, :] - px[..., None],
                    col.y[None, :] - py[..., None],
                    col.z[None, :] - pz[..., None],
                )

            lv0, lv1, lv2 = bc(c0), bc(c1), bc(c2)
            contrib = v3.luminance(crad)[None, :]
        else:
            lid = bin_id[..., None] * bin_size + jnp.arange(bin_size)  # (N,B)

            def gat(col):
                return Vec3(
                    col.x[lid] - px[..., None],
                    col.y[lid] - py[..., None],
                    col.z[lid] - pz[..., None],
                )

            lv0, lv1, lv2 = gat(c0), gat(c1), gat(c2)
            contrib = v3.luminance(crad)[lid]
        front = is_tri_facing_forward_v(lv0, lv1, lv2)
        nx, ny, nz = hit_n
        n_b = Vec3(nx[..., None], ny[..., None], nz[..., None])
        above = (
            (v3.dot(lv0, n_b) > 0.0)
            | (v3.dot(lv1, n_b) > 0.0)
            | (v3.dot(lv2, n_b) > 0.0)
        )
        sa = approx_triangle_solid_angle_v(
            v3.normalize(lv0), v3.normalize(lv1), v3.normalize(lv2)
        )
        contrib = jnp.where(above & front, contrib * sa, 0.0) + MIN_IRRADIANCE
        total = jnp.sum(contrib, axis=-1, keepdims=True)
        p = contrib / total
        cdf = jnp.cumsum(p, axis=-1)
        sy = sel_sample[1]
        k = jnp.sum((sy[..., None] >= cdf).astype(jnp.int32), axis=-1)
        k = jnp.minimum(k, bin_size - 1)
        pk = jnp.take_along_axis(p, k[..., None], axis=-1)[..., 0]
        light_id = bin_id * bin_size + k
        sel_p = sel_p * pk
        mis_den = jnp.float32(num_bins)
    else:
        sx = sel_sample[0] * num_lights
        light_id = jnp.minimum(sx.astype(jnp.int32), num_lights - 1)
        sel_p = jnp.full(light_id.shape, 1.0 / num_lights)
        mis_den = jnp.float32(num_lights)

    lv0 = _fetch(c0, light_id)
    lv1 = _fetch(c1, light_id)
    lv2 = _fetch(c2, light_id)
    radiance = _fetch(crad, light_id)

    d0 = v3.normalize(lv0 - hit_p)
    d1 = v3.normalize(lv1 - hit_p)
    d2 = v3.normalize(lv2 - hit_p)
    sa, params = triangle_solid_angle_v(d0, d1, d2)
    light_dir = sample_solid_angle_polygon_v(
        d0, d1, d2, sa, params, dir_sample[0], dir_sample[1]
    )
    pdf = 1.0 / jnp.maximum(sa, 1e-12)

    e0 = lv1 - lv0
    e1 = lv2 - lv0
    e_n = v3.cross(e0, e1)
    denom = v3.dot(light_dir, e_n)
    light_dist = v3.dot(lv0 - hit_p, e_n) / jnp.where(
        jnp.abs(denom) > 1e-20, denom, 1e-20
    )
    mis_wpdf = 2.0 * light_dist * light_dist / jnp.maximum(jnp.abs(denom), 1e-20)

    pdf = pdf * sel_p
    mis_wpdf = mis_wpdf / mis_den
    illum = radiance * (1.0 / jnp.maximum(pdf, 1e-30))
    # degenerate (zero-area or zero-radiance padding) -> no contribution
    bad = (sa <= 1e-12) | ~(light_dist > 0.0)
    zero = v3.splat(jnp.zeros_like(pdf))
    return LightSample(
        illum=v3.where(bad, zero, illum),
        dir=light_dir,
        dist=jnp.where(bad, 2.0e16, light_dist),
        pdf=jnp.where(bad, 0.0, pdf),
        mis_wpdf=jnp.where(bad, 0.0, mis_wpdf),
    )


def approx_tri_lights_pdf(approx_solid_angle, num_lights, num_bins, use_bins):
    """(lights_linear.glsl:129-137)"""
    n = num_bins if use_bins else num_lights
    return 1.0 / (n * jnp.maximum(approx_solid_angle, 1e-12))


# ---------------------------------------------------------------------------
# Sun (sun.glsl + mc/lights_sun.glsl)
# ---------------------------------------------------------------------------


def sample_sun_dir_v(sun_dir, cos_radius, u0, u1) -> Vec3:
    """Spherical-cap sun sampling; ``sun_dir`` is a (3,) array (per-frame
    constant)."""
    sd = v3.from_array(sun_dir)
    phi = 2.0 * jnp.pi * u0
    cos_t = 1.0 + (cos_radius - 1.0) * u1
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    vx, vy = ortho_frame_v(sd)
    lx = sin_t * jnp.cos(phi)
    ly = sin_t * jnp.sin(phi)
    return vx * lx + vy * ly + sd * cos_t


def sample_sun_dir(sun_dir, cos_radius, u):
    """Array wrapper: u (..., 2) -> (..., 3)."""
    return v3.to_array(
        sample_sun_dir_v(sun_dir, cos_radius, u[..., 0], u[..., 1])
    )


def sun_dir_pdf(cos_radius):
    return 1.0 / (2.0 * jnp.pi * (1.0 - cos_radius))


def nee_mis_heuristic(n_f, pdf_f, n_g, pdf_g):
    """Balance heuristic (nee_interface.glsl:11-15)."""
    f = n_f * pdf_f
    g = n_g * pdf_g
    return f / jnp.maximum(f + g, 1e-30)
