"""GLTF layered BSDF (JAX, branchless, SoA).

Port of the reference's production BSDF
(``rendering/bsdfs/gltf_bsdf.glsl:294-659``): GLTF-2.0 metal/dielectric mix
- diffuse lobe ``(1-F)(1-metallic)(1-transmission) * base/pi``,
- GGX specular with Smith height-correlated visibility and VNDF sampling
  via spherical caps (Dupuy-Benyoub, gltf_bsdf.glsl:233-256),
- optional rough specular transmission with Schlick Fresnel fixed up at the
  critical angle (gltf_bsdf.glsl:288-292) and one-sided angle compression,
- luminance-weighted component sampler with sample reuse
  (gltf_bsdf.glsl:369-409) and the approximate MIS weight-pdf
  (``gltf_wpdf``, :414-497).

All control flow is mask-based (``jnp.where``) so each function is one
fixed-shape vector program over batched shading points — the counterpart
of the divergence-free intent of the reference's component-sampler design.

The core implementations (``*_v``) are SoA: directions and colors are
``vec3.Vec3`` triples of 1-D arrays, keeping every op a contiguous 1-D
stream (see ops/vec3.py).
The array-shaped wrappers (`gltf_bsdf`, `gltf_wpdf`, `sample_gltf_brdf`)
keep the original (..., 3) signatures for tests and tools.

Material parameter struct mirrors GLTFMaterial (gltf_bsdf.glsl:15-34); in
SoA usage ``base_color``/``transmission_color`` are Vec3, all other fields
plain arrays broadcastable over the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from realtimepathtracingresearchframework_tpu.ops import vec3 as v3
from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3

M_1_PI = 1.0 / jnp.pi
MIN_ALPHA = 0.002


class GLTFMaterial(NamedTuple):
    base_color: object  # Vec3 (SoA core) or (...,3) array (wrappers)
    metallic: jnp.ndarray  # (...)
    specular: jnp.ndarray
    roughness: jnp.ndarray
    ior: jnp.ndarray
    specular_transmission: jnp.ndarray
    transmission_color: object  # like base_color
    onesided: jnp.ndarray  # bool
    transmission_roughness: object = None  # thin-transmission mode only
    # (GLTF_SUPPORT_TRANSMISSION_ROUGHNESS, gltf_bsdf.glsl:26-67): the
    # transmission lobe keeps the material roughness while the reflective
    # specular lobe takes sqrt(clearcoat_gloss); None = single roughness


def _mat_to_soa(mat: GLTFMaterial) -> GLTFMaterial:
    if isinstance(mat.base_color, Vec3):
        return mat
    # scalar fields become jnp arrays too: a raw np.ndarray scalar field
    # would hijack `ndarray * Vec3` via np's __mul__ (coercing the
    # NamedTuple to a (3, N) array) instead of deferring to Vec3.__rmul__
    return mat._replace(
        base_color=v3.from_array(jnp.asarray(mat.base_color)),
        transmission_color=v3.from_array(jnp.asarray(mat.transmission_color)),
        metallic=jnp.asarray(mat.metallic),
        specular=jnp.asarray(mat.specular),
        roughness=jnp.asarray(mat.roughness),
        ior=jnp.asarray(mat.ior),
        specular_transmission=jnp.asarray(mat.specular_transmission),
        onesided=jnp.asarray(mat.onesided),
        transmission_roughness=(
            None if mat.transmission_roughness is None
            else jnp.asarray(mat.transmission_roughness)
        ),
    )


def schlick_weight(c):
    x = jnp.clip(1.0 - c, 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x  # explicit multiplies: ** 5 can lower via exp/log


def gltf_schlick_weight(o_dot_h, ior):
    """Schlick with critical-angle fixup for ior < 1 (gltf_bsdf.glsl:288-292)."""
    f = schlick_weight(o_dot_h)
    cos_critical = jnp.sqrt(jnp.maximum(1.0 - ior * ior, 0.0))
    fix = jnp.minimum((1.0 - o_dot_h) / jnp.maximum(1.0 - cos_critical, 1e-9), 1.0)
    return jnp.where(ior < 1.0, f + (1.0 - f) * fix, f)


def gtr_2(cos_theta_h, alpha):
    a2 = alpha * alpha
    d = 1.0 + (a2 - 1.0) * cos_theta_h * cos_theta_h
    return M_1_PI * a2 / (d * d)


def smith_visibility_den1(n_dot_o, alpha_sq):
    return jnp.abs(n_dot_o) + jnp.sqrt(
        alpha_sq + (1.0 - alpha_sq) * n_dot_o * n_dot_o
    )


def smith_visibility_ggx(n_dot_o, n_dot_i, alpha_g):
    a = alpha_g * alpha_g
    return 1.0 / (smith_visibility_den1(n_dot_i, a) * smith_visibility_den1(n_dot_o, a))


def gtr_2_vndf_pdf(n_dot_o, cos_theta_h, alpha):
    return gtr_2(cos_theta_h, alpha) * (
        0.5 / smith_visibility_den1(n_dot_o, alpha * alpha)
    )


def to_pipe_sample_v(u0, u1) -> Vec3:
    phi = 2.0 * jnp.pi * u0
    return Vec3(jnp.cos(phi), jnp.sin(phi), u1)


def sample_sphere_v(up: Vec3) -> Vec3:
    cos_t = up.z * 2.0 - 1.0
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    return Vec3(sin_t * up.x, sin_t * up.y, cos_t)


def sample_gtr_2_vndf_v(w_o_local: Vec3, alpha, up: Vec3) -> Vec3:
    """Spherical-caps VNDF sampling (gltf_bsdf.glsl:233-256)."""
    wi_std = v3.normalize(
        Vec3(alpha * w_o_local.x, alpha * w_o_local.y, w_o_local.z), eps=0.0
    )
    z = (1.0 - up.z) * (1.0 + wi_std.z) - wi_std.z
    sin_t = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
    wm_std = Vec3(sin_t * up.x + wi_std.x, sin_t * up.y + wi_std.y, z + wi_std.z)
    wm = Vec3(wm_std.x * alpha, wm_std.y * alpha, jnp.maximum(wm_std.z, 0.0))
    return v3.normalize(wm)


def gltf_diffuse_basecolor(mat: GLTFMaterial):
    return (1.0 - mat.metallic) * mat.base_color


def gltf_specular_basecolor(mat: GLTFMaterial, ior):
    d = ((ior - 1.0) / (ior + 1.0)) ** 2
    return mat.base_color * mat.metallic + v3.splat(d * (1.0 - mat.metallic))


def gltf_specular_alpha(mat: GLTFMaterial):
    return jnp.maximum(mat.roughness * mat.roughness, MIN_ALPHA)


def gltf_transmission_alpha(mat: GLTFMaterial):
    """Thin-transmission GGX alpha (gltf_bsdf.glsl:279-282): falls back
    to the specular alpha on lanes without active transmission
    (gltf_bsdf.glsl:456-461)."""
    ta = jnp.maximum(
        mat.transmission_roughness * mat.transmission_roughness, MIN_ALPHA
    )
    return jnp.where(
        mat.specular_transmission > 0.0, ta, gltf_specular_alpha(mat)
    )


def cos_half_angle(cos_angle):
    return (1.0 + cos_angle) / jnp.sqrt(jnp.maximum(2.0 + 2.0 * cos_angle, 1e-12))


def _half_vector_v(mat, n: Vec3, w_o: Vec3, w_i: Vec3, i_dot_n, o_dot_n, ior,
                   enable_transmission=True):
    """w_h construction incl. transmission cases (gltf_bsdf.glsl:296-320).
    Returns (w_h, valid, transmit).

    ``enable_transmission=False`` is the scene-specialized fast path (no
    material has specular_transmission > 0): transmit lanes are invalid by
    definition and every transmission half-vector/compression term drops
    out of the program. Bit-identical to the general path for such scenes
    (the dropped terms are exactly zero there)."""
    transmit = i_dot_n * o_dot_n < 0.0
    w_h_refl = w_i + w_o
    if not enable_transmission:
        return v3.normalize(w_h_refl), ~transmit, transmit
    w_h_trans_onesided = -(ior * w_i) - w_o
    w_h_trans_twosided = v3.reflect(w_i, n) + w_o
    w_h_trans = v3.where(mat.onesided, w_h_trans_onesided, w_h_trans_twosided)
    w_h = v3.where(transmit, w_h_trans, w_h_refl)
    w_h = v3.normalize(w_h)
    valid = jnp.where(
        transmit,
        (mat.specular_transmission > 0.0) & (v3.dot(w_h, n) > 0.0),
        jnp.ones_like(transmit),
    )
    return w_h, valid, transmit


def gltf_bsdf_v(mat: GLTFMaterial, n: Vec3, w_o: Vec3, w_i: Vec3,
                enable_transmission=True, thin=False) -> Vec3:
    """Full BSDF value (gltf_bsdf.glsl:294-391). SoA core. ``thin``
    enables the separate transmission roughness
    (GLTF_SUPPORT_TRANSMISSION_ROUGHNESS, gltf_bsdf.glsl:329-334)."""
    i_dot_n = v3.dot(n, w_i)
    o_dot_n = v3.dot(n, w_o)
    ior = jnp.where(o_dot_n < 0.0, 1.0 / mat.ior, mat.ior)

    w_h, valid, transmit = _half_vector_v(
        mat, n, w_o, w_i, i_dot_n, o_dot_n, ior, enable_transmission
    )
    o_dot_h = v3.dot(w_o, w_h)
    i_dot_h = v3.dot(w_i, w_h)

    diffuse = gltf_diffuse_basecolor(mat) * M_1_PI

    f0 = gltf_specular_basecolor(mat, mat.ior)
    alpha = gltf_specular_alpha(mat)
    if thin:
        alpha = jnp.where(transmit, gltf_transmission_alpha(mat), alpha)
    spec_refl = gtr_2(v3.dot(n, w_h), alpha) * smith_visibility_ggx(
        o_dot_n, i_dot_n, alpha
    )
    f_weight = gltf_schlick_weight(jnp.abs(o_dot_h), ior)
    F = f0 + (1.0 - f0) * f_weight  # Vec3 + Vec3*scalar

    has_specular = mat.ior > 1.0
    zero = v3.splat(jnp.zeros_like(o_dot_n))

    if not enable_transmission:
        # transmission-free scene: (1 - specular_transmission) == 1 and
        # transmit lanes are already masked by ``valid``
        diffuse_refl = diffuse * (1.0 - F)
        refl_val = v3.where(has_specular, diffuse_refl + F * spec_refl, diffuse)
        return v3.where(valid, refl_val, zero)

    # reflection side
    diffuse_refl = diffuse * (1.0 - mat.specular_transmission) * (1.0 - F)
    spec_side_refl = F * spec_refl

    # transmission side
    compression = 2.0 * o_dot_h / (i_dot_h * ior + o_dot_h)
    comp2 = jnp.where(mat.onesided, compression * compression, 1.0)
    spec_side_trans = (
        mat.transmission_color * (1.0 - F)
    ) * (spec_refl * (1.0 - mat.metallic) * mat.specular_transmission * comp2)

    refl_val = v3.where(has_specular, diffuse_refl + spec_side_refl, diffuse)
    trans_val = v3.where(has_specular, spec_side_trans, zero)
    out = v3.where(transmit, trans_val, refl_val)
    return v3.where(valid, out, zero)


def _component_weights_v(mat, ior, odh, vis, enable_transmission=True):
    """Luminance-weighted component sampler (gltf_bsdf.glsl:369-395).
    odh/vis: triples of per-component (diffuse, specular, transmission)
    scalars. Returns normalized (w0, w1, w2)."""
    spec_lum = v3.luminance(gltf_specular_basecolor(mat, mat.ior))
    one = jnp.ones_like(ior)
    f0 = spec_lum + (1.0 - spec_lum) * gltf_schlick_weight(odh[0], one)
    f1 = spec_lum + (1.0 - spec_lum) * gltf_schlick_weight(odh[1], one)

    diff_lum = v3.luminance(gltf_diffuse_basecolor(mat))
    w0 = (1.0 - f0) * vis[0] * (1.0 - mat.metallic) * diff_lum
    if enable_transmission:
        w0 = w0 * (1.0 - mat.specular_transmission)
        f2 = spec_lum + (1.0 - spec_lum) * gltf_schlick_weight(odh[2], ior)
        w2 = (
            (1.0 - f2) * vis[2] * (1.0 - mat.metallic)
            * mat.specular_transmission
        )
    else:
        w2 = jnp.zeros_like(w0)
    w1 = f1 * vis[1]
    total = w0 + w1 + w2
    pos = total > 0.0
    inv = 1.0 / jnp.maximum(total, 1e-30)
    w0n = jnp.where(pos, w0 * inv, 1.0)
    w1n = jnp.where(pos, w1 * inv, 0.0)
    w2n = jnp.where(pos, w2 * inv, 0.0) if enable_transmission else w2
    return w0n, w1n, w2n


def gltf_wpdf_v(mat: GLTFMaterial, n: Vec3, w_o: Vec3, w_i: Vec3,
                enable_transmission=True, thin=False):
    """Approximate MIS weight-pdf (gltf_wpdf, gltf_bsdf.glsl:414-497)."""
    i_dot_n = v3.dot(n, w_i)
    o_dot_n = v3.dot(n, w_o)
    ior = jnp.where(o_dot_n < 0.0, 1.0 / mat.ior, mat.ior)

    diffuse_pdf = M_1_PI * jnp.abs(i_dot_n)

    w_h, valid, transmit = _half_vector_v(
        mat, n, w_o, w_i, i_dot_n, o_dot_n, ior, enable_transmission
    )
    o_dot_h = v3.dot(w_o, w_h)
    i_dot_h = v3.dot(w_i, w_h)
    cos_theta_h = v3.dot(w_h, n)

    alpha = gltf_specular_alpha(mat)
    vis_spec = 2.0 * jnp.abs(i_dot_n) / smith_visibility_den1(i_dot_n, alpha * alpha)
    if thin:
        # the transmission layer's visibility + pdf use its own alpha
        # (gltf_bsdf.glsl:455-473)
        talpha = gltf_transmission_alpha(mat)
        vis_trans = 2.0 * jnp.abs(i_dot_n) / smith_visibility_den1(
            i_dot_n, talpha * talpha
        )
    else:
        vis_trans = vis_spec
    aodh = jnp.abs(o_dot_h)
    w0, w1, w2 = _component_weights_v(
        mat, ior, (aodh, aodh, aodh),
        (jnp.ones_like(vis_spec), vis_spec, vis_trans),
        enable_transmission,
    )

    pdf_alpha = (
        jnp.where(transmit, talpha, alpha) if thin else alpha
    )
    specular = gtr_2_vndf_pdf(o_dot_n, cos_theta_h, pdf_alpha)
    pdf_refl = diffuse_pdf * w0 + specular * w1
    if enable_transmission:
        compression = 2.0 * o_dot_h / (i_dot_h * ior + o_dot_h)
        comp2 = jnp.where(mat.onesided, compression * compression, 1.0)
        pdf_trans = specular * comp2 * w2
        pdf = jnp.where(transmit, pdf_trans, pdf_refl)
    else:
        pdf = pdf_refl
    pdf = jnp.where(mat.ior > 1.0, pdf, diffuse_pdf)
    return jnp.where(valid, pdf, 0.0)


def sample_gltf_brdf_v(
    mat: GLTFMaterial, n: Vec3, w_o: Vec3, v_x: Vec3, v_y: Vec3,
    dir_sample, lobe_sample, enable_transmission=True, thin=False,
):
    """Sample the BSDF (sample_gltf_brdf, gltf_bsdf.glsl:500-652). SoA core.

    ``dir_sample``/``lobe_sample`` are (u0, u1) tuples of 1-D arrays.
    Returns (weight = f*|cos|/pdf Vec3, w_i Vec3, pdf, mis_wpdf).
    pdf==0 marks invalid samples.
    """
    # local frame
    w_o_local = Vec3(v3.dot(w_o, v_x), v3.dot(w_o, v_y), v3.dot(w_o, n))
    o_dot_n = w_o_local.z
    ior = jnp.where(o_dot_n < 0.0, 1.0 / mat.ior, mat.ior)
    # flip into upper hemisphere for sampling
    w_o_up = Vec3(w_o_local.x, w_o_local.y, jnp.abs(o_dot_n))

    up = to_pipe_sample_v(dir_sample[0], dir_sample[1])
    w_i_diffuse = v3.normalize(n + sample_sphere_v(up))
    w_i_diffuse = v3.where(o_dot_n < 0.0, -w_i_diffuse, w_i_diffuse)

    alpha = gltf_specular_alpha(mat)

    # candidate half vectors + visibilities for component weighting
    w_h_spec_local = sample_gtr_2_vndf_v(w_o_up, alpha, up)
    odh_diffuse = cos_half_angle(v3.dot(w_o, w_i_diffuse))
    odh_spec = v3.dot(w_o_up, w_h_spec_local)
    spec_i_dot_n = v3.reflect(-w_o_up, w_h_spec_local).z
    vis_spec = jnp.where(
        spec_i_dot_n > 0.0,
        2.0 * spec_i_dot_n / smith_visibility_den1(spec_i_dot_n, alpha * alpha),
        0.0,
    )
    if enable_transmission:
        if thin:
            # thin mode samples a SEPARATE transmission half vector with
            # the transmission alpha from the same 2-D sample
            # (gltf_bsdf.glsl:551-563)
            talpha = gltf_transmission_alpha(mat)
            w_h_trans_local = sample_gtr_2_vndf_v(w_o_up, talpha, up)
        else:
            talpha = alpha
            w_h_trans_local = w_h_spec_local
        refr, _tir = v3.refract(-w_o_up, w_h_trans_local, 1.0 / ior)
        trans_i_dot_n = jnp.where(
            mat.onesided, -refr.z,
            v3.reflect(-w_o_up, w_h_trans_local).z if thin else spec_i_dot_n,
        )
        vis_trans = jnp.where(
            (trans_i_dot_n > 0.0) & (mat.specular_transmission > 0.0),
            2.0 * trans_i_dot_n
            / smith_visibility_den1(trans_i_dot_n, talpha * talpha),
            0.0,
        )
        odh_trans = (
            v3.dot(w_o_up, w_h_trans_local) if thin else odh_spec
        )
    else:
        vis_trans = jnp.zeros_like(vis_spec)
        odh_trans = odh_spec

    w0, w1, w2 = _component_weights_v(
        mat, ior, (odh_diffuse, odh_spec, odh_trans),
        (jnp.ones_like(vis_spec), vis_spec, vis_trans),
        enable_transmission,
    )
    # materials without a specular layer (ior <= 1) always take diffuse
    has_spec_layer = mat.ior > 1.0
    w0 = jnp.where(has_spec_layer, w0, 1.0)
    w1 = jnp.where(has_spec_layer, w1, 0.0)
    w2 = jnp.where(has_spec_layer, w2, 0.0)

    # CDF component selection (sample reuse not needed: dims are per-use)
    cdf1 = w0
    cdf2 = w0 + w1
    r = lobe_sample[0]
    # NOTE: the 3-way select stays even when transmission is disabled:
    # float rounding can leave w0n + w1n just below 1.0, and the reference
    # behavior for an r landing in that gap is "component 2 with zero
    # weight" -> invalid sample (path terminates). Collapsing to a 2-way
    # select would silently re-route those rare lanes to specular.
    component = jnp.where(r < cdf1, 0, jnp.where(r < cdf2, 1, 2))
    # guard: component must have nonzero weight (arithmetic select
    # instead of a take_along_axis gather)
    wsel = jnp.where(component == 0, w0, jnp.where(component == 1, w1, w2))

    # build w_i per component (thin: transmission lanes use their own
    # half vector — gltf_bsdf.glsl:580-585)
    if enable_transmission and thin:
        w_h_pick_local = v3.where(
            component == 2, w_h_trans_local, w_h_spec_local
        )
    else:
        w_h_pick_local = w_h_spec_local
    w_h_local_signed = Vec3(
        w_h_pick_local.x,
        w_h_pick_local.y,
        w_h_pick_local.z * jnp.where(o_dot_n < 0.0, -1.0, 1.0),
    )
    cos_theta_h_spec = w_h_local_signed.z
    w_h_world = (
        w_h_local_signed.x * v_x
        + w_h_local_signed.y * v_y
        + w_h_local_signed.z * n
    )
    w_i_spec = v3.reflect(-w_o, w_h_world)
    is_diff = component == 0
    is_spec = component == 1
    if enable_transmission:
        refr_w, _ = v3.refract(-w_o, w_h_world, 1.0 / ior)
        w_i_trans = v3.where(mat.onesided, refr_w, v3.reflect(w_i_spec, n))
        w_i = v3.where(
            is_diff, w_i_diffuse, v3.where(is_spec, w_i_spec, w_i_trans)
        )
    else:
        w_i = v3.where(is_diff, w_i_diffuse, w_i_spec)

    i_dot_n = v3.dot(n, w_i)
    # sign consistency (gltf_bsdf.glsl:617-623)
    if enable_transmission:
        ok = jnp.where(
            component == 2, i_dot_n * o_dot_n < 0.0, i_dot_n * o_dot_n > 0.0
        )
    else:
        ok = i_dot_n * o_dot_n > 0.0
    ok = ok & (wsel > 0.0)

    # sampling pdf (gltf_bsdf.glsl:626-648)
    w_h_sel = v3.where(is_diff, v3.normalize(w_i + w_o), w_h_world)
    o_dot_h = v3.dot(w_o, w_h_sel)
    cos_theta_h = jnp.where(is_diff, v3.dot(n, w_h_sel), cos_theta_h_spec)

    diffuse_pdf = M_1_PI * jnp.abs(i_dot_n)
    pdf_alpha = (
        jnp.where(component == 2, talpha, alpha)
        if (enable_transmission and thin) else alpha
    )
    specular = gtr_2_vndf_pdf(o_dot_n, cos_theta_h, pdf_alpha)
    pdf_refl = diffuse_pdf * w0 + specular * w1
    if enable_transmission:
        i_dot_h = jnp.where(
            (component == 2) & mat.onesided, v3.dot(w_i, w_h_sel), o_dot_h
        )
        compression = 2.0 * o_dot_h / (i_dot_h * ior + o_dot_h)
        comp2 = jnp.where(mat.onesided, compression * compression, 1.0)
        pdf_trans = specular * comp2 * w2
        pdf = jnp.where(component == 2, pdf_trans, pdf_refl)
    else:
        pdf = pdf_refl
    pdf = jnp.where(mat.ior > 1.0, pdf, diffuse_pdf)
    pdf = jnp.where(ok & (pdf > 0.0), pdf, 0.0)

    f = gltf_bsdf_v(mat, n, w_o, w_i, enable_transmission, thin)
    mis_wpdf = gltf_wpdf_v(mat, n, w_o, w_i, enable_transmission, thin)
    good = pdf > 0.0
    weight = v3.where(
        good,
        f * (jnp.abs(i_dot_n) / jnp.maximum(pdf, 1e-30)),
        v3.splat(jnp.zeros_like(pdf)),
    )
    mis_wpdf = jnp.where(good, mis_wpdf, 0.0)
    return weight, w_i, pdf, mis_wpdf


# ---------------------------------------------------------------------------
# Array-shaped wrappers (original (..., 3) API, used by tests/tools)
# ---------------------------------------------------------------------------


def gltf_bsdf(mat: GLTFMaterial, n, w_o, w_i):
    """Full BSDF value over (..., 3) arrays."""
    out = gltf_bsdf_v(
        _mat_to_soa(mat), v3.from_array(n), v3.from_array(w_o), v3.from_array(w_i)
    )
    return v3.to_array(out)


def gltf_wpdf(mat: GLTFMaterial, n, w_o, w_i):
    """Approximate MIS weight-pdf over (..., 3) arrays."""
    return gltf_wpdf_v(
        _mat_to_soa(mat), v3.from_array(n), v3.from_array(w_o), v3.from_array(w_i)
    )


def sample_gltf_brdf(mat: GLTFMaterial, n, w_o, v_x, v_y, dir_sample, lobe_sample):
    """Sample the BSDF over (..., 3) arrays; samples are (..., 2)."""
    weight, w_i, pdf, mis = sample_gltf_brdf_v(
        _mat_to_soa(mat),
        v3.from_array(n),
        v3.from_array(w_o),
        v3.from_array(v_x),
        v3.from_array(v_y),
        (dir_sample[..., 0], dir_sample[..., 1]),
        (lobe_sample[..., 0], lobe_sample[..., 1]),
    )
    return v3.to_array(weight), v3.to_array(w_i), pdf, mis


def material_from_table(table, mid):
    """Gather a GLTFMaterial batch from a MaterialTable pytree of device
    arrays by material id (the unpack_material analogue)."""
    from realtimepathtracingresearchframework_tpu.models.material import (
        BASE_MATERIAL_ONESIDED,
    )

    return GLTFMaterial(
        base_color=table.base_color[mid],
        metallic=table.metallic[mid],
        specular=table.specular[mid],
        roughness=table.roughness[mid],
        ior=table.ior[mid],
        specular_transmission=table.specular_transmission[mid],
        transmission_color=table.base_color[mid],  # load_material: = base_color
        onesided=(table.flags[mid] & BASE_MATERIAL_ONESIDED) != 0,
    )
