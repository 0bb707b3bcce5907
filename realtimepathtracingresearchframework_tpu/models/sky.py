"""Analytic sun + sky light.

The reference's Hosek-Wilkie sky
(rendering/lights/sky_model_arhosek/, wired in vulkan/render_sky.cpp:25-72
and evaluated per-miss in vulkan/pt_megakernel.glsl:113-149):

- host precompute -> coefficient struct (`SkyParams`): Hosek RGB configs
  + radiances cooked in models/sky_hosek.py (bit-exact vs the reference
  C, see tests/test_sky_hosek.py) and the spectral solar-disc radiance
  integration of render_sky.cpp:41-66,
- jittable `sky_radiance(params, dir)` for miss shading — the
  sky_model.glsl evaluation, preserved quirks included,
- sun disk: constant radiance inside cos(0.53 deg / 2) cap
  (render_sky.cpp:33), NEE selection weight ``sun_radiance.w`` = 1 with no
  area lights else 0.5 (render_sky.cpp:67-71),
- downward rays mirrored with the reference's "ocean" attenuation
  0.7*(1-|y|)^5 (pt_megakernel.glsl:118-122).

The Preetham (Perez) model is kept as the ``model="preetham"`` option
(and as the fallback when the Hosek data file is absent).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

SUN_APPARENT_ANGLE_DEG = 0.53


class SkyParams(NamedTuple):
    """Device-side sky/sun parameters (pytree)."""

    perez: jnp.ndarray  # (3,5) A..E for Y, x, y
    zenith: jnp.ndarray  # (3,) Yz, xz, yz
    sun_dir: jnp.ndarray  # (3,)
    sun_cos_angle: jnp.ndarray  # ()
    sun_radiance: jnp.ndarray  # (4,): rgb + NEE selection weight
    scale: jnp.ndarray  # () overall radiance scale
    # equirect radiance map baked at build time: per-miss analytic Perez
    # evaluation costs ~15 transcendentals/ray; a (H, W, 3) table lookup is
    # 4 gathers. 256x128 keeps banding below the quantization of 8-bit
    # displays for typical turbidities.
    sky_img: jnp.ndarray = jnp.zeros((1, 1, 3), jnp.float32)
    # Hosek-Wilkie RGB state (SkyModelParams, gpu_params.glsl): configs[i]
    # is a per-channel vec3; shape (9, 3) selects the Hosek evaluation
    # statically, (1, 3) means Preetham
    hosek_configs: jnp.ndarray = jnp.zeros((1, 3), jnp.float32)
    hosek_radiances: jnp.ndarray = jnp.zeros((3,), jnp.float32)


def _perez_coeffs(t: float) -> np.ndarray:
    """Preetham Perez coefficients for (Y, x, y) as functions of turbidity."""
    return np.array(
        [
            [0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
             0.1206 * t - 2.5771, -0.0670 * t + 0.3703],
            [-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
             -0.0641 * t - 0.8989, -0.0033 * t + 0.0452],
            [-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
             -0.0441 * t - 1.6537, -0.0109 * t + 0.0529],
        ],
        np.float64,
    )


def _zenith_values(t: float, theta_s: float) -> np.ndarray:
    """Zenith luminance (kcd/m^2) and chromaticity for turbidity t and sun
    zenith angle theta_s (radians)."""
    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192
    yz = max(yz, 1e-4)

    t2, ts = t * t, theta_s
    vec = np.array([ts**3, ts**2, ts, 1.0])
    xz = (
        np.array([0.00166, -0.00375, 0.00209, 0.0]) @ vec * t2
        + np.array([-0.02903, 0.06377, -0.03202, 0.00394]) @ vec * t
        + np.array([0.11693, -0.21196, 0.06052, 0.25886]) @ vec
    )
    yz_c = (
        np.array([0.00275, -0.00610, 0.00317, 0.0]) @ vec * t2
        + np.array([-0.04214, 0.08970, -0.04153, 0.00516]) @ vec * t
        + np.array([0.15346, -0.26756, 0.06670, 0.26688]) @ vec
    )
    return np.array([yz, xz, yz_c], np.float64)


_XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float64,
)


def _sun_radiance_rgb(sun_y: float, turbidity: float) -> np.ndarray:
    """Approximate clear-sky solar disk radiance (linear sRGB).

    Stands in for the spectral Hosek solar radiance integration
    (render_sky.cpp:41-66): direct-beam transmittance via a simple
    Bird-style optical mass model, warmed toward the horizon.
    """
    if sun_y <= 0.0:
        return np.zeros(3)
    cos_z = sun_y
    m = 1.0 / (cos_z + 0.15 * (93.885 - np.degrees(np.arccos(cos_z))) ** -1.253)
    beta = 0.04608 * turbidity - 0.04586
    # per-channel extinction (rayleigh + aerosol), representative wavelengths
    lam = np.array([0.62, 0.55, 0.46])
    tau_r = np.exp(-m * 0.008735 * lam**-4.08)
    tau_a = np.exp(-m * beta * lam**-1.3)
    # disk solid angle ~ 6.8e-5 sr; normalize so overhead sun has radiance
    # ~1e4 against a sky of ~O(1) after the global scale.
    base = 1.5e4
    return base * tau_r * tau_a


def build_sky(
    sun_dir, turbidity: float = 3.0, albedo=(0.2, 0.2, 0.2), has_area_lights: bool = False,
    scale: float = 0.025, model: str = "hosek",
) -> SkyParams:
    """Host precompute (the update_sky_light analogue, render_sky.cpp:25-72).

    ``model``: "hosek" (reference parity, default) or "preetham"."""
    if model == "hosek":
        from realtimepathtracingresearchframework_tpu.models import sky_hosek

        if sky_hosek.hosek_data_available():
            return _build_sky_hosek(
                sun_dir, turbidity, albedo, has_area_lights, sky_hosek
            )
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    theta_s = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))

    perez = _perez_coeffs(float(turbidity))
    zenith = _zenith_values(float(turbidity), float(min(theta_s, np.pi / 2 - 1e-3)))

    sun_rgb = _sun_radiance_rgb(float(sun_dir[1]), float(turbidity))
    if sun_dir[1] > 0.0 and np.all(sun_rgb >= 0.0):
        w = 0.5 if has_area_lights else 1.0
        sun_radiance = np.array([*(scale * sun_rgb), w], np.float64)
    else:
        sun_radiance = np.zeros(4)
        if not has_area_lights:
            sun_radiance[3] = 1.0

    params = SkyParams(
        perez=jnp.asarray(perez, jnp.float32),
        zenith=jnp.asarray(zenith, jnp.float32),
        sun_dir=jnp.asarray(sun_dir, jnp.float32),
        sun_cos_angle=jnp.float32(np.cos(np.radians(SUN_APPARENT_ANGLE_DEG) / 2.0)),
        sun_radiance=jnp.asarray(sun_radiance, jnp.float32),
        scale=jnp.float32(scale),
    )
    # the analytic Perez evaluation (~15 transcendentals) replaces 4
    # table gathers, so the baked map is opt-in (bake_sky_image) and the
    # default stays analytic
    return params


def _build_sky_hosek(sun_dir, turbidity, albedo, has_area_lights, sky_hosek) -> SkyParams:
    """update_sky_light with the real Hosek-Wilkie model
    (render_sky.cpp:25-72): RGB config/radiance cook with
    elevation=sun_dir.y (the reference passes the cosine where the model
    expects an angle — preserved), albedo averaged, spectral solar disc
    integration for sun_radiance."""
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    alb = float(np.dot(np.asarray(albedo, np.float64), np.full(3, 1.0 / 3.0)))
    configs, radiances = sky_hosek.rgb_state(
        float(turbidity), alb, float(sun_dir[1])
    )
    sun_rgb = sky_hosek.sun_disc_radiance_rgb(
        float(sun_dir[1]), float(turbidity), alb
    )
    if sun_rgb is not None:
        w = 0.5 if has_area_lights else 1.0
        sun_radiance = np.array([*sun_rgb, w], np.float64)
    else:
        sun_radiance = np.zeros(4)
        if not has_area_lights:
            sun_radiance[3] = 1.0
    return SkyParams(
        perez=jnp.zeros((3, 5), jnp.float32),
        zenith=jnp.zeros((3,), jnp.float32),
        sun_dir=jnp.asarray(sun_dir, jnp.float32),
        sun_cos_angle=jnp.float32(
            np.cos(np.radians(SUN_APPARENT_ANGLE_DEG) / 2.0)
        ),
        sun_radiance=jnp.asarray(sun_radiance, jnp.float32),
        scale=jnp.float32(1.0),
        hosek_configs=jnp.asarray(configs.T, jnp.float32),  # (9, 3)
        hosek_radiances=jnp.asarray(radiances, jnp.float32),
    )


def bake_sky_image(params: SkyParams, height: int = 128) -> jnp.ndarray:
    """Bake the analytic model into an equirect (H, 2H, 3) radiance map
    (upper hemisphere only; lookups fold downward dirs like the analytic
    path)."""
    width = 2 * height
    v = (np.arange(height) + 0.5) / height  # theta in [0, pi/2] (y >= 0)
    u = (np.arange(width) + 0.5) / width  # phi in [0, 2pi)
    theta = v * (np.pi / 2.0)
    phi = u * (2.0 * np.pi)
    st = np.sin(theta)[:, None]
    d = np.stack(
        [
            st * np.cos(phi)[None, :],
            np.broadcast_to(np.cos(theta)[:, None], (height, width)),
            st * np.sin(phi)[None, :],
        ],
        axis=-1,
    ).astype(np.float32)
    rgb = _sky_radiance_analytic(params, jnp.asarray(d.reshape(-1, 3)))
    return rgb.reshape(height, width, 3)


def _perez(coeffs, cos_theta, gamma, cos_gamma):
    a, b, c, d, e = (coeffs[..., i] for i in range(5))
    return (1.0 + a * jnp.exp(b / jnp.maximum(cos_theta, 0.01))) * (
        1.0 + c * jnp.exp(d * gamma) + e * cos_gamma * cos_gamma
    )


def _hosek_channel(params: SkyParams, ch: int, cos_theta, gamma, cos_gamma):
    """skymodel_radiance for one sRGB channel (sky_model.glsl:40-61),
    including its ``gamma = acos(cosTheta)`` in the exp term."""
    c = [params.hosek_configs[i, ch] for i in range(9)]
    exp_m = jnp.exp(c[4] * gamma)
    ray_m = cos_gamma * cos_gamma
    mie_m = (1.0 + cos_gamma * cos_gamma) / jnp.power(
        jnp.maximum(1.0 + c[8] * c[8] - 2.0 * c[8] * cos_gamma, 1e-12), 1.5
    )
    zenith = jnp.sqrt(cos_theta)
    coeffs = (1.0 + c[0] * jnp.exp(c[1] / (cos_theta + 0.01))) * (
        c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m + c[7] * zenith
    )
    return coeffs * params.hosek_radiances[ch] * 0.01


def _is_hosek(params: SkyParams) -> bool:
    return params.hosek_configs.shape[0] == 9


def _sky_radiance_analytic(params: SkyParams, d):
    """Atmosphere radiance for direction(s) d (..., 3), linear sRGB.

    Downward directions are mirrored with the ocean attenuation
    (pt_megakernel.glsl:118-122). Does NOT include the sun disk.
    """
    if _is_hosek(params):
        from realtimepathtracingresearchframework_tpu.ops import vec3 as v3

        rgb = _sky_radiance_analytic_v(params, v3.from_array(d))
        return v3.to_array(rgb)
    y = d[..., 1]
    ocean = jnp.where(
        y <= 0.0, 0.7 * jnp.maximum(1.0 - jnp.abs(y), 0.0) ** 5, 1.0
    )
    dm = jnp.stack([d[..., 0], jnp.abs(y), d[..., 2]], axis=-1)
    dm = dm / jnp.linalg.norm(dm, axis=-1, keepdims=True)

    cos_theta = jnp.clip(dm[..., 1], 0.0, 1.0)
    cos_gamma = jnp.clip(jnp.sum(dm * params.sun_dir, axis=-1), -1.0, 1.0)
    gamma = jnp.arccos(cos_gamma)
    theta_s = jnp.arccos(jnp.clip(params.sun_dir[1], 0.0, 1.0))
    cos_theta_s = jnp.cos(theta_s)

    def ratio(i):
        f = _perez(params.perez[i], cos_theta, gamma, cos_gamma)
        f0 = _perez(params.perez[i], 1.0, theta_s, cos_theta_s)
        return params.zenith[i] * f / jnp.maximum(f0, 1e-9)

    lum = ratio(0)  # kcd/m^2
    x = ratio(1)
    yc = ratio(2)

    # xyY -> XYZ
    yc = jnp.maximum(yc, 1e-6)
    X = x / yc * lum
    Z = (1.0 - x - yc) / yc * lum
    xyz = jnp.stack([X, lum, Z], axis=-1)
    rgb = jnp.matmul(xyz, jnp.asarray(_XYZ_TO_SRGB, jnp.float32).T,
                     precision=jax.lax.Precision.HIGHEST)
    rgb = jnp.maximum(rgb, 0.0) * params.scale
    return rgb * ocean[..., None]


def sun_visible_radiance(params: SkyParams, d):
    """Sun disk contribution for direction(s) d: constant radiance inside the
    cap (pt_megakernel.glsl:125-128), with the ocean fold."""
    y = d[..., 1]
    ocean = jnp.where(
        y <= 0.0, 0.7 * jnp.maximum(1.0 - jnp.abs(y), 0.0) ** 5, 1.0
    )
    dm = jnp.stack([d[..., 0], jnp.abs(y), d[..., 2]], axis=-1)
    dm = dm / jnp.linalg.norm(dm, axis=-1, keepdims=True)
    in_cap = jnp.sum(dm * params.sun_dir, axis=-1) >= params.sun_cos_angle
    return jnp.where(
        in_cap[..., None], params.sun_radiance[:3] * ocean[..., None], 0.0
    )


def _sky_radiance_analytic_v(params: SkyParams, d):
    """SoA analytic sky: ``d`` is a vec3.Vec3; returns Vec3. Same math as
    _sky_radiance_analytic with the xyY->XYZ->sRGB matrix written out as
    scalar dot products (SoA, see ops/vec3.py)."""
    from realtimepathtracingresearchframework_tpu.ops.vec3 import Vec3

    y = d.y
    ocean = jnp.where(y <= 0.0, 0.7 * jnp.maximum(1.0 - jnp.abs(y), 0.0) ** 5, 1.0)
    ay = jnp.abs(y)
    inv = 1.0 / jnp.sqrt(jnp.maximum(d.x * d.x + ay * ay + d.z * d.z, 1e-40))
    mx, my, mz = d.x * inv, ay * inv, d.z * inv

    cos_theta = jnp.clip(my, 0.0, 1.0)
    sd = params.sun_dir
    cos_gamma = jnp.clip(mx * sd[0] + my * sd[1] + mz * sd[2], -1.0, 1.0)

    if _is_hosek(params):
        # sky_model.glsl:46-48: gamma = acos(cosTheta)
        h_gamma = jnp.arccos(cos_theta)
        r = _hosek_channel(params, 0, cos_theta, h_gamma, cos_gamma)
        g = _hosek_channel(params, 1, cos_theta, h_gamma, cos_gamma)
        b = _hosek_channel(params, 2, cos_theta, h_gamma, cos_gamma)
        s = params.scale * ocean
        return Vec3(r * s, g * s, b * s)

    gamma = jnp.arccos(cos_gamma)
    theta_s = jnp.arccos(jnp.clip(sd[1], 0.0, 1.0))
    cos_theta_s = jnp.cos(theta_s)

    def ratio(i):
        f = _perez(params.perez[i], cos_theta, gamma, cos_gamma)
        f0 = _perez(params.perez[i], 1.0, theta_s, cos_theta_s)
        return params.zenith[i] * f / jnp.maximum(f0, 1e-9)

    lum = ratio(0)  # kcd/m^2
    x = ratio(1)
    yc = jnp.maximum(ratio(2), 1e-6)

    # xyY -> XYZ -> sRGB, written per channel
    X = x / yc * lum
    Z = (1.0 - x - yc) / yc * lum
    m = _XYZ_TO_SRGB.astype(np.float32)
    s = params.scale * ocean
    r = jnp.maximum(float(m[0, 0]) * X + float(m[0, 1]) * lum + float(m[0, 2]) * Z, 0.0) * s
    g = jnp.maximum(float(m[1, 0]) * X + float(m[1, 1]) * lum + float(m[1, 2]) * Z, 0.0) * s
    b = jnp.maximum(float(m[2, 0]) * X + float(m[2, 1]) * lum + float(m[2, 2]) * Z, 0.0) * s
    return Vec3(r, g, b)


def sky_radiance_v(params: SkyParams, d):
    """SoA runtime sky lookup (Vec3 in/out). The baked-map path falls back
    to the array implementation (opt-in feature; 12 extra gathers)."""
    from realtimepathtracingresearchframework_tpu.ops import vec3 as v3

    if params.sky_img.shape[0] <= 1:
        return _sky_radiance_analytic_v(params, d)
    return v3.from_array(sky_radiance(params, v3.to_array(d)))


def sky_radiance(params: SkyParams, d):
    """Runtime sky lookup: samples the baked equirect map (4 gathers)
    when present, else evaluates the analytic model."""
    if params.sky_img.shape[0] <= 1:
        return _sky_radiance_analytic(params, d)
    h, w = params.sky_img.shape[:2]
    y = d[..., 1]
    ocean = jnp.where(y <= 0.0, 0.7 * jnp.maximum(1.0 - jnp.abs(y), 0.0) ** 5, 1.0)
    ay = jnp.abs(y)
    norm = jnp.sqrt(jnp.maximum(d[..., 0] ** 2 + ay**2 + d[..., 2] ** 2, 1e-20))
    theta = jnp.arccos(jnp.clip(ay / norm, 0.0, 1.0))
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    u = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi) * (1.0 / (2.0 * jnp.pi))
    v = theta * (2.0 / jnp.pi)
    x = u * w - 0.5
    yy = jnp.clip(v * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(yy).astype(jnp.int32)
    fx = (x - x0.astype(jnp.float32))[..., None]
    fy = (yy - y0.astype(jnp.float32))[..., None]
    x0w = jnp.remainder(x0, w)
    x1w = jnp.remainder(x0 + 1, w)
    y0c = jnp.clip(y0, 0, h - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)
    img = params.sky_img
    p00 = img[y0c, x0w]
    p10 = img[y0c, x1w]
    p01 = img[y1c, x0w]
    p11 = img[y1c, x1w]
    out = (
        p00 * (1 - fx) * (1 - fy)
        + p10 * fx * (1 - fy)
        + p01 * (1 - fx) * fy
        + p11 * fx * fy
    )
    return out * ocean[..., None]
