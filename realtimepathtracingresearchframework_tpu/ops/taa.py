"""Temporal anti-aliasing resolve + temporal reprojection accumulation.

- :func:`taa_resolve` — the TAA compute pass (vulkan/processing/
  process_taa.comp): motion-vector dilation over a 3x3 neighborhood,
  Lanczos-windowed history reconstruction at the reprojected point,
  exponential blend (new-sample weight 0.15), variance-clamped history
  (neighborhood mean/stddev trim, :88-106).
- :func:`reproject_and_accumulate` — REPROJECTION_MODE_ACCUMULATE
  (rendering/postprocess/reprojection.{h,glsl}): history reprojected by the
  motion AOV and blended with a bounded accumulation window
  (process_samples.comp:105-110).

Dense, fixed-shape vector math over full (H,W) buffers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _bilinear_sample(img, uv):
    """img (H,W,C), uv (...,2) normalized; clamp addressing."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0c = jnp.clip(x0, 0, w - 1)
    x1c = jnp.clip(x0 + 1, 0, w - 1)
    y0c = jnp.clip(y0, 0, h - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)
    p00 = img[y0c, x0c]
    p10 = img[y0c, x1c]
    p01 = img[y1c, x0c]
    p11 = img[y1c, x1c]
    return (
        p00 * (1 - fx) * (1 - fy)
        + p10 * fx * (1 - fy)
        + p01 * (1 - fx) * fy
        + p11 * fx * fy
    )


def _lanczos_sample(img, uv, radius: int = 3):
    """Lanczos-windowed reconstruction (process_taa.comp:28-52); radius
    reduced from 5 to 3 (36 taps) — the window difference is visually
    negligible and keeps the tap count low."""
    h, w = img.shape[:2]
    dims = jnp.array([w, h], jnp.float32)
    point = uv * dims - 0.5
    cpoint = jnp.ceil(point)

    accum = jnp.zeros(uv.shape[:-1] + (img.shape[-1],), jnp.float32)
    total = jnp.zeros(uv.shape[:-1] + (1,), jnp.float32)
    for oy in range(-radius, radius):
        for ox in range(-radius, radius):
            npoint = cpoint + jnp.array([ox, oy], jnp.float32)
            d = npoint - point
            pix = jnp.pi * d
            wx = jnp.where(
                jnp.abs(d[..., 0]) < 1e-6,
                1.0,
                radius
                * jnp.sin(pix[..., 0])
                * jnp.sin(pix[..., 0] / radius)
                / jnp.maximum(pix[..., 0] * pix[..., 0], 1e-12),
            )
            wy = jnp.where(
                jnp.abs(d[..., 1]) < 1e-6,
                1.0,
                radius
                * jnp.sin(pix[..., 1])
                * jnp.sin(pix[..., 1] / radius)
                / jnp.maximum(pix[..., 1] * pix[..., 1], 1e-12),
            )
            weight = (wx * wy)[..., None]
            xi = jnp.clip(npoint[..., 0].astype(jnp.int32), 0, w - 1)
            yi = jnp.clip(npoint[..., 1].astype(jnp.int32), 0, h - 1)
            accum = accum + weight * img[yi, xi]
            total = total + weight
    return accum / jnp.maximum(total, 1e-8)


def _shift_clamped(img, oy, ox):
    """Edge-clamped 2D shift (image reads clamp at borders, not wrap)."""
    padded = jnp.pad(img, ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2), mode="edge")
    h, w = img.shape[:2]
    return padded[1 + oy : 1 + oy + h, 1 + ox : 1 + ox + w]


def _neighborhood_stats(img):
    """3x3 mean and stddev via shifted adds (no gathers)."""
    s = jnp.zeros_like(img)
    s2 = jnp.zeros_like(img)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            v = _shift_clamped(img, oy, ox)
            s = s + v
            s2 = s2 + v * v
    mean = s / 9.0
    rms = jnp.sqrt(s2 / 9.0)
    stddev = 9.0 / 8.0 * (rms - mean)
    return mean, stddev


@partial(jax.jit, static_argnames=())
def taa_resolve(framebuffer, history, motion, new_sample_weight=0.15):
    """framebuffer/history (H,W,4), motion (H,W,2) NDC delta.

    Returns the anti-aliased framebuffer (becomes next frame's history).
    """
    h, w = framebuffer.shape[:2]
    dims = jnp.array([w, h], jnp.float32)

    # motion dilation: strongest motion in the 3x3 neighborhood
    m_len = jnp.sum(motion * motion, axis=-1)
    best = motion
    best_len = m_len
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            m = _shift_clamped(motion, oy, ox)
            ml = jnp.sum(m * m, axis=-1)
            take = ml > best_len
            best = jnp.where(take[..., None], m, best)
            best_len = jnp.where(take, ml, best_len)

    px = jnp.arange(w)[None, :].repeat(h, axis=0).astype(jnp.float32)
    py = jnp.arange(h)[:, None].repeat(w, axis=1).astype(jnp.float32)
    start = jnp.stack([(px + 0.5) / w, (py + 0.5) / h], axis=-1)
    recon = start + 0.5 * best

    in_bounds = (
        (recon[..., 0] >= 0.0)
        & (recon[..., 1] >= 0.0)
        & (recon[..., 0] <= 1.0)
        & (recon[..., 1] <= 1.0)
    )
    history_color = _lanczos_sample(history, recon)

    mean, stddev = _neighborhood_stats(framebuffer)
    trim_low = jnp.maximum(0.0, mean - stddev)
    trim_high = jnp.maximum(mean + 3.0 * stddev, framebuffer + stddev)

    blended = history_color + (framebuffer - history_color) * new_sample_weight
    blended = jnp.clip(blended, trim_low, trim_high)
    return jnp.where(in_bounds[..., None], blended, framebuffer)


@jax.jit
def reproject_and_accumulate(
    accum, history, motion, depth, history_depth,
    spp_window, sample_base_index, batch_size,
):
    """REPROJECTION_MODE_ACCUMULATE (postprocess/reprojection.glsl):
    reproject linear history by the motion AOV, reject on depth
    disocclusion, blend with a bounded window
    min(sample_base, window)/(min(...)+batch) like the realtime resolve.

    accum/history (H,W,4); motion (H,W,2); depth/history_depth (H,W).
    """
    h, w = accum.shape[:2]
    px = jnp.arange(w)[None, :].repeat(h, axis=0).astype(jnp.float32)
    py = jnp.arange(h)[:, None].repeat(w, axis=1).astype(jnp.float32)
    start = jnp.stack([(px + 0.5) / w, (py + 0.5) / h], axis=-1)
    recon = start + 0.5 * motion

    hist = _bilinear_sample(history, recon)
    hist_d = _bilinear_sample(history_depth[..., None], recon)[..., 0]

    in_bounds = (
        (recon[..., 0] >= 0.0)
        & (recon[..., 1] >= 0.0)
        & (recon[..., 0] <= 1.0)
        & (recon[..., 1] <= 1.0)
    )
    depth_ok = jnp.abs(hist_d - depth) <= 0.1 * jnp.maximum(
        jnp.abs(depth), 1e-3
    )
    valid = in_bounds & depth_ok

    n_prev = jnp.minimum(
        sample_base_index.astype(jnp.float32), spp_window.astype(jnp.float32)
    )
    alpha = batch_size.astype(jnp.float32) / jnp.maximum(
        n_prev + batch_size.astype(jnp.float32), 1.0
    )
    blended = hist + (accum - hist) * alpha
    return jnp.where(valid[..., None], blended, accum)
