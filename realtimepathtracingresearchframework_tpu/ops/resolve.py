"""Sample processing / resolve kernel.

Port of ``vulkan/process_samples.comp`` (PROCESS_SAMPLES): progressive
history average ``history += (new - history) / (base + batch)``
(:116-131), exposure ``exp2`` (:141-143 path without post processing),
early tonemapping (:146-147), AOV channel select, sRGB encode (:181), and
integer upscale replication (:183-199). One jitted function; the history
double-buffering of the reference becomes functional in/out arrays.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from realtimepathtracingresearchframework_tpu.backend.params import (
    TONEMAP_MODE_FAST,
    TONEMAP_MODE_NEUTRAL,
)
from realtimepathtracingresearchframework_tpu.utils import color as color_mod


def accumulate_history(history, new_accum, sample_base_index, batch_size):
    """Progressive average (process_samples.comp:116-131; the reference
    reaches the same mean via per-sample layers with global indices).

    ``new_accum`` is the MEAN of this batch's ``batch_size`` samples
    (render_tile_host blends with base 0), so the exact running mean is
    ``history + (mean - history) * batch / (base + batch)`` — a 1/n
    weight here would under-count every multi-sample batch by a factor
    of batch_size. history/new_accum: (H,W,4); base==0 resets.
    """
    n = (sample_base_index + batch_size).astype(jnp.float32)
    w = batch_size.astype(jnp.float32) / jnp.maximum(n, 1.0)
    blended = history + (new_accum - history) * w
    return jnp.where(sample_base_index > 0, blended, new_accum)


def resolve_channels(channels, exposure, tonemap_mode: int = -1):
    """Channel-separate resolve: ``channels`` = (r, g, b, a) 1-D linear
    accumulation buffers -> (r, g, b, a) sRGB display buffers. Same math
    as resolve_framebuffer minus the upscale (the host blit replicates
    pixels when upscaling). Channels stay separate 1-D arrays (the
    planar layout of the accumulators); the host readback
    interleaves, like the reference's swapchain blit
    (vulkan/vkdisplay.cpp display_native)."""
    scale = jnp.exp2(exposure)
    r, g, b = channels[0] * scale, channels[1] * scale, channels[2] * scale
    a = jnp.minimum(channels[3], 1.0)
    if tonemap_mode == TONEMAP_MODE_NEUTRAL:
        r, g, b = color_mod.neutral_tone_map_rgb(r, g, b)
    elif tonemap_mode == TONEMAP_MODE_FAST:
        r, g, b = color_mod.fast_tone_map_rgb(r, g, b)
    enc = color_mod.linear_to_srgb
    return (enc(r), enc(g), enc(b), a)


@partial(jax.jit, static_argnames=("tonemap_mode", "upscale"))
def resolve_framebuffer(
    accum,
    exposure,
    tonemap_mode: int = -1,
    upscale: int = 1,
):
    """accum (H,W,4) float -> display framebuffer (H*u, W*u, 4) float sRGB."""
    rgb = accum[..., :3]
    alpha = jnp.minimum(accum[..., 3:4], 1.0)

    rgb = rgb * jnp.exp2(exposure)
    if tonemap_mode == TONEMAP_MODE_NEUTRAL:
        rgb = color_mod.neutral_tone_map(rgb)
    elif tonemap_mode == TONEMAP_MODE_FAST:
        rgb = color_mod.fast_tone_map(rgb)
    rgb = color_mod.linear_to_srgb(jnp.maximum(rgb, 0.0))

    out = jnp.concatenate([rgb, alpha], axis=-1)
    if upscale > 1:
        out = jnp.repeat(jnp.repeat(out, upscale, axis=0), upscale, axis=1)
    return out
